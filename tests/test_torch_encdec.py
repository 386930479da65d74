"""The encoder-decoder seamless-m4t-medium of the port against the
reference, on the CPU, at its smoke config (2 encoder and 3 decoder
layers of width 128, gelu FFNs, an untied head), with sources of 17
frames against targets of 32 tokens (``Sk != S``: a transposed
cross-attention shows).  The helpers here also serve
``test_torch_mrope.py`` (qwen2-vl-72b, the embeds-input model).

* ``init_params`` from one key equals the reference's bit for bit (the
  ``enc`` stage, each decoder layer's ``xattn`` block, ``enc_norm``);
  ``group_shapes`` and ``params_from_jax`` take the reference's trees.
* float32 forward and loss with their gradients: loss within 1e-5
  relative, every gradient leaf within 1e-5 of its largest value.
* One DFXP 10/12 SGD step, at the families' bands
  (``test_torch_families.py``): exponents exactly equal, the loss within
  2e-4 relative, ≥ 99.9% of the parameters equal.
* Whole-prompt ``prefill`` then teacher-forced ``decode_step`` under
  float32: logits within 1e-4; the prefill's cross-attention cache and
  ``enc_memory`` within 1e-5.  Under DFXP the prefill's statistics equal
  the reference's, including its quirk of computing ``wk``/``wv`` of the
  memory twice (once for the attention, once for the static cache), so
  those weight groups count twice.
* Chunked prefill refuses the cross-attention block, as the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import synthetic as jdata
from repro.models import transformer as JT
from repro.optim import opt as jopt
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as tconfigs
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from test_torch_families import _assert_grid_close, _flat, _tree_np

ARCH = "seamless_m4t_medium"
B, S, SK = 2, 32, 17
OPT = dict(kind="sgd", lr=0.01, lr_decay_steps=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    return jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)


@functools.lru_cache(maxsize=None)
def params(arch):
    jcfg, tcfg = cfgs(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


def image_span_positions(b: int, s: int, n0: int, gh: int, gw: int):
    """M-RoPE positions ``[3, b, s]``: ``n0`` text tokens on equal
    streams, a 1×gh×gw patch grid (temporal ``n0``, height ``n0 + row``,
    width ``n0 + col``), then text again on equal streams from
    ``n0 + max(gh, gw)``."""
    pos = np.zeros((3, s), np.int32)
    pos[:, :n0] = np.arange(n0)
    r, c = np.divmod(np.arange(gh * gw), gw)
    pos[0, n0:n0 + gh * gw] = n0
    pos[1, n0:n0 + gh * gw] = n0 + r
    pos[2, n0:n0 + gh * gw] = n0 + c
    rest = s - n0 - gh * gw
    pos[:, n0 + gh * gw:] = n0 + max(gh, gw) + np.arange(rest)
    return np.broadcast_to(pos[:, None], (3, b, s)).copy()


def batch_np(cfg, b=B, s=S, seed=0):
    """The training batch of either model: ``SyntheticLM``'s tokens and
    labels; an embeds model's ``embeds`` (× 0.1) with an image span's
    positions, an encoder-decoder's ``src_embeds`` of ``SK`` frames
    (× 0.1), both from numpy with ``seed``."""
    out = dict(jdata.SyntheticLM(cfg.vocab_size, s, b, seed=seed).batch(0))
    rng = np.random.default_rng(seed)
    if cfg.input_mode != "tokens":
        del out["tokens"]
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                         * 0.1).astype(np.float32)
        out["positions"] = image_span_positions(b, s, 6, 4, 4)
    if cfg.encoder_layers:
        out["src_embeds"] = (rng.standard_normal((b, SK, cfg.d_model))
                             * 0.1).astype(np.float32)
    return out


def to_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def exps(arch, e=-6.0):
    gs = JT.group_shapes(cfgs(arch)[0])
    return ({n: jnp.full(s, e) for n, s in gs.items()},
            {n: torch.full(s, e) for n, s in gs.items()})


def init_case(arch):
    jcfg, tcfg = cfgs(arch)
    jp = _flat(JT.init_params(jcfg, jax.random.PRNGKey(5)))
    tp = _flat(TT.init_params(tcfg, 5, device="cpu"))
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert TT.group_shapes(tcfg) == JT.group_shapes(jcfg)
    assert ("embed" in tp) == ("embed" in jp) == (jcfg.input_mode
                                                  == "tokens")
    # params_from_jax checks every leaf against the port's own shapes
    assert set(_flat(params(arch)[1])) == set(jp)


def float32_grads_case(arch):
    jcfg, tcfg = cfgs(arch)
    jp, tp = params(arch)
    jex, tex = exps(arch)
    b = batch_np(jcfg)
    jpol, tpol = JPolicy("float32"), TPolicy("float32")
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, jpol, p, to_j(b), jex, {}),
        has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _flat_t(tp).items()}
    tl, _ = TT.loss_fn(tcfg, tpol, _unflat(leaves), to_t(b), tex, {})
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jg = _flat(jg)
    assert set(jg) == set(tg)
    for k, want in jg.items():
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=k)


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_t(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _unflat(flat):
    out: dict = {}
    for k, v in flat.items():
        d = out
        *path, last = k.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def dfxp_step_case(arch):
    """One SGD step of both packages under DFXP 10/12 (controller
    interval 1: the step records and applies), as
    ``test_torch_families.train_step_case`` holds the families."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = params(arch)
    gs = JT.group_shapes(jcfg)
    kw = dict(arithmetic="dfxp", comp_width=10, update_width=12,
              update_interval=1)
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=-6.0)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=-6.0)
    before = {k: np.asarray(v) for k, v in jstate.scale.exps.items()}
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JT.loss_fn(jcfg, jpol, p, b, e, s), gs, jpol,
        jopt.OptConfig(**OPT)))
    tstep = t_make_step(lambda p, b, s, e: TT.loss_fn(tcfg, tpol, p, b, e, s),
                        gs, tpol, topt.OptConfig(**OPT))
    b = batch_np(jcfg)
    jstate, jm = jstep(jstate, to_j(b), jax.random.PRNGKey(0))
    tstate, tm = tstep(tstate, to_t(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    for k, v in jstate.scale.exps.items():
        np.testing.assert_array_equal(tstate.scale.exps[k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert any(not np.array_equal(np.asarray(v), before[k])
               for k, v in jstate.scale.exps.items())
    _assert_grid_close(_tree_np(tstate.params), _tree_np(jstate.params),
                       before, "p:", True)
    _assert_grid_close(_tree_np(tstate.opt["momentum"]),
                       _tree_np(jstate.opt["momentum"]), before, "pm:", True)


def decode_inputs(cfg, n, seed=3):
    """``n`` decode inputs: token ids [B], or embeds [B, 1, D] (× 0.1)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return [rng.integers(0, cfg.vocab_size, B).astype(np.int32)
                for _ in range(n)]
    return [(rng.standard_normal((B, 1, cfg.d_model)) * 0.1).astype(
        np.float32) for _ in range(n)]


def prefill_decode_case(arch, n_dec=4):
    """float32 prefill of the batch's prompt, then ``n_dec`` decode steps
    at positions after the prompt's last: logits within 1e-4; returns
    both caches."""
    jcfg, tcfg = cfgs(arch)
    jp, tp = params(arch)
    jex, tex = exps(arch)
    b = {k: v for k, v in batch_np(jcfg).items() if k != "labels"}
    jpol, tpol = JPolicy("float32"), TPolicy("float32")
    jl, _, jc = JT.prefill(jcfg, jpol, jp, to_j(b), jex, {},
                           max_cache_len=S + n_dec)
    tl, _, tc = TT.prefill(tcfg, tpol, tp, to_t(b), tex,
                           max_cache_len=S + n_dec)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for s, x in enumerate(decode_inputs(jcfg, n_dec)):
        # after the prompt's S ring slots (M-RoPE: all three streams at
        # S + s, as the reference's 2-D decode positions give)
        pos = np.full(B, S + s, np.int32)
        jl, _, jc = JT.decode_step(jcfg, jpol, jp, jc, jnp.asarray(x),
                                   jnp.asarray(pos), jex, {})
        tl, _, tc = TT.decode_step(tcfg, tpol, tp, tc, torch.from_numpy(x),
                                   torch.from_numpy(pos), tex)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4, err_msg=f"decode {s}")
    return jc, tc


def test_init_params_and_groups_match_reference():
    init_case(ARCH)
    jcfg, _ = cfgs(ARCH)
    names = [st.name for st in JT.build_stages(jcfg)]
    assert names == [st.name for st in TT.build_stages(cfgs(ARCH)[1])]
    assert names == ["enc", "dec"]


def test_float32_loss_and_gradients_match_reference():
    float32_grads_case(ARCH)


def test_dfxp_train_step_matches_reference():
    dfxp_step_case(ARCH)


def test_prefill_and_decode_match_reference():
    jc, tc = prefill_decode_case(ARCH)
    np.testing.assert_allclose(tc["enc_memory"].numpy(),
                               np.asarray(jc["enc_memory"]), rtol=0,
                               atol=1e-5)
    for name in ("k", "v"):
        want = np.asarray(jc["dec"]["1:xattn"][name])
        got = tc["dec"]["1:xattn"][name]
        assert got.shape == want.shape == (3, B, SK, 4, 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = JT.init_cache(cfgs(ARCH)[0], B, S, src_len=SK)
    got = TT.init_cache(cfgs(ARCH)[1], B, S, src_len=SK)
    assert jax.tree_util.tree_map(lambda a: a.shape, want) == {
        k: v for k, v in jax.tree_util.tree_map(
            lambda a: tuple(a.shape), got).items()}


def test_dfxp_prefill_statistics_match_reference():
    """Under DFXP the prefill's statistics are the reference's, exactly:
    the cross-attention's ``wk``/``wv`` weight groups record twice."""
    jcfg, tcfg = cfgs(ARCH)
    jp, tp = params(ARCH)
    jex, tex = exps(ARCH, -4.0)
    b = {k: v for k, v in batch_np(jcfg).items() if k != "labels"}
    _, jst, _ = JT.prefill(jcfg, JPolicy("dfxp"), jp, to_j(b), jex, {},
                           max_cache_len=S)
    _, tst, _ = TT.prefill(tcfg, TPolicy("dfxp"), tp, to_t(b), tex,
                           max_cache_len=S)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), k)
    n = tst["w:dec/1:xattn/wk"][..., 2]
    assert np.all(n.numpy() == 2 * 128 * 128)


def test_chunked_prefill_refuses_cross_attention():
    _, tcfg = cfgs(ARCH)
    _, tp = params(ARCH)
    _, tex = exps(ARCH)
    cache = TT.init_cache(tcfg, B, S, src_len=SK)
    with pytest.raises(ValueError, match="xattn"):
        TT.prefill_chunk_step(tcfg, TPolicy("float32"), tp, cache,
                              torch.zeros((B, 4), dtype=torch.int32),
                              torch.zeros(B, dtype=torch.int32),
                              torch.full((B,), 4, dtype=torch.int32), tex)
