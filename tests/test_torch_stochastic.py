"""What the port's PRNG unlocks, against the reference, on the CPU.

Same numpy inputs and the same threefry keys through ``repro`` (JAX on
the CPU) and ``repro_torch`` (torch on the CPU, plain kernel versions):

* stochastic ``fixed_round``, ``pack``, ``pack_rows`` and the train
  step's ``quantize_param``: bit for bit;
* ``maxout.init_params(cfg, PRNGKey(7))``: bit for bit;
* the DFXP train step with dropout on (the loss's ``rng=PRNGKey(1)``) and
  with ``stochastic_rounding=True``, one process for both packages so
  ``hash(name)`` agrees: at ``test_torch_train.py``'s tolerances;
* stochastic KV appends: slot-major and paged mantissas, exponents,
  statistics and key chains bit for bit;
* serving at smoke size over a stochastic int8 pool: temperature and
  top-k tokens equal the reference engine's, slot-major and paged; a
  request served alone draws what it draws batched; a paged stochastic
  pool shares no prefix pages;
* the precision sweep (``repro_torch.examples.precision_sweep``): a few
  rows at smoke size against the reference harness's recipe.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import packed as jpacked
from repro.core import quant as jquant
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.data import synthetic as jdata
from repro.models import maxout as JMX
from repro.models import transformer as JT
from repro.optim import opt as jopt
from repro.serve import EngineOptions as JOptions
from repro.serve import SamplerConfig as JSampler
from repro.serve import ServeEngine as JEngine
from repro.serve import kv_pool as jkv
from repro.serve import paged as jpaged
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train import step as jstep_mod
from repro.train.calibrate import calibrate as j_calibrate
from repro_torch import configs as tconfigs
from repro_torch.core import packed as tpacked
from repro_torch.core import prng
from repro_torch.core import quant as tquant
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.examples import precision_sweep as sweep
from repro_torch.models import maxout as TMX
from repro_torch.models.convert import maxout_params_from_jax, params_from_jax
from repro_torch.optim import opt as topt
from repro_torch.serve import EngineOptions as TOptions
from repro_torch.serve import RequestStatus
from repro_torch.serve import SamplerConfig as TSampler
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import kv_pool as tkv
from repro_torch.serve import paged as tpaged
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train import step as tstep_mod
from test_torch_prng import _ulps
from test_torch_train import (OPT, PI, _assert_states_match, _exps_np,
                              _jbatch, _loss_rtol, _tbatch, _tcfg)


def _t(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _values(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp2(rng.integers(-6, 6, shape))).astype(np.float32)


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 12])
def test_stochastic_fixed_round_and_pack_exact(width):
    x = _values(width, (37, 53))
    key = jax.random.PRNGKey(width)
    jy, (jo, joh) = jquant.fixed_round(jnp.asarray(x), width,
                                       jnp.float32(-4.0), stochastic=True,
                                       key=key)
    ty, (to, toh) = tquant.fixed_round(torch.from_numpy(x), width, -4.0,
                                       stochastic=True, key=_t(key))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    assert (float(jo), float(joh)) == (float(to), float(toh))
    assert not np.array_equal(ty.numpy(), tquant.fixed_round(
        torch.from_numpy(x), width, -4.0)[0].numpy())   # not to nearest
    with pytest.raises(ValueError, match="key"):
        tquant.fixed_round(torch.from_numpy(x), width, -4.0, stochastic=True)
    jp = jpacked.pack(jnp.asarray(x), width, jnp.float32(-3.0),
                      stochastic_key=key)
    tp = tpacked.pack(torch.from_numpy(x), width, -3.0,
                      stochastic_key=_t(key))
    np.testing.assert_array_equal(np.asarray(jp.mantissa), tp.mantissa.numpy())
    keys = jax.random.split(key, 37)
    e = np.arange(-5, -5 + 37, dtype=np.float32) % 7 - 6
    jm, js = jpacked.pack_rows(jnp.asarray(x), width, jnp.asarray(e),
                               stochastic_keys=keys)
    tm, ts = tpacked.pack_rows(torch.from_numpy(x), width,
                               torch.from_numpy(e), stochastic_keys=_t(keys))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


def test_stochastic_quantize_param_exact():
    x = _values(3, (4, 24, 10))
    key = jax.random.PRNGKey(3)
    for e in (np.float32(-6.0), np.array([-7, -6, -5, -8], np.float32)):
        jy, jst = jstep_mod.quantize_param(jnp.asarray(x), 10, jnp.asarray(e),
                                           stochastic_key=key)
        ty, tst = tstep_mod.quantize_param(torch.from_numpy(x), 10,
                                           torch.from_numpy(np.asarray(e)),
                                           stochastic_key=_t(key))
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
        np.testing.assert_array_equal(np.asarray(jst), tst.numpy())


# ---------------------------------------------------------------------------
# maxout: the reference's init, dropout, the stochastic train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, PI, dict(conv=True, conv_channels=(4, 6),
                                            image_shape=(1, 12, 12),
                                            input_dim=144, pieces=2)],
                         ids=["paper_pi", "small_pi", "conv"])
def test_init_params_match_reference(kw):
    jcfg = JMX.MaxoutConfig(**kw)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(7))
    tp = TMX.init_params(_tcfg(jcfg), 7, device="cpu")
    tp_key = TMX.init_params(_tcfg(jcfg), prng.PRNGKey(7), device="cpu")
    for layer in jp:
        for leaf in jp[layer]:
            j = np.asarray(jp[layer][leaf])
            t = tp[layer][leaf].numpy()
            assert t.shape == j.shape and t.dtype == j.dtype
            d = _ulps(j, t)
            i = int(np.argmax(d))
            assert d.max() == 0, (layer, leaf, int((d > 0).sum()), i,
                                  j.ravel()[i], t.ravel()[i])
            np.testing.assert_array_equal(t, tp_key[layer][leaf].numpy())


def test_maxout_dropout_matches_reference():
    """Input and hidden dropout masks from the reference's key splits: the
    training forward (the reference's compiled one) equal in its forward
    statistics and within ``rtol=1e-5`` in its logits."""
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(3))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    x = jdata.SyntheticImages().batch(0, 16)["x"]
    gs = JMX.group_shapes(jcfg)
    exps = {k: np.float32(-8.0 if k.startswith("a:") else -10.0) for k in gs}
    key = jax.random.PRNGKey(1)
    for arith in ("float32", "dfxp"):
        jl, js = jax.jit(lambda p, xx, e: JMX.forward(
            jcfg, JPolicy(arith), p, xx, e, {}, rng=key))(
            jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in exps.items()})
        tl, ts = TMX.forward(tcfg, TPolicy(arith), tp, torch.from_numpy(x),
                             {k: torch.tensor(v) for k, v in exps.items()},
                             {}, rng=_t(key))
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-6)
        for k in js:
            np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(),
                                          err_msg=k)
    nodrop, _ = TMX.forward(tcfg, TPolicy("float32"), tp, torch.from_numpy(x),
                            {}, {})
    assert not torch.allclose(nodrop, tl)


def _stochastic_setup(kw, seed=7):
    """Reference and port PI maxout from the reference's weights, their
    train steps with dropout on (``rng=PRNGKey(1)`` in the loss), DFXP
    calibrated by the reference with dropout on."""
    jpol, tpol = JPolicy(**kw), TPolicy(**kw)
    jcfg = JMX.MaxoutConfig(**PI)
    tcfg = _tcfg(jcfg)
    gs = JMX.group_shapes(jcfg)
    jp = JMX.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = maxout_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    jr, tr = jax.random.PRNGKey(1), prng.PRNGKey(1)
    init = -8.0
    if jpol.dynamic:
        jobs = dataclasses.replace(jpol, arithmetic="observe", storage="sim")
        data = jdata.SyntheticImages()
        init = _exps_np(j_calibrate(
            lambda p, b, s, e: JMX.loss_fn(jcfg, jobs, p, b, e, s, rng=jr),
            jp, gs, jpol, jopt.OptConfig(**OPT),
            (_jbatch(data.batch(100 + i, 32)) for i in range(3)), steps=3))
    jstate = j_init_state(jp, jopt.sgd_init(jp), gs, jpol, init_exp=init)
    tstate = t_init_state(tp, topt.sgd_init(tp), gs, tpol, init_exp=init)
    jstep = jax.jit(j_make_step(
        lambda p, b, s, e: JMX.loss_fn(jcfg, jpol, p, b, e, s, rng=jr), gs,
        jpol, jopt.OptConfig(**OPT)))
    tstep = t_make_step(
        lambda p, b, s, e: TMX.loss_fn(tcfg, tpol, p, b, e, s, rng=tr), gs,
        tpol, topt.OptConfig(**OPT))
    return jstate, tstate, jstep, tstep


STOCHASTIC = {
    "float32_dropout": dict(arithmetic="float32"),
    "dfxp_dropout": dict(arithmetic="dfxp", update_interval=2),
    "dfxp_stochastic": dict(arithmetic="dfxp", update_interval=2,
                            stochastic_rounding=True),
    "dfxp_stochastic_packed": dict(arithmetic="dfxp", update_interval=2,
                                   stochastic_rounding=True,
                                   storage="packed"),
    "fixed20_stochastic": dict(arithmetic="fixed", comp_width=20,
                               update_width=20, stochastic_rounding=True),
}


@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_dropout_and_stochastic_train_step_match_reference(name):
    """Two steps (the controller accumulates, then applies), step ``i``
    keyed ``PRNGKey(i)``, at ``test_torch_train.py``'s tolerances."""
    kw = STOCHASTIC[name]
    jstate, tstate, jstep, tstep = _stochastic_setup(kw)
    data = jdata.SyntheticImages()
    for i in range(2):
        b = data.batch(i, 32)
        before = _exps_np(jstate.scale.exps)
        jstate, jm = jstep(jstate, _jbatch(b), jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, _tbatch(b), prng.PRNGKey(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=_loss_rtol(kw))
        _assert_states_match(jstate, tstate, kw, before)
    if kw.get("stochastic_rounding"):
        with pytest.raises(ValueError, match="key"):
            tstep(tstate, _tbatch(data.batch(2, 32)))


# ---------------------------------------------------------------------------
# stochastic KV appends
# ---------------------------------------------------------------------------

B, W, K, HD = 3, 10, 2, 8


def _assert_equal(je, te, scratch_keys=()):
    assert set(je) == set(te)
    for name in je:
        t = te[name].numpy()
        if name in scratch_keys:
            t = t[:-1]
        np.testing.assert_array_equal(np.asarray(je[name]).astype(t.dtype), t,
                                      err_msg=name)


def _raw(rng, n_filled, n=2, g=B):
    k = rng.standard_normal((n, g, W, K, HD)).astype(np.float32)
    v = (0.5 * rng.standard_normal((n, g, W, K, HD))).astype(np.float32)
    pos = np.full((n, g, W), -1, np.int32)
    for b, m in enumerate(n_filled):
        pos[:, b, :m] = np.arange(m)
    return {"k": k, "v": v, "pos": pos}


def test_stochastic_slot_major_appends_exact():
    rng = np.random.default_rng(1)
    cfg = dict(width=8, update_interval=4, stochastic=True)
    jc = jkv.PackedKVCodec(jkv.CacheQuantConfig(**cfg))
    tc = tkv.PackedKVCodec(tkv.CacheQuantConfig(**cfg))
    raw = _raw(rng, [4, 6, 2])
    skeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(7), u)
                       for u in range(B)])
    je = jc.pack_entry({k: jnp.asarray(v) for k, v in raw.items()}, skeys)
    te = tc.pack_entry({k: torch.from_numpy(v) for k, v in raw.items()},
                       _t(skeys))
    _assert_equal(je, te)
    je = {k: v[1] for k, v in je.items()}        # layer 1, as in the scan
    te = {k: v[1] for k, v in te.items()}
    pos = np.array([4, 6, 2], np.int32)
    j_append = jax.jit(jc.append)
    for step in range(9):
        gain = 6.0 if step in (2, 3) else 1.0
        kn = (gain * rng.standard_normal((B, K, HD))).astype(np.float32)
        vn = rng.standard_normal((B, K, HD)).astype(np.float32)
        mask = None if step % 3 else np.array([True, step % 2 == 0, True])
        je = j_append(je, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
                      mask=None if mask is None else jnp.asarray(mask))
        te = tc.append(te, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos),
                       mask=None if mask is None else torch.from_numpy(mask))
        _assert_equal(je, te)
        pos = pos + (1 if mask is None else mask.astype(np.int32))
    C = 5
    kn = (3.0 * rng.standard_normal((B, C, K, HD))).astype(np.float32)
    p0 = np.array([int(pos[0]), 0, int(pos[2])], np.int32)   # slot 1 admits
    nv = np.array([5, 3, 2], np.int32)
    je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(kn),
                         jnp.asarray(p0), jnp.asarray(nv))
    te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(kn),
                         torch.from_numpy(p0), torch.from_numpy(nv))
    _assert_equal(je, te)
    # chunked admission seeds a slot's chains as pack_entry does
    jpool = {"dec": {"0:attn": jc.init_like(
        {k: jnp.asarray(v) for k, v in raw.items()})}}
    tpool = {"dec": {"0:attn": tc.init_like(
        {k: torch.from_numpy(v) for k, v in raw.items()})}}
    jpool = jkv.seed_slot_keys(jpool, 2, skeys[1])
    tkv.seed_slot_keys(tpool, 2, _t(skeys[1]))
    _assert_equal(jpool["dec"]["0:attn"], tpool["dec"]["0:attn"])
    one = jc.pack_entry({k: jnp.asarray(v[:, 1:2]) for k, v in raw.items()},
                        skeys[1:2])
    np.testing.assert_array_equal(np.asarray(one["key"][:, 0]),
                                  tpool["dec"]["0:attn"]["key"][:, 2].numpy())


def test_stochastic_paged_appends_exact():
    P, NBLK = 4, 5
    n_pages = 1 + B * NBLK
    rng = np.random.default_rng(2)
    cfg = dict(width=8, update_interval=4, stochastic=True)
    jc = jpaged.PagedKVCodec(P, jkv.CacheQuantConfig(**cfg))
    tc = tpaged.PagedKVCodec(P, tkv.CacheQuantConfig(**cfg))
    Wp = NBLK * P
    raw = {"k": np.zeros((1, B, Wp, K, HD), np.float32),
           "v": np.zeros((1, B, Wp, K, HD), np.float32),
           "pos": np.full((1, B, Wp), -1, np.int32)}
    je = jax.tree_util.tree_map(lambda a: a[0], jc.init_like(
        {k: jnp.asarray(v) for k, v in raw.items()}, n_pages))
    te = {k: v[0] for k, v in tc.init_like(
        {k: torch.from_numpy(v) for k, v in raw.items()}, n_pages).items()}
    bt = np.array([[7, 2, 11, 4, 13], [3, 9, 14, 5, 0], [12, 6, 1, 0, 0]],
                  np.int32)
    je["bt"], te["bt"] = jnp.asarray(bt), torch.from_numpy(bt)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    je["key"], te["key"] = keys, _t(keys)
    scratch = tpaged.PAGE_KEYS
    C = 6
    for p0, nv in (([0, 0, 0], [6, 4, 0]), ([6, 4, 0], [5, 3, 2])):
        kn = rng.standard_normal((B, C, K, HD)).astype(np.float32)
        vn = rng.standard_normal((B, C, K, HD)).astype(np.float32)
        args = (np.asarray(p0, np.int32), np.asarray(nv, np.int32))
        je = jc.append_chunk(je, jnp.asarray(kn), jnp.asarray(vn),
                             *map(jnp.asarray, args))
        te = tc.append_chunk(te, torch.from_numpy(kn), torch.from_numpy(vn),
                             *map(torch.from_numpy, args))
        _assert_equal(je, te, scratch)
    pos = np.array([11, 7, 2], np.int32)
    for step in range(7):
        kn = rng.standard_normal((B, K, HD)).astype(np.float32)
        vn = rng.standard_normal((B, K, HD)).astype(np.float32)
        mask = None if step % 3 else np.array([True, step % 2 == 0, True])
        je = jc.append(je, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos),
                       mask=None if mask is None else jnp.asarray(mask))
        te = tc.append(te, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos),
                       mask=None if mask is None else torch.from_numpy(mask))
        _assert_equal(je, te, scratch)
        pos = pos + (1 if mask is None else mask.astype(np.int32))


# ---------------------------------------------------------------------------
# sampled serving over a stochastic pool (smoke llama)
# ---------------------------------------------------------------------------

JCFG = jconfigs.get_smoke("llama3_8b")
TCFG = tconfigs.get_smoke("llama3_8b")
SAMPLERS = {"temperature": dict(kind="temperature", temperature=0.8),
            "top_k": dict(kind="top_k", temperature=0.8, top_k=8)}


@functools.lru_cache(maxsize=None)
def _params():
    jp = JT.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(TCFG, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jp, tp


def _prompts():
    rng = np.random.default_rng(4)
    shared = rng.integers(0, JCFG.vocab_size, 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, JCFG.vocab_size, n)
                            ]).astype(np.int32) for n in (3, 6, 9)]


def _engine(pkg, sampler, page, slots=3, chunk=8):
    pol_kw = dict(fused_decode=True, prefill_chunk=chunk,
                  page_size=8 if page else 0)
    ccfg = dict(width=8, stochastic=True)
    if pkg == "j":
        jp, _ = _params()
        return JEngine(JCFG, JPolicy("float32", **pol_kw), jp,
                       max_slots=slots, max_len=24, options=JOptions(
                           cache_bits=8, seed=5,
                           cache_cfg=jkv.CacheQuantConfig(**ccfg),
                           sampler_cfg=JSampler(**SAMPLERS[sampler])))
    _, tp = _params()
    return TEngine(TCFG, TPolicy("float32", **pol_kw), tp, max_slots=slots,
                   max_len=24, options=TOptions(
                       cache_bits=8, seed=5,
                       cache_cfg=tkv.CacheQuantConfig(**ccfg),
                       sampler_cfg=TSampler(**SAMPLERS[sampler])),
                   device="cpu")


def _serve(eng, prompts, max_new=5):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    out = eng.run()
    return [out[u].tolist() for u in uids]


@pytest.mark.parametrize("page", [False, True], ids=["slot_major", "paged"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sampled_tokens_over_a_stochastic_pool_match_reference(sampler, page):
    """float32 arithmetic, fused decode, chunked prefill (C = P = 8),
    stochastic int8 pool, engine seed 5."""
    prompts = _prompts()
    want = _serve(_engine("j", sampler, page), prompts)
    eng = _engine("t", sampler, page)
    got = _serve(eng, prompts)
    assert got == want
    assert all(s is RequestStatus.OK for s in eng.statuses.values())
    if page:
        assert eng.stats()["page_cache_hits"] == 0     # sharing is off


def test_whole_prompt_sampling_matches_reference():
    """Whole-prompt admission: the request keys seed the pool in
    ``insert`` and the first token is drawn at position L."""
    prompts = [p[:9] for p in _prompts()]
    want = _serve(_engine("j", "top_k", False, chunk=0), prompts)
    assert _serve(_engine("t", "top_k", False, chunk=0), prompts) == want


@pytest.mark.parametrize("page", [False, True], ids=["slot_major", "paged"])
def test_sampled_request_alone_equals_batched(page):
    prompts = _prompts()
    batched = _serve(_engine("t", "top_k", page), prompts)
    solo = _serve(_engine("t", "top_k", page, slots=1), prompts[:1])
    assert solo[0] == batched[0]            # uid 0 in both: one stream
    assert len({tuple(t) for t in batched}) > 1


def test_sampler_configs():
    with pytest.raises(ValueError):
        TSampler("top_k", top_k=0)
    with pytest.raises(ValueError):
        TSampler("beam")
    logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 0.0, -1.0]])
    assert TSampler().kind == "greedy"
    from repro_torch.serve import sampler as tsampler
    assert tsampler.sample(logits, None, TSampler()).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# the precision sweep (the paper's Figures 1-4)
# ---------------------------------------------------------------------------

def test_precision_sweep_rows_match_reference_at_smoke_size():
    """Float32 and two DFXP rows of the sweep, 10 steps each, against the
    reference harness (``benchmarks/_common.train_once``) on the same
    recipe: final losses within 1e-3 relative."""
    from benchmarks import _common as bench
    names = ["float32", "fig2/dfxp_comp_10", "fig3/dfxp_update_8"]
    out = sweep.main(["--device", "cpu", "--steps", "10",
                      "--rows", ",".join(names)])
    assert out["names"] == names and "full_width" not in out
    policies = dict(sweep.fig_rows())
    for name in names:
        kw = {f.name: getattr(policies[name], f.name)
              for f in dataclasses.fields(JPolicy)
              if hasattr(policies[name], f.name)}
        want, _, _ = bench.train_once(JPolicy(**kw), steps=10)
        rel = abs(out["rows"][name]["loss"] / want - 1)
        assert rel <= 1e-3, (name, rel)
