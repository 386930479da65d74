"""The port's MoE block (``repro_torch.models.moe``) against the
reference's single-device path, on the CPU.

Same numpy inputs, the reference's weights (``init_moe`` drawn by both
packages from one key, bit for bit), at the granite-smoke spec (8
experts, top-4) and the llama4-smoke spec (top-1, shared expert):

  * the dispatched ``[E, C, D]`` tensor, captured at its ``dispatch``
    site, exactly equal: every token slot routed to the same expert at
    the same rank, and the same slots dropped past capacity — at the
    configs' capacity factor, at 0.5 (which drops), and dropless (decode);
  * the output within 1e-5 (f32: the expert products summed in another
    order), the sites' statistics exactly equal, under float32 and DFXP
    10 (whose grid the products' ulps do not reach at these sizes): DFXP
    at the configs' capacity and with drops, float32 at the configs'
    capacity and dropless;
  * the gradients of the input and every weight within 1e-5 of each
    leaf's largest value (a top-1 router's gradient is zero but for f32
    noise on both sides, its gates renormalised to 1: it is held to 1e-5
    of the largest gradient of any leaf);
  * two runs of the port give the same bits (the fixed-order combine).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_moe_ranks as R
from _torch_moe_ranks import PFX, SITES, _flat, _scales, _unflat
from repro import configs as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.tape import QTape as JTape
from repro.models import moe as JM
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.policy import PrecisionPolicy as TPolicy
from repro_torch.core.tape import QTape as TTape
from repro_torch.models import moe as TM

SPECS = ("granite_moe_1b", "llama4_maverick_400b")
B, S = 2, 24
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(arch, cf=None):
    j, t = jconfigs.get_smoke(arch).moe_spec, tconfigs.get_smoke(arch).moe_spec
    if cf is not None:
        j = dataclasses.replace(j, capacity_factor=cf)
        t = dataclasses.replace(t, capacity_factor=cf)
    return j, t


class _Capture:
    """Record the value entering each activation site of a tape."""

    def __init__(self, tape_cls):
        self.seen = {}
        seen = self.seen

        class Tape(tape_cls):
            def act(self, name, x):
                seen[name.split("/", 1)[1]] = x
                return super().act(name, x)

        self.Tape = Tape


def _run_reference(jspec, params, x, arith, dropless, monkeypatch):
    cap = _Capture(JTape)
    monkeypatch.setattr(JM, "QTape", cap.Tape)
    exps = {n: jnp.float32(-6.0) for n in _scales()}
    sinks = {f"g:{PFX}/{s}": jnp.zeros((3,)) for s in SITES}
    pol = JPolicy(arith)

    def f(p, xx):
        tape = cap.Tape(pol, exps, sinks)
        y = JM.moe_ffn(p, jspec, xx, tape, PFX, dropless=dropless)
        return jnp.sum(y * jnp.asarray(WEIGHT[:y.size].reshape(y.shape))), (
            y, tape.stats)

    (_, (y, stats)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(params, x)
    f(params, x)             # eager, to capture the dispatch tensor
    return y, stats, grads, {k: np.asarray(v) for k, v in cap.seen.items()}


WEIGHT = np.random.default_rng(9).standard_normal(1 << 16).astype(np.float32)


def _run_port(tspec, params, x, arith, dropless):
    cap = _Capture(TTape)
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in _flat(params).items()}
    xx = torch.from_numpy(np.array(x)).requires_grad_(True)
    exps = {n: torch.tensor(-6.0) for n in _scales()}
    tape = cap.Tape(TPolicy(arith), exps, {})
    y = TM.moe_ffn(_unflat(p), tspec, xx, tape, PFX, dropless=dropless)
    w = torch.from_numpy(WEIGHT[:y.numel()].reshape(y.shape))
    gx, *gp = torch.autograd.grad((y * w).sum(), [xx, *p.values()])
    grads = dict(zip(p, gp))
    return (y.detach(), {k: v.numpy() for k, v in tape.stats.items()}, gx,
            grads, {k: v.detach().numpy() for k, v in cap.seen.items()})


def _inputs(arch):
    jspec, _ = _specs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(2), jspec)
    x = np.random.default_rng(4).standard_normal(
        (B, S, jspec.d_model)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jp), x


@pytest.mark.parametrize("arch", SPECS)
def test_init_moe_matches_reference(arch):
    jspec, tspec = _specs(arch)
    want = _flat(JM.init_moe(jax.random.PRNGKey(2), jspec))
    got = _flat(TM.init_moe(prng.PRNGKey(2), tspec))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode,arith", [("capacity", "float32"),
                                        ("capacity", "dfxp"),
                                        ("drops", "dfxp"),
                                        ("dropless", "float32")])
@pytest.mark.parametrize("arch", SPECS)
def test_moe_ffn_matches_reference(arch, mode, arith, monkeypatch):
    jspec, tspec = _specs(arch, cf=0.5 if mode == "drops" else None)
    dropless = mode == "dropless"
    params, x = _inputs(arch)
    jy, jst, (jgp, jgx), jseen = _run_reference(
        jspec, params, jnp.asarray(x), arith, dropless, monkeypatch)
    ty, tst, tgx, tgp, tseen = _run_port(tspec, params, x, arith, dropless)

    # routing: the dispatched tensor, bit for bit
    C = TM.capacity(B * S, tspec, dropless)
    assert tseen["dispatch"].shape == (tspec.num_experts, C, tspec.d_model)
    np.testing.assert_array_equal(tseen["dispatch"], jseen["dispatch"])
    _, _, _, keep = TM.route(torch.from_numpy(x.reshape(B * S, -1)),
                             torch.from_numpy(np.array(params["router"])), tspec, C)
    kept = int(keep.sum())
    if mode == "drops":
        assert kept < B * S * tspec.top_k
    else:
        assert kept == B * S * tspec.top_k or mode == "capacity"
    # each kept slot lands on a row holding its token, the rest are zero
    assert int((np.abs(tseen["dispatch"]).sum(-1) > 0).sum()) == kept

    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_array_equal(tst[k], np.asarray(jst[k]), err_msg=k)
    top = float(np.abs(np.asarray(jgx)).max())
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5 * top)
    jgf = _flat(jgp)
    top_all = max(float(np.abs(g).max()) for g in jgf.values())
    for k, g in tgp.items():
        top = float(np.abs(jgf[k]).max())
        if k == "router" and tspec.top_k == 1:
            top = top_all     # mathematically zero: both sides' f32 noise
        np.testing.assert_allclose(g.numpy(), jgf[k], rtol=0,
                                   atol=1e-5 * top, err_msg=k)


def test_moe_ffn_is_deterministic():
    _, tspec = _specs("granite_moe_1b")
    params, x = _inputs("granite_moe_1b")
    runs = [_run_port(tspec, params, x, "dfxp", False) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][2], runs[1][2])
    for k in runs[0][3]:
        assert torch.equal(runs[0][3][k], runs[1][3][k]), k


@pytest.mark.parametrize("needs_grad", ["x", "w_up"])
def test_expert_parallelism_refuses_autograd(needs_grad):
    """The expert-parallel collectives other than the compressed
    ``all_to_all`` carry no gradient, so an active context under
    autograd raises instead of training with missing gradients."""
    from repro_torch.dist import serve_pod_ctx
    _, tspec = _specs("granite_moe_1b")
    params, x = _inputs("granite_moe_1b")
    p = _unflat({k: torch.from_numpy(np.array(v))
                 for k, v in _flat(params).items()})
    xt = torch.from_numpy(x)
    if needs_grad == "x":
        xt.requires_grad_(True)
    else:
        p["w_up"].requires_grad_(True)
    tape = TTape(TPolicy("float32"), {})
    with pytest.raises(NotImplementedError, match="no backward"):
        TM.moe_ffn(p, tspec, xt, tape, PFX, dist=serve_pod_ctx(tp=2))


@functools.lru_cache(maxsize=None)
def _ep_world():
    """One world of two ranks for both cases below (prefill, decode)."""
    from repro_torch.launch import mesh as M
    params, x = _inputs("granite_moe_1b")
    return M.spawn(R._ep_rank, 2, params, x, threads=1, timeout_s=120.0)


@pytest.mark.parametrize("dropless", [False, True], ids=["prefill", "decode"])
def test_expert_parallelism_raises(dropless):
    """Expert parallelism (ROADMAP item 22, ported): granite's MoE block
    in a world of two ranks under ``serve_pod_ctx(tp=2)`` — each rank
    runs its 20 of the 40 experts behind the ``all_to_all``s — matches
    the local block within 1e-5 of its largest output (the bound of
    ``tests/test_dist.py``), on every rank; the statistics are summed
    over the ranks, as the reference's ``psum`` over ``all_axes``: the
    weight sites' slices add up to the whole banks', the activation sites
    inside the island (dispatch, hidden, expert outputs) of the
    replicated tokens count twice, and the block's ``out`` site, outside
    it, once."""
    _, tspec = _specs("granite_moe_1b")
    params, x = _inputs("granite_moe_1b")
    p = {k: torch.from_numpy(np.array(v)) for k, v in _flat(params).items()}
    exps = {n: torch.tensor(-6.0) for n in _scales()}
    tape = TTape(TPolicy("dfxp"), exps, {})
    want = TM.moe_ffn(_unflat(p), tspec, torch.from_numpy(x), tape, PFX,
                      dropless=dropless).numpy()
    for ranks in _ep_world():
        y, stats = ranks[dropless]
        err = np.abs(y - want).max() / np.abs(want).max()
        assert err < 1e-5, err
        assert set(stats) == set(tape.stats)
        for k, v in tape.stats.items():
            island = k in (f"a:{PFX}/dispatch", f"a:{PFX}/pre",
                           f"a:{PFX}/expert_out")
            mult = 2 if island else 1
            np.testing.assert_array_equal(stats[k][..., 2],
                                          mult * v.numpy()[..., 2],
                                          err_msg=k)
