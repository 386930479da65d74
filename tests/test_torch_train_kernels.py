"""Parity of the port's training kernels' plain versions with the reference.

Same numpy inputs through ``repro`` (JAX on the CPU, its Pallas kernels in
interpret mode) and ``repro_torch`` (torch on the CPU, where each wrapper
computes its kernel's plain version):

  * K1 (``dfxp_quantize``): values and both overflow counts bit-exact over
    aligned and ragged shapes, f32/f16/bf16, exponents ±30, NaN and ±inf.
  * K2 (``qmm``): the rounded operands bit-exact; the products within
    ``rtol=1e-5``, ``atol=1e-5·sqrt(D)`` on unit-scale inputs — both sides
    accumulate in f32, in different orders.
  * ``fused_dot``/``tape_dot``: forward, dgrad and wgrad against
    ``jax.grad`` of the reference's fused path, with ``transpose_b`` and
    batched leading dims, at the same tolerance.
  * ``qbound``/``ste_quant``: forward value and backward cotangent
    bit-exact, and the sinks' statistics (DFXP, fixed, Observe) exactly
    equal to ``jax.grad`` with respect to the reference's sinks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import quant as jquant
from repro.kernels import _tiling as jtiling
from repro.kernels import dispatch as jdispatch
from repro.kernels.dfxp.ops import dfxp_quantize as j_dfxp_quantize
from repro.kernels.dfxp.ref import dfxp_quantize_ref as j_dfxp_ref
from repro.kernels.qmatmul.ops import qmm as j_qmm
from repro.kernels.qmatmul.ref import _q as j_round
from repro_torch.core import formats as tformats
from repro_torch.core import quant as tquant
from repro_torch.kernels import _tiling as ttiling
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.dfxp import ops as tdfxp
from repro_torch.kernels.dfxp.ref import dfxp_quantize_ref as t_dfxp_ref
from repro_torch.kernels.qmatmul import ops as tqmm
from repro_torch.kernels.qmatmul.ref import round_operand as t_round

WIDTHS = [8, 10, 12, 16, None]
RTOL = 1e-5


def _atol(D):
    return 1e-5 * np.sqrt(D)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# K1: fused quantize
# ---------------------------------------------------------------------------

def _k1_both(x: np.ndarray, e: float, width: int, dtype: str):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.to(torch.float32).numpy())
    jy, js = j_dfxp_quantize(jx, jnp.float32(e), width=width, interpret=True)
    jr, jrs = j_dfxp_ref(jx, jnp.float32(e), width=width)
    ty, ts = tdfxp.dfxp_quantize(tx, e, width=width)
    ry, rs = t_dfxp_ref(tx, torch.tensor(e), width=width)
    assert ty.dtype == tx.dtype and tuple(ty.shape) == x.shape
    for want_y, want_s in ((jy, js), (jr, jrs)):
        np.testing.assert_array_equal(np.asarray(want_y, np.float32),
                                      ty.to(torch.float32).numpy())
        np.testing.assert_array_equal(np.asarray(want_s), ts.numpy())
    np.testing.assert_array_equal(ry.to(torch.float32).numpy(),
                                  ty.to(torch.float32).numpy())
    np.testing.assert_array_equal(rs.numpy(), ts.numpy())
    return ts


@pytest.mark.parametrize("shape", [(8, 128), (256, 512), (64, 1200), (3, 7),
                                   (1000,), (4, 33, 65)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("width", [8, 10])
def test_k1_plain_matches_reference_shapes(shape, width):
    x = _normal(sum(shape) + width, shape, 4.0)
    st = _k1_both(x, 4.0 - width, width, "float32")
    assert st[1] > 0                     # the half-range count is exercised


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("width", [8, 12, 16])
def test_k1_plain_matches_reference_dtypes(dtype, width):
    _k1_both(_normal(width, (64, 256), 10.0), -3.0, width, dtype)


@pytest.mark.parametrize("e", [-30.0, 30.0])
def test_k1_plain_matches_reference_extreme_exponents(e):
    x = _normal(5, (32, 130), 2.0 ** (e + 8))
    st = _k1_both(x, e, 10, "float32")
    assert st[0] > 0


def test_k1_plain_propagates_nan_and_clips_inf():
    x = _normal(6, (17, 31), 8.0)
    x[0, 0], x[3, 5], x[9, 30] = np.nan, np.inf, -np.inf
    st = _k1_both(x, -2.0, 10, "float32")
    ty, _ = tdfxp.dfxp_quantize(torch.from_numpy(x), -2.0, width=10)
    assert torch.isnan(ty[0, 0]) and torch.isfinite(ty[3, 5])
    assert int(torch.isnan(ty).sum()) == 1 and st[0] >= 2


def test_fixed_round_routes_to_k1_when_enabled():
    x = torch.from_numpy(_normal(7, (64, 300), 3.0))
    want = tquant.fixed_round(x, 10, -3.0)
    n = tdfxp.LAUNCHES["dfxp_quantize"]
    tquant.enable_pallas_quantize(True, min_size=1 << 14)
    try:
        got = tquant.fixed_round(x, 10, -3.0)
        small = tquant.fixed_round(x[:10], 10, -3.0)      # below min_size
        per_row = tquant.fixed_round(x, 10, torch.full((64, 1), -3.0))
    finally:
        tquant.enable_pallas_quantize(False)
    # the CPU path computes the plain version and launches nothing
    assert tdfxp.LAUNCHES["dfxp_quantize"] == n
    for g in (got, per_row):
        assert torch.equal(g[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(g[1], want[1]))
    assert small[0].shape == (10, 300)


# ---------------------------------------------------------------------------
# K2: quantized matmul
# ---------------------------------------------------------------------------

def _operands(kind, R, C, D, seed):
    a = _normal(seed, (D, R) if kind == "tn" else (R, D))
    b = _normal(seed + 1, (C, D) if kind == "nt" else (D, C), 0.5)
    return a, b


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("wi", range(len(WIDTHS)),
                         ids=[f"a{w}-b{WIDTHS[(i + 2) % 5]}"
                              for i, w in enumerate(WIDTHS)])
def test_k2_plain_matches_reference(kind, wi):
    width_a, width_b = WIDTHS[wi], WIDTHS[(wi + 2) % len(WIDTHS)]
    R, C, D = (100, 130, 50) if wi % 2 else (64, 96, 128)
    a, b = _operands(kind, R, C, D, 10 * wi)
    e_a, e_b = -6.0, -7.0
    for x, e, w in ((a, e_a, width_a), (b, e_b, width_b)):
        if w is not None:
            np.testing.assert_array_equal(
                np.asarray(j_round(jnp.asarray(x), jnp.float32(e), w)),
                t_round(torch.from_numpy(x), e, w).numpy())
    want = j_qmm(jnp.asarray(a), jnp.asarray(b), jnp.float32(e_a),
                 jnp.float32(e_b), kind=kind, width_a=width_a,
                 width_b=width_b, interpret=True)
    got = tqmm.qmm(torch.from_numpy(a), torch.from_numpy(b), e_a, e_b,
                   kind=kind, width_a=width_a, width_b=width_b)
    assert tuple(got.shape) == (R, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=_atol(D))


def test_k2_wrapper_checks_shapes():
    a, b = torch.zeros(4, 5), torch.zeros(6, 7)
    for kind in ("nn", "nt", "tn"):
        with pytest.raises(ValueError):
            tqmm.qmm(a, b, 0.0, 0.0, kind=kind, width_a=10, width_b=10)
    with pytest.raises(ValueError):
        tqmm.qmm(a, torch.zeros(5, 3), 0.0, 0.0, kind="nx", width_a=10,
                 width_b=10)


# ---------------------------------------------------------------------------
# the differentiable fused matmul
# ---------------------------------------------------------------------------

def _grads_torch(fn, a, b, r):
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y = fn(ta, tb)
    (y * torch.from_numpy(r)).sum().backward()
    return y.detach().numpy(), ta.grad.numpy(), tb.grad.numpy()


def _grads_jax(fn, a, b, r):
    y = fn(jnp.asarray(a), jnp.asarray(b))
    da, db = jax.grad(lambda x, w: jnp.vdot(fn(x, w), jnp.asarray(r)),
                      (0, 1))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(y), np.asarray(da), np.asarray(db)


def _close(got, want, D):
    for g, w, d in zip(got, want, D):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=_atol(d))


@pytest.mark.parametrize("width", [8, 10, 12, 16])
@pytest.mark.parametrize("transpose_b", [False, True], ids=["nn", "nt"])
def test_fused_dot_fwd_and_grads_match_reference(width, transpose_b):
    M, K, N = (33, 65, 7) if width % 4 else (64, 128, 96)
    a = _normal(width, (M, K))
    b = _normal(width + 1, (N, K) if transpose_b else (K, N), 0.5)
    r = _normal(width + 2, (M, N))
    e_a, e_b, e_g = -6.0, -7.0, -5.0
    kw = dict(width=width, grad_width=width, transpose_b=transpose_b)
    want = _grads_jax(lambda x, w: jdispatch.fused_dot(
        x, w, jnp.float32(e_a), jnp.float32(e_b), e_g=jnp.float32(e_g),
        interpret=True, **kw), a, b, r)
    got = _grads_torch(lambda x, w: tdispatch.fused_dot(
        x, w, e_a, e_b, e_g=e_g, **kw), a, b, r)
    _close(got, want, (K, N, M))


@pytest.mark.parametrize("transpose_b", [False, True], ids=["nn", "nt"])
def test_tape_dot_batched_matches_reference(transpose_b):
    B, S, D, V = 3, 37, 72, 56
    x = _normal(20, (B, S, D))
    w = _normal(21, (V, D) if transpose_b else (D, V))
    r = _normal(22, (B, S, V))
    want = _grads_jax(lambda x_, w_: jdispatch.tape_dot(
        x_, w_, jnp.float32(-6.0), width=10, transpose_b=transpose_b,
        interpret=True), x, w, r)
    got = _grads_torch(lambda x_, w_: tdispatch.tape_dot(
        x_, w_, -6.0, width=10, transpose_b=transpose_b), x, w, r)
    _close(got, want, (D, V, B * S))


def test_fused_dot_skips_the_grad_of_an_input_that_needs_none():
    x = torch.from_numpy(_normal(30, (16, 24)))
    w = torch.from_numpy(_normal(31, (24, 8))).requires_grad_(True)
    before = dict(tqmm.LAUNCHES)
    tdispatch.tape_dot(x, w, -6.0, width=10).sum().backward()
    assert w.grad is not None and x.grad is None
    # the CPU path launches nothing; the layouts it would launch are the
    # card's concern (tests/test_torch_kernels.py)
    assert tqmm.LAUNCHES == before


# ---------------------------------------------------------------------------
# qbound / ste_quant and the sink statistics
# ---------------------------------------------------------------------------

FMTS = {
    "dfxp": (jformats.DynamicFixedPoint(10), tformats.DynamicFixedPoint(10)),
    "fixed": (jformats.FixedPoint(12, 3), tformats.FixedPoint(12, 3)),
    "observe": (jformats.Observe(), tformats.Observe()),
    "float16": (jformats.FLOAT16, tformats.FLOAT16),
}


@pytest.mark.parametrize("fmt", list(FMTS))
def test_qbound_value_cotangent_and_sink_stats_exact(fmt):
    jf, tf = FMTS[fmt]
    x = _normal(40, (48, 96), 3.0)
    ct = _normal(41, (48, 96), 3.0)
    a_e, g_e = -4.0, -10.0

    def jfn(x_, sink):
        return jquant.qbound(x_, jf, jf, jnp.float32(a_e), jnp.float32(g_e),
                             sink)

    sink0 = jquant.new_sink()
    jy, vjp = jax.vjp(jfn, jnp.asarray(x), sink0)
    jdx, jsink = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    sink = tquant.new_sink()
    ty = tquant.qbound(tx, tf, tf, a_e, g_e, sink)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(np.asarray(jy), ty.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jdx), tx.grad.numpy())
    np.testing.assert_array_equal(np.asarray(jsink), sink.grad.numpy())
    if fmt in ("dfxp", "fixed"):
        assert sink.grad[0] > 0 and sink.grad[1] > sink.grad[0]


def test_qbound_site_forward_stats_equal_q_stats():
    x = _normal(42, (32, 64), 3.0)
    for name, (jf, tf) in FMTS.items():
        _, st = tquant.qbound_site(torch.from_numpy(x), tf, tf, -4.0, -4.0,
                                   None, want_stats=True)
        np.testing.assert_array_equal(
            np.asarray(jquant.q_stats(jnp.asarray(x), jf, jnp.float32(-4.0))),
            st.numpy(), err_msg=name)


def test_ste_quant_forward_rounds_backward_passes_through():
    w = _normal(43, (24, 40), 0.3)
    ct = _normal(44, (24, 40))
    jf, tf = FMTS["dfxp"]
    jy, vjp = jax.vjp(lambda w_: jquant.ste_quant(w_, jf, jnp.float32(-7.0)),
                      jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(ct))
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tquant.ste_quant(tw, tf, -7.0)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(np.asarray(jy), ty.detach().numpy())
    np.testing.assert_array_equal(np.asarray(jdw), tw.grad.numpy())


def test_tiling_helpers_match_reference():
    for x, m in ((0, 8), (1, 8), (8, 8), (130, 128), (1000, 512)):
        assert ttiling.round_up(x, m) == jtiling.round_up(x, m)
    a = _normal(50, (5, 7))
    for rows, cols in ((5, 7), (8, 7), (5, 128), (16, 16)):
        np.testing.assert_array_equal(
            np.asarray(jtiling.pad2d(jnp.asarray(a), rows, cols)),
            ttiling.pad2d(torch.from_numpy(a), rows, cols).numpy())
