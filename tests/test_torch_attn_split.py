"""The arithmetic of the split designs of K3 and K4, and K2's widths past
24, on the CPU.

The card kernels do in pieces what the plain versions do in one: K3
(flash-decode) splits the ring's tiles over blocks and merges the partial
softmax states; K4 (flash-prefill) runs q·k and p·v on TF32 tensor cores
with hi + lo splits of the operands that are not exact in TF32, and cuts
its list of history and chunk tiles into splits.  These tests hold the
plain emulations of that arithmetic
(:func:`repro_torch.kernels.attn.ref.decode_split_ref`,
:func:`repro_torch.kernels.attn.ref.prefill_tf32_emulated`) to the plain
versions and to the JAX reference's Pallas kernels in interpret mode, on
seeded numpy inputs, and the port's CPU ``qmm`` at widths 25, 31 and 32
to the reference's ``qmm(interpret=True)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn import ops as jops
from repro.kernels.qmatmul.ops import qmm as j_qmm
from repro_torch.core.packed import qrange
from repro_torch.kernels.attn import ops as aops
from repro_torch.kernels.attn import ref as aref
from repro_torch.kernels.qmatmul import cases as mcases
from repro_torch.kernels.qmatmul import ops as mops
from repro_torch.kernels.qmatmul import ref as mref

WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]
# decode: 3 slots over a 100-entry ring (4 tiles, the last 4 entries)
DK, DG, DHD, DW = 2, 2, 16, 100
DFILL = [100, 130, 0]               # full, wrapped, empty slot
# prefill: a 40-row chunk (2 tiles) against a 75-entry ring (3 tiles)
PK, PG, PHD, PC, PW = 2, 3, 16, 40, 75


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _pool(rng, B, W, K, hd, width):
    if width is None:
        k = rng.standard_normal((B, W, K, hd)).astype(np.float32)
        v = rng.standard_normal((B, W, K, hd)).astype(np.float32)
        return k, v, None, None
    qmax, qmin = qrange(width)
    dt = np.int8 if width == 8 else np.int16
    k = rng.integers(int(qmin), int(qmax) + 1, (B, W, K, hd)).astype(dt)
    v = rng.integers(int(qmin), int(qmax) + 1, (B, W, K, hd)).astype(dt)
    ke = rng.integers(1 - width, 4 - width, B).astype(np.float32)
    ve = rng.integers(1 - width, 4 - width, B).astype(np.float32)
    return k, v, ke, ve


def _ring(B, W, fill):
    pos = np.full((B, W), -1, np.int32)
    for b, n in enumerate(fill):
        for p in range(max(0, n - W), n):
            pos[b, p % W] = p
    return pos


# ---------------------------------------------------------------------------
# K3: split over the ring's tiles, merged in split order
# ---------------------------------------------------------------------------

def _decode_case(width, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(DFILL), DK, DG, DHD)).astype(np.float32)
    k, v, ke, ve = _pool(rng, len(DFILL), DW, DK, DHD, width)
    pos = _ring(len(DFILL), DW, DFILL)
    qpos = np.array([max(n - 1, 0) for n in DFILL], np.int32)
    return q, k, v, pos, qpos, ke, ve


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [None, 20], ids=["global", "window"])
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_ring_split_decode_matches_unsplit_and_reference(width, window,
                                                         splits):
    """W = 100 is not a multiple of 32 (the last tile holds 4 entries);
    with window 20 slot 0 sees positions 80..99 only, in the last two of
    four tiles, so whole splits see no key; slot 2 is empty (0, not
    NaN)."""
    case = _decode_case(width)
    q, k, v, pos, qpos, ke, ve = map(_t, case)
    kw = dict(width=width, scale=DHD ** -0.5, window=window)
    got = aref.decode_split_ref(q, k, v, pos, qpos, k_exp=ke, v_exp=ve,
                                splits=splits, **kw)
    whole = aref.decode_attention_ref(q, k, v, pos, qpos, k_exp=ke,
                                      v_exp=ve, **kw)
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)
    want = np.asarray(jops.flash_decode(*map(_j, case), interpret=True,
                                        **kw))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(got).all() and not got[2].any()


@pytest.mark.parametrize("B,K,W,want", [(4, 8, 400, (5, 3)),
                                        (1, 8, 400, (13, 1)),
                                        (4, 8, 32, (1, 1)),
                                        (64, 8, 4096, (1, 128)),
                                        (3, 2, 333, (11, 1)),
                                        (2, 2, 1000, (32, 1))])
def test_ring_splits_cover_the_ring_and_fill_a_wave(B, K, W, want):
    """S = 5 of 3 tiles (160 blocks) at the serving shape; the ranges
    cover the ring's tiles exactly, none empty, and the blocks fill a
    wave of SMs where there are tiles enough."""
    splits, tps = aops.ring_splits(B, K, W)
    assert (splits, tps) == want
    n_tiles = -(-W // aops.TILE)
    assert (splits - 1) * tps < n_tiles <= splits * tps
    assert K * B * splits >= aops.SMS or splits == n_tiles


# ---------------------------------------------------------------------------
# K4: TF32 products and the split over the tile list
# ---------------------------------------------------------------------------

PREFILL = {
    # name: (p0 per slot, n_valid per slot, window)
    "ragged": ([60, 0], [40, 23], None),
    "window": ([100, 7], [40, 40], 24),
}
# K4's route against the plain version: every product term is within
# ~2^-22 of its f32 value relative to |a·b| (hi + lo), against ~2^-11 for
# one TF32 product; outputs are O(1..16) sums of at most W + C terms, so
# the route holds atol = rtol = 1e-5, as the plain version does against
# the reference, while one product per term misses it (checked below)
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)


def _prefill_case(name, width, seed=9):
    p0, nv, window = PREFILL[name]
    B = len(p0)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, PC, PK, PG, PHD)).astype(np.float32)
    kn = rng.standard_normal((B, PC, PK, PHD)).astype(np.float32)
    vn = rng.standard_normal((B, PC, PK, PHD)).astype(np.float32)
    k, v, ke, ve = _pool(rng, B, PW, PK, PHD, width)
    pos = _ring(B, PW, p0)
    args = (q, kn, vn, k, v, pos, np.array(p0, np.int32),
            np.array(nv, np.int32), ke, ve)
    return args, dict(width=width, scale=PHD ** -0.5, window=window)


def _emulated(args, kw, splits):
    q, kn, vn, k, v, pos, p0, nv, ke, ve = map(_t, args)
    return aref.prefill_tf32_emulated(q, k, v, pos, kn, vn, p0, nv,
                                      k_exp=ke, v_exp=ve, splits=splits,
                                      **kw)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("name", list(PREFILL))
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_prefill_tf32_route_matches_plain_and_reference(width, name, splits):
    """int8: 2 products for q·k and for p·v; int16 and f32: 3.  Ragged
    n_valid, a chunk at p0 = 0 and a window; 3 splits of the 5-tile
    list put the history and the chunk's tiles in different splits."""
    args, kw = _prefill_case(name, width)
    got = _emulated(args, kw, splits)
    q, kn, vn, k, v, pos, p0, nv, ke, ve = map(_t, args)
    plain = aref.prefill_attention_ref(q, k, v, pos, kn, vn, p0, nv,
                                       k_exp=ke, v_exp=ve, **kw)
    torch.testing.assert_close(got, plain, **ROUTE_TOL)
    want = np.asarray(jops.flash_prefill(*map(_j, args), interpret=True,
                                         **kw))
    np.testing.assert_allclose(got.numpy(), want, **ROUTE_TOL)
    for b, n in enumerate(PREFILL[name][1]):
        assert not got[b, n:].any()
    from repro_torch.kernels.attn import cases
    assert cases.prefill_products(width) == ((2, 3) if width == 8
                                             else (3, 3))


def test_one_tf32_product_misses_the_route_tolerance(monkeypatch):
    """The hi + lo split is what holds the tolerance: with q and p taken
    as one TF32 value each (lo dropped) the route misses it."""
    args, kw = _prefill_case("ragged", 8)
    q, kn, vn, k, v, pos, p0, nv, ke, ve = map(_t, args)
    plain = aref.prefill_attention_ref(q, k, v, pos, kn, vn, p0, nv,
                                       k_exp=ke, v_exp=ve, **kw)
    monkeypatch.setattr(aref, "split_tf32",
                        lambda x: (mref.tf32_round(x), torch.zeros_like(x)))
    rough = _emulated(args, kw, 1)
    assert not torch.allclose(rough, plain, **ROUTE_TOL)


@pytest.mark.parametrize("B,C,W,K,G,hd,want", [
    (1, 128, 400, 8, 4, 128, (8, 4)),
    (2, 128, 400, 8, 4, 128, (8, 2)),
    (1, 64, 448, 8, 4, 128, (8, 8)),
    (1, 40, 75, 2, 3, 256, (2, 5)),
    (16, 128, 4096, 8, 4, 128, (8, 1))])
def test_prefill_plan_fits_one_wave(B, C, W, K, G, hd, want):
    """As many splits as fit one wave of SMs (one more would not), at most
    one per tile of the list; 8-warp blocks up to hd = 128."""
    warps, splits = aops.prefill_plan(B, C, W, K, G, hd)
    assert (warps, splits) == want
    n_list = -(-W // aops.TILE) + -(-C // aops.TILE)
    per_split = -(-C * G // (16 * warps)) * K * B
    assert 1 <= splits <= n_list
    assert per_split * splits <= aops.SMS or splits == 1
    assert per_split * (splits + 1) > aops.SMS or splits == n_list


# ---------------------------------------------------------------------------
# K2: widths past 24 on the CPU path, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("width", [25, 31, 32])
def test_qmm_wide_widths_match_the_reference(kind, width):
    """One operand on its own width's grid at step 2^(3 - w), the other
    clipped (step 2^-28 on unit-scale values: the width-25 grid holds
    2^24 steps each side).  The reference's qmm has no width cap; the
    port's CPU path computes the same; the card kernel now takes these
    widths too, and its TF32 route (emulated) holds the same tolerance."""
    a = mcases.qmm_case(kind, 48, 40, 96, width_a=width, width_b=width,
                        e_a=3.0 - width, e_b=-28.0, seed=12, device="cpu")
    kw = {k: a[k] for k in ("e_a", "e_b", "kind", "width_a", "width_b")}
    got = mops.qmm(a["a"], a["b"], **kw)
    want = j_qmm(jnp.asarray(a["a"].numpy()), jnp.asarray(a["b"].numpy()),
                 jnp.float32(a["e_a"]), jnp.float32(a["e_b"]), kind=kind,
                 width_a=width, width_b=width, interpret=True)
    tol = mcases.tolerance(96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=tol["rtol"], atol=tol["atol"])
    # the card's route at these widths: both operands split, 3 products,
    # within the same tolerance
    assert mops.products(width, width) == 3
    route = mref.qmatmul_tf32_emulated(a["a"], a["b"], **kw)
    torch.testing.assert_close(route, got, **tol)
