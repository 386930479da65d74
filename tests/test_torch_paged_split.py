"""The arithmetic of K6 (paged flash-prefill) on its TF32 route, on the CPU.

K6 runs K4's tensor-core design over the page arena: q·k and p·v on TF32
parts (hi + lo where an operand is not exact in TF32), each 32-key
history tile of a slot's logical rows read from the one page its
block-table entry names and scaled by that page's own steps, the block's
list of visible history and chunk tiles cut into splits and merged in
split order.  These tests hold the plain emulation of that arithmetic
(:func:`repro_torch.kernels.attn.ref.paged_prefill_tf32_emulated`) to the
plain version
(:func:`repro_torch.kernels.attn.ref.paged_prefill_attention_ref`)
and to the JAX reference's ``flash_prefill_paged`` in interpret mode, on
seeded numpy inputs with a null page, a prefix page shared by two slots
and a copy-on-write fork, and to K4's emulation on a ring laid out as
pages; and they check K6's plan (``attn.ops.prefill_paged_plan``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn import ops as jops
from repro_torch.core.packed import qrange
from repro_torch.kernels.attn import ops as aops
from repro_torch.kernels.attn import ref as aref

WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]
# two slots over 4 blocks of 32-row pages; a 40-row chunk (2 tiles)
P, NBLK, K, G, C = 32, 4, 2, 3, 40
N_PAGES = 1 + 2 * NBLK
P0, NV = [70, 50], [40, 23]
# K4's route tolerance (tests/test_torch_attn_split.py ROUTE_TOL): every
# product term is within ~2^-22 of its f32 value relative to |a·b|, and
# outputs are O(1..16) sums of at most W + C terms
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _arena(rng, hd, width):
    shape = (N_PAGES, P, K, hd)
    if width is None:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ke = ve = None
    else:
        qmax, qmin = qrange(width)
        dt = np.int8 if width == 8 else np.int16
        k = rng.integers(int(qmin), int(qmax) + 1, shape).astype(dt)
        v = rng.integers(int(qmin), int(qmax) + 1, shape).astype(dt)
        ke = rng.integers(1 - width, 4 - width, N_PAGES).astype(np.float32)
        ve = rng.integers(1 - width, 4 - width, N_PAGES).astype(np.float32)
    k[0] = 0
    v[0] = 0
    return k, v, ke, ve


@functools.lru_cache(maxsize=None)
def _case(width, window, hd, seed=21):
    """Slot 0: 70 history rows and the 40-row chunk's blocks mapped (4
    pages).  Slot 1: its first block maps slot 0's first page (a shared
    prefix page); its second is a copy-on-write fork of slot 0's second
    page (rows 32..49 copied with the page's steps, the rest its own);
    its third holds the chunk's rows; its fourth is the null page."""
    rng = np.random.default_rng(seed)
    k, v, ke, ve = _arena(rng, hd, width)
    bt = np.array([[3, 7, 1, 5], [3, 8, 2, 0]], np.int32)
    k[8, :18] = k[7, :18]
    v[8, :18] = v[7, :18]
    if width is not None:
        ke[8], ve[8] = ke[7], ve[7]
    pos = np.full((2, NBLK * P), -1, np.int32)
    for b, n in enumerate(P0):
        pos[b, :n] = np.arange(n)
    B = len(P0)
    q = rng.standard_normal((B, C, K, G, hd)).astype(np.float32)
    kn = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    vn = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    args = (q, kn, vn, k, v, bt, pos, np.array(P0, np.int32),
            np.array(NV, np.int32), ke, ve)
    kw = dict(width=width, scale=hd ** -0.5, window=window)
    want = np.asarray(jops.flash_prefill_paged(*map(_j, args),
                                               interpret=True, **kw))
    return args, kw, want


def _emulated(args, kw, splits):
    q, kn, vn, k, v, bt, pos, p0, nv, ke, ve = map(_t, args)
    return aref.paged_prefill_tf32_emulated(q, k, v, bt, pos, kn, vn, p0,
                                            nv, k_exp=ke, v_exp=ve,
                                            splits=splits, **kw)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("hd", [48, 128])
@pytest.mark.parametrize("window", [None, 24], ids=["global", "window"])
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_paged_prefill_tf32_route_matches_plain_and_reference(width, window,
                                                              hd, splits):
    """int8: 2 products for q·k and for p·v; int16 and f32: 3.  A shared
    prefix page, a forked page, a null page past slot 1's frontier,
    ragged n_valid; 2 and 3 splits put history and chunk tiles in
    different splits, and with window 24 slot 0's early history tiles
    drop out of the list."""
    args, kw, want = _case(width, window, hd)
    got = _emulated(args, kw, splits)
    q, kn, vn, k, v, bt, pos, p0, nv, ke, ve = map(_t, args)
    plain = aref.paged_prefill_attention_ref(q, k, v, bt, pos, kn, vn, p0,
                                             nv, k_exp=ke, v_exp=ve, **kw)
    torch.testing.assert_close(got, plain, **ROUTE_TOL)
    np.testing.assert_allclose(got.numpy(), want, **ROUTE_TOL)
    for b, n in enumerate(NV):
        assert not got[b, n:].any()


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_paged_route_equals_k4_route_on_a_ring_laid_out_as_pages(width,
                                                                 splits):
    """One page per slot holding its whole ring, with the slot's steps:
    K6's route and K4's route compute the same values in the same order,
    so they agree bit for bit (on the card the kernels share one code)."""
    args, kw, _ = _case(width, None, 48)
    q, kn, vn, k, v, bt, pos, p0, nv, ke, ve = map(_t, args)
    W = NBLK * P
    ring_k = aref.gather_pages(k, None, bt, None).to(k.dtype)
    ring_v = aref.gather_pages(v, None, bt, None).to(v.dtype)
    slot_e = None if width is None else torch.tensor([-width, 2 - width])
    ring = aref.prefill_tf32_emulated(q, ring_k, ring_v, pos, kn, vn, p0,
                                      nv, k_exp=slot_e, v_exp=slot_e,
                                      splits=splits, **kw)
    arena_k = torch.cat([torch.zeros_like(ring_k[:1]), ring_k]) \
        .reshape(3, W, K, 48)
    arena_v = torch.cat([torch.zeros_like(ring_v[:1]), ring_v]) \
        .reshape(3, W, K, 48)
    page_e = None if width is None else torch.cat([torch.zeros(1), slot_e])
    paged = aref.paged_prefill_tf32_emulated(
        q, arena_k, arena_v, torch.tensor([[1], [2]], dtype=torch.int32),
        pos, kn, vn, p0, nv, k_exp=page_e, v_exp=page_e, splits=splits,
        **kw)
    assert torch.equal(paged, ring)


@pytest.mark.parametrize("B,C,nblocks,P,K,G,hd,want", [
    (1, 64, 8, 64, 8, 4, 128, (8, 8)),
    (4, 64, 8, 64, 8, 4, 128, (8, 2)),
    (1, 128, 4, 128, 8, 4, 128, (8, 4)),
    (2, 40, 4, 32, 2, 3, 256, (2, 6)),
    (16, 64, 64, 64, 8, 4, 128, (8, 1))])
def test_prefill_paged_plan_fits_one_wave(B, C, nblocks, P, K, G, hd, want):
    """K6's plan: as many splits as fit one wave of SMs (one more would
    not), at most one per tile of the list of the block table's
    ``nblocks·P / 32`` history tiles and the chunk's; 8-warp blocks up to
    hd = 128."""
    warps, splits = aops.prefill_paged_plan(B, C, nblocks, P, K, G, hd)
    assert (warps, splits) == want
    n_list = nblocks * P // aops.TILE + -(-C // aops.TILE)
    per_split = -(-C * G // (16 * warps)) * K * B
    assert 1 <= splits <= n_list
    assert per_split * splits <= aops.SMS or splits == 1
    assert per_split * (splits + 1) > aops.SMS or splits == n_list
