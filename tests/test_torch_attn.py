"""Plain versions of K3/K4 (repro_torch.kernels.attn) against the reference.

The port's wrappers, given CPU tensors, compute the plain PyTorch
versions; they are held against the reference's Pallas kernels in
interpret mode (``repro.kernels.attn.ops.flash_decode/flash_prefill``)
and against its composites (``ref.attend`` / ``ref.chunk_attend``).
Tolerance: atol = rtol = 1e-5 — both sides are f32 einsums over the same
operands in the same order, differing only in the backends' summation.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn import ops as jops
from repro.kernels.attn import ref as jref
from repro_torch.core.packed import container_dtype, qrange
from repro_torch.kernels.attn import ops as tops
from repro_torch.kernels.attn import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]


def _pool(rng, B, W, K, hd, width):
    if width is None:
        k = rng.standard_normal((B, W, K, hd)).astype(np.float32)
        v = rng.standard_normal((B, W, K, hd)).astype(np.float32)
        return k, v, None, None
    qmax, qmin = qrange(width)
    npdt = {8: np.int8, 16: np.int16}[width]
    k = rng.integers(int(qmin), int(qmax) + 1, (B, W, K, hd)).astype(npdt)
    v = rng.integers(int(qmin), int(qmax) + 1, (B, W, K, hd)).astype(npdt)
    # steps that put the values at O(1..16), as calibration does
    ke = rng.integers(1 - width, 4 - width, B).astype(np.float32)
    ve = rng.integers(1 - width, 4 - width, B).astype(np.float32)
    return k, v, ke, ve


def _pos(rng, B, W, fill, holes):
    """Ring positions: slot b holds positions [0, fill[b]) at ``p % W``,
    -1 elsewhere; ``holes`` punches random empty slots."""
    pos = np.full((B, W), -1, np.int32)
    for b in range(B):
        for p in range(max(0, fill[b] - W), fill[b]):
            pos[b, p % W] = p
    if holes:
        pos[rng.random((B, W)) < 0.25] = -1
    return pos


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


DECODE_CASES = {
    # name: (K, G, W, fill per slot, window, holes)
    "gqa2x2_empty_slot": (2, 2, 37, [0, 37, 50], None, False),
    "gqa1x4_holes": (1, 4, 45, [45, 3, 70], None, True),
    "window": (2, 2, 33, [60, 33, 12], 9, False),
}


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_plain_matches_reference(width, case):
    K, G, W, fill, window, holes = DECODE_CASES[case]
    B, hd = len(fill), 16
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    k, v, ke, ve = _pool(rng, B, W, K, hd, width)
    pos = _pos(rng, B, W, fill, holes)
    qpos = np.maximum(np.array(fill, np.int32) - 1, 0).astype(np.int32)
    kw = dict(width=width, scale=0.3, window=window)
    got = tops.flash_decode(_t(q), _t(k), _t(v), _t(pos), _t(qpos), _t(ke),
                            _t(ve), **kw).numpy()
    want = np.asarray(jops.flash_decode(
        _j(q), _j(k), _j(v), _j(pos), _j(qpos), _j(ke), _j(ve),
        interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    # and the composite directly
    kf, vf = (k.astype(np.float32), v.astype(np.float32))
    if width is not None:
        kf = kf * np.exp2(ke)[:, None, None, None]
        vf = vf * np.exp2(ve)[:, None, None, None]
    comp = np.asarray(jref.attend(_j(q), _j(kf), _j(vf), _j(pos), _j(qpos),
                                  scale=0.3, window=window))
    np.testing.assert_allclose(got, comp, **TOL)
    if fill[0] == 0:              # every lane of slot 0 masked → exact zeros
        assert np.all(got[0] == 0.0)


PREFILL_CASES = {
    # name: (K, G, C, W, p0 per slot, n_valid per slot, window, holes)
    "gqa2x2_ragged": (2, 2, 8, 23, [6, 0, 30, 8], [8, 5, 3, 0], None, False),
    "gqa1x4_holes": (1, 4, 6, 19, [12, 19, 4], [6, 6, 2], None, True),
    "window": (2, 2, 8, 21, [9, 40, 0], [8, 7, 8], 5, False),
}


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_flash_prefill_plain_matches_reference(width, case):
    K, G, C, W, p0, nv, window, holes = PREFILL_CASES[case]
    B, hd = len(p0), 16
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    q = rng.standard_normal((B, C, K, G, hd)).astype(np.float32)
    kn = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    vn = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    k, v, ke, ve = _pool(rng, B, W, K, hd, width)
    pos = _pos(rng, B, W, p0, holes)
    p0a, nva = np.array(p0, np.int32), np.array(nv, np.int32)
    kw = dict(width=width, scale=0.25, window=window)
    got = tops.flash_prefill(_t(q), _t(kn), _t(vn), _t(k), _t(v), _t(pos),
                             _t(p0a), _t(nva), _t(ke), _t(ve), **kw).numpy()
    want = np.asarray(jops.flash_prefill(
        _j(q), _j(kn), _j(vn), _j(k), _j(v), _j(pos), _j(p0a), _j(nva),
        _j(ke), _j(ve), interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    kf, vf = (k.astype(np.float32), v.astype(np.float32))
    if width is not None:
        kf = kf * np.exp2(ke)[:, None, None, None]
        vf = vf * np.exp2(ve)[:, None, None, None]
    comp = np.asarray(jref.chunk_attend(_j(q), _j(kf), _j(vf), _j(pos),
                                        _j(kn), _j(vn), _j(p0a), _j(nva),
                                        scale=0.25, window=window))
    np.testing.assert_allclose(got, comp, **TOL)
    for b in range(B):            # rows past n_valid are fully masked → 0
        assert np.all(got[b, nv[b]:] == 0.0)   # n_valid 0: the whole chunk


def test_wrappers_reject_devices_they_do_not_run_on():
    q = torch.zeros((1, 1, 1, 8), device="meta")
    k = torch.zeros((1, 4, 1, 8), device="meta")
    pos = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tops.flash_decode(q, k, k, pos, pos[:, 0], scale=1.0)


def test_storage_dtypes_follow_width():
    assert container_dtype(8) == torch.int8
    assert container_dtype(16) == torch.int16
    assert tref.valid_mask(torch.tensor([[0, 5, -1]], dtype=torch.int32),
                           torch.tensor([4], dtype=torch.int32), window=None,
                           causal=True).tolist() == [[True, False, False]]
