"""The arithmetic of the split designs of K2 and K5, on the CPU.

The card kernels split work the plain versions do in one piece: K5
(paged flash-decode) splits the walk over a block table's pages and
merges the partial softmax states; K2 (quantized matmul) splits the
reduction (split-K) and multiplies on TF32 tensor cores, with operands
that are not exact in TF32 split into hi + lo parts.  These tests check
that arithmetic with its plain emulations on seeded numpy inputs:

* K5: :func:`repro_torch.kernels.attn.ref.paged_decode_split_ref` at
  S = 1, 2, 3 and nblocks splits equals the unsplit plain version and the
  JAX reference's paged decode (interpret mode) to atol = rtol = 1e-5,
  with a split whose keys are all masked, an empty slot (0, not NaN) and
  a window that excludes whole splits;
* K2: :func:`repro_torch.kernels.qmatmul.ops.plan` covers the reduction
  exactly and fills a wave of SMs at the maxout shapes; every value
  rounded at width <= 12 is exact in TF32; the hi + lo split is within
  2^-22 of its input; the 1-, 2- and 3-product emulations agree with the
  plain version (and the JAX reference) within ``cases.tolerance``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn.ops import flash_decode_paged as j_decode_paged
from repro.kernels.qmatmul.ops import qmm as j_qmm
from repro_torch.kernels.attn import ops as aops
from repro_torch.kernels.attn import ref as aref
from repro_torch.kernels.qmatmul import cases as mcases
from repro_torch.kernels.qmatmul import ops as mops
from repro_torch.kernels.qmatmul import ref as mref

WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]
P, NBLK, KH, G, HD = 8, 4, 2, 2, 16
FILLS = [32, 13, 0]               # full, two mapped pages, empty slot


# ---------------------------------------------------------------------------
# K5: split over the pages, merged in split order
# ---------------------------------------------------------------------------

def _paged_case(width, seed=3):
    """A 12-page arena: slot 0 maps all 4 blocks, slot 1 two (its last two
    splits of 4 see no key), slot 2 only the null page."""
    rng = np.random.default_rng(seed)
    n_pages = 12
    perm = list(1 + rng.permutation(n_pages - 1))
    bt = np.zeros((len(FILLS), NBLK), np.int32)
    pos = np.full((len(FILLS), NBLK * P), -1, np.int32)
    for b, n in enumerate(FILLS):
        for j in range(-(-n // P)):
            bt[b, j] = perm.pop()
        pos[b, :n] = np.arange(n)
    shape = (n_pages, P, KH, HD)
    if width is None:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ke = ve = None
    else:
        hi = 2 ** (width - 1)
        dt = np.int8 if width == 8 else np.int16
        k = rng.integers(-hi, hi, shape).astype(dt)
        v = rng.integers(-hi, hi, shape).astype(dt)
        ke = rng.integers(1 - width, 4 - width, n_pages).astype(np.float32)
        ve = rng.integers(1 - width, 4 - width, n_pages).astype(np.float32)
    k[0] = 0
    v[0] = 0
    q = rng.standard_normal((len(FILLS), KH, G, HD)).astype(np.float32)
    qpos = np.array([max(n - 1, 0) for n in FILLS], np.int32)
    return q, k, v, bt, pos, qpos, ke, ve


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


_JAX = {}


def _jax_decode(width, window):
    """The JAX reference's paged decode of :func:`_paged_case`, once."""
    key = (width, window)
    if key not in _JAX:
        kw = dict(width=width, scale=HD ** -0.5, window=window)
        _JAX[key] = np.asarray(j_decode_paged(*map(_j, _paged_case(width)),
                                              **kw))
    return _JAX[key]


@pytest.mark.parametrize("splits", [1, 2, 3, NBLK])
@pytest.mark.parametrize("window", [None, 6], ids=["global", "window"])
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_split_decode_matches_unsplit_and_reference(width, window, splits):
    """With window 6 the full slot sees keys 26..31 only: every split but
    the last is masked whole."""
    args = list(map(_t, _paged_case(width)))
    kw = dict(width=width, scale=HD ** -0.5, window=window)
    q, k, v, bt, pos, qpos, ke, ve = args
    got = aref.paged_decode_split_ref(q, k, v, bt, pos, qpos, k_exp=ke,
                                      v_exp=ve, splits=splits, **kw)
    whole = aref.paged_decode_attention_ref(q, k, v, bt, pos, qpos,
                                            k_exp=ke, v_exp=ve, **kw)
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _jax_decode(width, window),
                               atol=1e-5, rtol=1e-5)
    assert torch.isfinite(got).all()
    assert not got[2].any()                   # empty slot: 0, not NaN


def test_merge_weighs_empty_splits_zero():
    """A part with m = -inf adds nothing, even with garbage in l and acc
    beside a finite part; a row with no finite part gives exact 0."""
    m1 = torch.tensor([0.5, -torch.inf])
    part1 = (m1, torch.tensor([2.0, 0.0]), torch.tensor([[4.0], [0.0]]))
    empty = (torch.full((2,), -torch.inf), torch.zeros(2), torch.zeros(2, 1))
    for parts in ([part1, empty], [empty, part1], [empty, part1, empty]):
        out = aref.merge_splits(parts)
        assert torch.equal(out, torch.tensor([[2.0], [0.0]]))


@pytest.mark.parametrize("B,K,nblocks,want", [(4, 8, 8, 4), (1, 2, 2, 2),
                                              (2, 2, 3, 3), (64, 8, 100, 1),
                                              (1, 8, 40, 14)])
def test_decode_splits_cover_the_block_table(B, K, nblocks, want):
    """S = 4 at the serving table's shape (128 blocks); at most one split
    per page; the ranges cover the table exactly, none empty."""
    splits, pps = aops.decode_splits(B, K, nblocks)
    assert splits == want
    assert (splits - 1) * pps < nblocks <= splits * pps


# ---------------------------------------------------------------------------
# K2: split-K plan and TF32 arithmetic
# ---------------------------------------------------------------------------

MAXOUT = {"fwd": ("nn", 64, 1200, 784), "dgrad": ("nt", 64, 240, 1200),
          "wgrad": ("tn", 784, 1200, 64),
          "llama_chunk": ("nn", 128, 14336, 4096)}


@pytest.mark.parametrize("shape", [(64, 1200, 784), (64, 240, 1200),
                                   (784, 1200, 64), (128, 14336, 4096),
                                   (33, 7, 65), (100, 130, 70), (5, 3, 0),
                                   (1, 1, 4097)],
                         ids=["fwd", "dgrad", "wgrad", "llama_chunk",
                              "ragged", "odd", "empty_d", "deep"])
def test_k2_plan_covers_the_reduction(shape):
    R, C, D = shape
    bn, splits, per = mops.plan(R, C, D)
    ranges = [(s * per * mops.BK, min((s + 1) * per * mops.BK, D))
              for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(d0 < d1 for d0, d1 in ranges) or D == 0
    blocks = -(-R // mops.BM) * -(-C // bn) * splits
    if shape in ((64, 1200, 784), (64, 240, 1200)):
        assert blocks >= mops.SMS and splits > 1
    if shape in ((784, 1200, 64), (128, 14336, 4096)):
        assert splits == 1 and bn == 64


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                          # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0, -0.0, 2.0 ** -126])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0, 2.0 ** -126])
    assert torch.equal(mref.tf32_round(x), want)
    low = mref.tf32_round(torch.randn(1000)).view(torch.int32) & 0x1FFF
    assert not low.any()


@pytest.mark.parametrize("width", range(2, 13))
def test_rounded_operands_are_exact_in_tf32(width):
    """Every value m·2^e with qmin <= m <= qmax, at every e that keeps the
    grid in f32's normal range, is unchanged by TF32 rounding."""
    half = 2 ** (width - 1)
    m = torch.arange(-half, half, dtype=torch.float32)
    e = torch.arange(-126, 128 - width, dtype=torch.float32)
    x = m[:, None] * torch.exp2(e)[None, :]
    assert torch.isfinite(x).all()
    normal = (x.abs() >= 2.0 ** -126) | (x == 0)
    assert normal.sum() > 0.9 * x.numel()
    x = x[normal]
    assert torch.equal(mref.tf32_round(x), x)
    assert mref.is_split(width) is False
    for w in (None, 13, 16, 24):
        assert mref.is_split(w) is True


def test_hi_lo_split_is_within_2_to_the_minus_22():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(200_000, generator=g) \
        * torch.exp2(torch.randint(-110, 100, (200_000,), generator=g)
                     .to(torch.float32))
    hi, lo = mref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    back = hi.double() + lo.double() / mref.LO_SCALE
    rel = ((back - x.double()).abs() / x.double().abs()).max()
    assert rel <= 2.0 ** -22


@pytest.mark.parametrize("widths", [(None, 10), (None, None), (10, 10),
                                    (13, 16), (24, None), (None, 12)],
                         ids=["raw-q10", "raw-raw", "q10-q10", "q13-q16",
                              "q24-raw", "raw-q12"])
@pytest.mark.parametrize("shape", ["fwd", "dgrad", "wgrad"])
def test_tf32_route_matches_plain_at_maxout_shapes(shape, widths):
    kind, R, C, D = MAXOUT[shape]
    a = mcases.qmm_case(kind, R, C, D, width_a=widths[0], width_b=widths[1],
                        seed=2, device="cpu")
    kw = {k: a[k] for k in ("e_a", "e_b", "kind", "width_a", "width_b")}
    got = mref.qmatmul_tf32_emulated(a["a"], a["b"], **kw)
    want = mref.qmatmul_ref(a["a"], a["b"], **kw)
    torch.testing.assert_close(got, want, **mcases.tolerance(D))
    if widths == (10, 10):                    # both exact: one product
        assert mops.products(*widths) == 1
    assert mops.products(*widths) == 1 + sum(map(mref.is_split, widths))


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
def test_tf32_route_matches_the_reference(kind):
    """The emulated raw x rounded route against the JAX reference's qmm
    (interpret mode) on the same numpy operands."""
    rng = np.random.default_rng(11)
    R, C, D = 48, 40, 96
    a = rng.standard_normal((D, R) if kind == "tn" else (R, D)) \
        .astype(np.float32)
    b = rng.standard_normal((C, D) if kind == "nt" else (D, C)) \
        .astype(np.float32)
    want = j_qmm(jnp.asarray(a), jnp.asarray(b), jnp.float32(0.0),
                 jnp.float32(-7.0), kind=kind, width_a=None, width_b=10,
                 interpret=True)
    got = mref.qmatmul_tf32_emulated(torch.from_numpy(a), torch.from_numpy(b),
                                     0.0, -7.0, kind=kind, width_a=None,
                                     width_b=10)
    tol = mcases.tolerance(D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol["rtol"],
                               atol=tol["atol"])
