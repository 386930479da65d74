"""The hand-written CUDA kernels K1-K6 against their plain versions, on the card.

Run on a machine with an H100 (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Each test builds the kernel (nvcc, at first use), runs it at the serving
and training slices' shapes, and holds it against the plain PyTorch
version on the same card tensors; the paged K5 is also held against K3 on
the same data laid out as a ring.  Tolerances: attention atol = rtol =
1e-4 on outputs of size O(1..16) — both sides are f32, the kernel sums
keys in 32-lane tiles with an online softmax, the plain version in one
einsum; K1 (fused quantize) bit-exact, values and both counts; K2
(quantized matmul) rtol = 1e-5, atol = 1e-5·sqrt(D) on unit-scale
operands, and its rounded operands bit-exact (a width-only product of
on-grid values).  Plan selection (``kernels.dispatch``): every candidate
plan of one K2, K3 and K4 key within the kernel's tolerance of the plain
version, and a measured entry saved, reloaded and used without timing
again, ``LAUNCHES`` unmoved by the measurement.  Without a card
every test skips (decided in a fixture, so all xdist workers collect the
same tests).
"""
import pytest
import torch

from repro_torch.core.quant import exact_pow2, fixed_round
from repro_torch.kernels import dispatch
from repro_torch.kernels.attn import cases, ops, ref
from repro_torch.kernels.dfxp import cases as qcases
from repro_torch.kernels.dfxp import ops as k1
from repro_torch.kernels.dfxp.ref import dfxp_quantize_ref
from repro_torch.kernels.qmatmul import cases as mcases
from repro_torch.kernels.qmatmul import ops as k2
from repro_torch.kernels.qmatmul.ref import qmatmul_ref, round_operand

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-4, rtol=1e-4)
B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128      # llama3-8B serving slice
P, NBLK, CP = 64, 8, 64                         # paged: page size, blocks,
#                                                 chunk (= page size)
WIDTHS = [8, 16, None]
WIDTH_IDS = ["int8", "int16", "f32"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: PYTHONPATH=src python -m pytest -m gpu "
                    "tests/test_torch_kernels.py on the H100")
    return torch.device("cuda")


def _decode_plain(a):
    return ref.decode_attention_ref(
        a["q"], a["k"], a["v"], a["pos"], a["q_pos"], k_exp=a["k_exp"],
        v_exp=a["v_exp"], width=a["width"], scale=a["scale"],
        window=a["window"])


def _prefill_plain(a):
    return ref.prefill_attention_ref(
        a["q"], a["k"], a["v"], a["pos"], a["k_new"], a["v_new"], a["p0"],
        a["n_valid"], k_exp=a["k_exp"], v_exp=a["v_exp"], width=a["width"],
        scale=a["scale"], window=a["window"])


def _decode(a):
    return ops.flash_decode(a["q"], a["k"], a["v"], a["pos"], a["q_pos"],
                            a["k_exp"], a["v_exp"], width=a["width"],
                            scale=a["scale"], window=a["window"])


def _prefill(a):
    return ops.flash_prefill(a["q"], a["k_new"], a["v_new"], a["k"], a["v"],
                             a["pos"], a["p0"], a["n_valid"], a["k_exp"],
                             a["v_exp"], width=a["width"], scale=a["scale"],
                             window=a["window"])


def test_exact_pow2_is_exact_on_the_card(cuda):
    e = torch.arange(-126, 128, dtype=torch.float32, device=cuda)
    bits = ((e.to(torch.int32) + 127) << 23).view(torch.float32)
    assert torch.equal(exact_pow2(e), bits)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("window", [None, 128], ids=["global", "window"])
def test_flash_decode_matches_plain(cuda, width, window):
    a = cases.decode_case(B, W, K, G, HD, width, window=window,
                          fill=[W, 3 * W // 2, 37, 1], seed=1, device=cuda)
    n = ops.LAUNCHES["flash_decode"]
    out = _decode(a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode"] == n + 1
    torch.testing.assert_close(out, _decode_plain(a), **TOL)


def test_flash_decode_ragged_and_empty(cuda):
    """W not a multiple of the tile, an empty slot, GQA 1x4 and 2x2."""
    for k, g in ((1, 4), (2, 2)):
        a = cases.decode_case(3, 37, k, g, 64, 8, fill=[0, 37, 20], seed=2,
                              device=cuda)
        out = _decode(a)
        torch.testing.assert_close(out, _decode_plain(a), **TOL)
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_matches_plain(cuda, width):
    a = cases.prefill_case(2, C, W, K, G, HD, width, p0=[256, 0],
                           n_valid=[100, C], seed=3, device=cuda)
    n = ops.LAUNCHES["flash_prefill"]
    out = _prefill(a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill"] == n + 1
    torch.testing.assert_close(out, _prefill_plain(a), **TOL)
    assert torch.all(out[0, 100:] == 0)


def test_flash_prefill_window_and_ragged_w(cuda):
    a = cases.prefill_case(2, 24, 37, 2, 2, 64, 8, p0=[50, 9],
                           n_valid=[24, 5], window=16, seed=4, device=cuda)
    torch.testing.assert_close(_prefill(a), _prefill_plain(a), **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_splits_and_same_bits(cuda, width):
    """The serving shape splits the ring (S = 5 of 3 tiles); a 40-key
    window at the slots' last position leaves the early splits with no
    key (m = -inf), and an empty slot gives 0; two calls give the same
    bits."""
    assert ops.ring_splits(B, K, W) == (5, 3)
    for window in (None, 40):
        a = cases.decode_case(B, W, K, G, HD, width, window=window,
                              fill=[W, 3 * W // 2, 37, 0], seed=16,
                              device=cuda)
        first, second = _decode(a), _decode(a)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(first, _decode_plain(a), **TOL)
        assert torch.isfinite(first).all() and torch.all(first[3] == 0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("hd", [40, 48, 72, 256])
def test_flash_decode_any_head_dim(cuda, hd, width):
    """Off-instance head dims and the largest, a ragged W, split."""
    a = cases.decode_case(3, 333, 2, 4, hd, width, window=200,
                          fill=[333, 400, 0], seed=17, device=cuda)
    assert ops.ring_splits(3, 2, 333)[0] > 1
    out = _decode(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _decode_plain(a), **TOL)
    assert torch.all(out[2] == 0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_splits_and_same_bits(cuda, width):
    """The table's chunk (B=1, C=128, p0=256) runs split over its tile
    list (prefill_plan); with a 64-key window the early history splits
    see nothing; two calls give the same bits."""
    assert ops.prefill_plan(1, C, W, K, G, HD)[1] > 1
    for window in (None, 64):
        a = cases.prefill_case(1, C, W, K, G, HD, width, p0=[256],
                               n_valid=[C], window=window, seed=18,
                               device=cuda)
        first, second = _prefill(a), _prefill(a)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        torch.testing.assert_close(first, _prefill_plain(a), **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("hd", [40, 48, 72, 256])
def test_flash_prefill_any_head_dim(cuda, hd, width):
    """Off-instance head dims and the largest (2-warp blocks), ragged W,
    a ragged chunk and a chunk at p0 = 0."""
    a = cases.prefill_case(2, 40, 75, 2, 3, hd, width, p0=[60, 0],
                           n_valid=[40, 23], seed=19, device=cuda)
    out = _prefill(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _prefill_plain(a), **TOL)
    assert torch.all(out[1, 23:] == 0)


def test_wrappers_check_their_inputs(cuda):
    a = cases.decode_case(1, 40, 2, 2, 32, 8, seed=5, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_decode(a["q"], a["k"].float(), a["v"], a["pos"],
                         a["q_pos"], a["k_exp"], a["v_exp"], width=8,
                         scale=1.0)
    with pytest.raises(ValueError):
        ops.flash_decode(a["q"].transpose(1, 2), a["k"], a["v"], a["pos"],
                         a["q_pos"], a["k_exp"], a["v_exp"], width=8,
                         scale=1.0)


def _decode_paged(a):
    return ops.flash_decode_paged(
        a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"], a["k_exp"],
        a["v_exp"], width=a["width"], scale=a["scale"], window=a["window"])


def _decode_paged_plain(a):
    return ref.paged_decode_attention_ref(
        a["q"], a["k"], a["v"], a["bt"], a["pos"], a["q_pos"],
        k_exp=a["k_exp"], v_exp=a["v_exp"], width=a["width"],
        scale=a["scale"], window=a["window"])


def _prefill_paged(a):
    return ops.flash_prefill_paged(
        a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"], a["pos"],
        a["p0"], a["n_valid"], a["k_exp"], a["v_exp"], width=a["width"],
        scale=a["scale"], window=a["window"])


def _prefill_paged_plain(a):
    return ref.paged_prefill_attention_ref(
        a["q"], a["k"], a["v"], a["bt"], a["pos"], a["k_new"], a["v_new"],
        a["p0"], a["n_valid"], k_exp=a["k_exp"], v_exp=a["v_exp"],
        width=a["width"], scale=a["scale"], window=a["window"])


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("window", [None, 128], ids=["global", "window"])
def test_flash_decode_paged_matches_plain(cuda, width, window):
    """Main shape; pages in random order, a page shared by two slots,
    null pages past each frontier, a ragged tail page, and a slot whose
    row maps only the null page (output 0, not NaN)."""
    a = cases.decode_paged_case(B, P, NBLK, K, G, HD, width,
                                fill=[NBLK * P, 257, 96, 0], window=window,
                                seed=6, device=cuda)
    n = ops.LAUNCHES["flash_decode_paged"]
    out = _decode_paged(a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode_paged"] == n + 1
    torch.testing.assert_close(out, _decode_paged_plain(a), **TOL)
    assert torch.all(out[3] == 0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_paged_matches_plain(cuda, width):
    """Main chunk (C = P = 64) at p0 = 384 and a ragged chunk at p0 = 64;
    rows past ``n_valid`` come out 0."""
    a = cases.prefill_paged_case(2, CP, P, NBLK, K, G, HD, width,
                                 p0=[384, 64], n_valid=[CP, 37], seed=7,
                                 device=cuda)
    n = ops.LAUNCHES["flash_prefill_paged"]
    out = _prefill_paged(a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_prefill_paged"] == n + 1
    torch.testing.assert_close(out, _prefill_paged_plain(a), **TOL)
    assert torch.all(out[1, 37:] == 0)


def test_flash_prefill_paged_window_and_small_heads(cuda):
    a = cases.prefill_paged_case(2, 24, 32, 5, 2, 2, 64, 8, p0=[100, 0],
                                 n_valid=[24, 5], window=40, seed=8,
                                 device=cuda)
    torch.testing.assert_close(_prefill_paged(a), _prefill_paged_plain(a),
                               **TOL)


@pytest.mark.parametrize("page", [32, 64])
@pytest.mark.parametrize("hd", [48, 128, 256])
@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_paged_head_dims_and_page_sizes(cuda, width, hd, page):
    """B = 2 with ragged n_valid over 512 logical rows: a prefix page
    shared by the two slots, null pages past slot 1's frontier, pages in
    random order; a 160-key window; hd 48 runs on the 64 instance, 256 on
    2-warp blocks."""
    a = cases.prefill_paged_case(2, CP, page, 512 // page, K, G, hd, width,
                                 p0=[384, 100], n_valid=[CP, 37],
                                 window=160, seed=31, device=cuda)
    assert int(a["bt"][0, 0]) == int(a["bt"][1, 0]) and (a["bt"][1] == 0).any()
    out = _prefill_paged(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _prefill_paged_plain(a), **TOL)
    assert torch.all(out[1, 37:] == 0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_paged_every_split_count(cuda, width):
    """The paged run's chunk (C = 64 at p0 = 384 over 8 pages) under every
    split count from 1 to the plan's: each holds the plain version, and
    each gives the same bits in two calls."""
    a = cases.prefill_paged_case(1, CP, P, NBLK, K, G, HD, width, p0=[384],
                                 n_valid=[CP], seed=32, device=cuda)
    warps, splits = ops.prefill_paged_plan(1, CP, NBLK, P, K, G, HD)
    assert splits > 1
    steps = ops._steps(a["k"].shape[0], a["k_exp"], a["v_exp"], width, cuda)
    want = _prefill_paged_plain(a)
    for s in range(1, splits + 1):
        def call():
            return ops.launch_prefill_paged(
                a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
                a["pos"], a["p0"], a["n_valid"], steps, width=width,
                scale=a["scale"], window=None, causal=True,
                plan=(warps, s))
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second), s
        torch.testing.assert_close(first, want, **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_paged_is_bit_identical_from_run_to_run(cuda, width):
    """Through the wrapper, with and without a window that drops the
    early pages from every block's list: two calls give the same bits."""
    for window in (None, 64):
        a = cases.prefill_paged_case(2, CP, P, NBLK, K, G, HD, width,
                                     p0=[384, 64], n_valid=[CP, 37],
                                     window=window, seed=33, device=cuda)
        n = ops.LAUNCHES["flash_prefill_paged"]
        first, second = _prefill_paged(a), _prefill_paged(a)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_prefill_paged"] == n + 2
        assert torch.equal(first, second)
        torch.testing.assert_close(first, _prefill_paged_plain(a), **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_prefill_paged_equals_k4_on_the_same_data(cuda, width):
    """A slot-major ring laid out as pages, one page per slot (P = W =
    384) with the slot's steps: K6 and K4 run one code on the same tiles,
    so under one plan (K6's; K4's wrapper takes its own from the dispatch
    cache) they give the same bits."""
    W_ = 384
    a = cases.prefill_case(2, CP, W_, K, G, HD, width, p0=[256, 100],
                           n_valid=[CP, 37], seed=34, device=cuda)
    out4 = ops.launch_prefill(
        a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["pos"], a["p0"],
        a["n_valid"], ops._steps(2, a["k_exp"], a["v_exp"], width, cuda),
        width=width, scale=a["scale"], window=a["window"], causal=True,
        plan=ops.prefill_paged_plan(2, CP, 1, W_, K, G, HD))
    zero = torch.zeros_like(a["k"][:1])
    e0 = torch.zeros(1, device=cuda)
    paged = dict(a, k=torch.cat([zero, a["k"]]), v=torch.cat([zero, a["v"]]),
                 bt=torch.tensor([[1], [2]], dtype=torch.int32, device=cuda),
                 k_exp=None if width is None else torch.cat([e0, a["k_exp"]]),
                 v_exp=None if width is None else torch.cat([e0, a["v_exp"]]))
    assert ops.prefill_paged_plan(2, CP, 1, W_, K, G, HD) == \
        ops.prefill_plan(2, CP, W_, K, G, HD)
    out6 = _prefill_paged(paged)
    torch.cuda.synchronize()
    assert torch.equal(out6, out4)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_paged_matches_k3_on_the_same_data(cuda, width):
    """The block tables' pages gathered into a ring, with one exponent
    per slot: K5 on the arena and K3 on the ring see the same keys, so
    they agree to the tolerance.  Not bit for bit: K5 splits the walk over
    the pages and merges the splits' softmax states, and sums each dot
    product in four chains; K3 walks all keys in one online softmax."""
    a = cases.decode_paged_case(B, P, NBLK, K, G, HD, width,
                                fill=[NBLK * P, 257, 96, 0], share=False,
                                seed=9, device=cuda)
    if width is not None:
        slot_e = torch.tensor([1 - width, 2 - width, 3 - width, -width],
                              dtype=torch.float32, device=cuda)
        for name in ("k_exp", "v_exp"):
            e = torch.zeros_like(a[name])
            for b in range(B):
                e[a["bt"][b].long()] = slot_e[b]
            e[0] = 0.0
            a[name] = e
    idx = a["bt"].long()
    ring = dict(q=a["q"], pos=a["pos"], q_pos=a["q_pos"], width=width,
                scale=a["scale"], window=None,
                k=a["k"][idx].reshape(B, NBLK * P, K, HD).contiguous(),
                v=a["v"][idx].reshape(B, NBLK * P, K, HD).contiguous(),
                k_exp=None if width is None else slot_e,
                v_exp=None if width is None else slot_e)
    out5, out3 = _decode_paged(a), _decode(ring)
    torch.cuda.synchronize()
    torch.testing.assert_close(out5, out3, **TOL)


def test_paged_wrappers_check_their_inputs(cuda):
    a = cases.decode_paged_case(1, 48, 2, 2, 2, 32, 8, fill=[60], seed=10,
                                device=cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        _decode_paged(a)
    a = cases.decode_paged_case(1, 32, 2, 2, 2, 32, 8, fill=[40], seed=10,
                                device=cuda)
    with pytest.raises(TypeError):
        ops.flash_decode_paged(a["q"], a["k"], a["v"], a["bt"].long(),
                               a["pos"], a["q_pos"], a["k_exp"], a["v_exp"],
                               width=8, scale=1.0)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_paged_is_bit_identical_from_run_to_run(cuda, width):
    """The serving shape splits the pages (S = 4) and merges the splits in
    a fixed order: two calls give the same bits."""
    a = cases.decode_paged_case(B, P, NBLK, K, G, HD, width,
                                fill=[NBLK * P, 257, 96, 0], seed=11,
                                device=cuda)
    assert ops.decode_splits(B, K, NBLK)[0] == 4
    first, second = _decode_paged(a), _decode_paged(a)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_paged_more_splits_than_live_pages(cuda, width):
    """One slot, two kv heads: one split per block-table entry (S = 8), of
    which the first two hold keys; the rest map the null page and must
    weigh nothing.  A second slot of one key only."""
    a = cases.decode_paged_case(2, P, NBLK, 2, G, HD, width,
                                fill=[P + 5, 1], seed=12, device=cuda)
    assert ops.decode_splits(2, 2, NBLK) == (NBLK, 1)
    n = ops.LAUNCHES["flash_decode_paged"]
    out = _decode_paged(a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode_paged"] == n + 1
    torch.testing.assert_close(out, _decode_paged_plain(a), **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_paged_window_masks_whole_splits(cuda, width):
    """A 40-key window at position 511: the first three of the four splits
    see no key (m = -inf), the last one sees 40; a slot whose window
    holds no key at all gives 0."""
    a = cases.decode_paged_case(B, P, NBLK, K, G, HD, width,
                                fill=[NBLK * P, NBLK * P, 300, 0],
                                window=40, seed=13, device=cuda)
    out = _decode_paged(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _decode_paged_plain(a), **TOL)
    assert torch.isfinite(out).all() and torch.all(out[3] == 0)


@pytest.mark.parametrize("hd", [32, 64, 96, 256])
def test_flash_decode_paged_other_head_dims(cuda, hd):
    a = cases.decode_paged_case(2, 32, 3, 2, 2, hd, 8, fill=[96, 40],
                                seed=14, device=cuda)
    torch.testing.assert_close(_decode_paged(a), _decode_paged_plain(a),
                               **TOL)


def test_flash_decode_paged_takes_head_dims_of_32s(cuda):
    """hd = 48 is not a multiple of 32: it runs on the hd = 64 instance
    with dims 48..63 zero, and matches plain."""
    a = cases.decode_paged_case(1, 32, 2, 2, 2, 48, 8, fill=[40], seed=10,
                                device=cuda)
    torch.testing.assert_close(_decode_paged(a), _decode_paged_plain(a),
                               **TOL)


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("hd", [40, 48, 72])
def test_flash_decode_paged_any_head_dim(cuda, hd, width):
    """Head dims off the 32·DPL instances (rows of 40, 48, 72 values:
    16-byte, 4-byte and value-at-a-time copies for int8), over split
    pages with a window that masks whole splits."""
    a = cases.decode_paged_case(B, P, NBLK, K, G, hd, width,
                                fill=[NBLK * P, 257, 96, 0], window=100,
                                seed=15, device=cuda)
    out = _decode_paged(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, _decode_paged_plain(a), **TOL)
    assert torch.all(out[3] == 0)


# ---------------------------------------------------------------------------
# K1: fused quantize (bit-exact)
# ---------------------------------------------------------------------------

def _k1_exact(a):
    n = k1.LAUNCHES["dfxp_quantize"]
    y, st = k1.dfxp_quantize(a["x"], a["e"], width=a["width"])
    torch.cuda.synchronize()
    assert k1.LAUNCHES["dfxp_quantize"] == n + 1
    yr, sr = dfxp_quantize_ref(a["x"], a["e"], width=a["width"])
    assert y.dtype == a["x"].dtype and y.shape == a["x"].shape
    assert torch.equal(torch.isnan(y), torch.isnan(yr))
    ok = ~torch.isnan(yr)
    assert torch.equal(y[ok], yr[ok])
    assert torch.equal(st, sr)
    return st


@pytest.mark.parametrize("shape", [(64, 1200), (784, 1200), (1000003,),
                                   (3, 7), (4, 33, 65)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("width", [8, 10, 12, 16])
def test_k1_matches_plain_bit_exact(cuda, shape, width):
    st = _k1_exact(qcases.quantize_case(shape, e=4.0 - width, width=width,
                                        seed=width, device=cuda))
    assert st[1] > 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["f16", "bf16"])
def test_k1_half_types_bit_exact(cuda, dtype):
    _k1_exact(qcases.quantize_case((64, 1200), dtype=dtype, e=-3.0,
                                   scale=10.0, seed=1, device=cuda))


@pytest.mark.parametrize("e", [-30.0, 30.0])
def test_k1_extreme_exponents_bit_exact(cuda, e):
    st = _k1_exact(qcases.quantize_case((32, 130), e=e,
                                        scale=2.0 ** (e + 8), seed=2,
                                        device=cuda))
    assert st[0] > 0


def test_k1_nan_inf_and_ties_bit_exact(cuda):
    a = qcases.quantize_case((17, 31), e=-2.0, seed=3, device=cuda,
                             specials=True)
    st = _k1_exact(a)
    y, _ = k1.dfxp_quantize(a["x"], a["e"], width=a["width"])
    assert int(torch.isnan(y).sum()) == 1 and st[0] >= 3


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [1000003, 4099, 8197])
def test_k1_misaligned_views_bit_exact(cuda, offset, n):
    """A contiguous view at an element offset that leaves x off 16-byte
    alignment (the scalar path over all of it), at lengths that are not a
    multiple of 4 or 8."""
    base = qcases.quantize_case((n + offset,), e=-6.0, width=10,
                                seed=offset, device=cuda)
    a = dict(base, x=base["x"][offset:])
    assert a["x"].is_contiguous() and a["x"].data_ptr() % 16 != 0
    st = _k1_exact(a)
    assert st[1] > 0


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["f16", "bf16"])
def test_k1_half_types_vectors_tails_and_views(cuda, dtype, offset):
    """f16 / bf16 with 8 values a vector: at offset 0 the vector path
    and a ragged tail of 5 (76,805 = 8 * 9,600 + 5), else the scalar
    path over a misaligned view."""
    base = qcases.quantize_case((76805 + offset,), dtype=dtype, e=-3.0,
                                scale=10.0, seed=4, device=cuda)
    _k1_exact(dict(base, x=base["x"][offset:]))


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, memsets) of one call of fn,
    from torch.profiler, after a warm-up call; a session that records no
    device activity is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if n > 0:
            break
    return n


def test_k1_one_call_is_at_most_two_device_operations(cuda):
    """One call puts K1 on the stream and nothing else around it: the
    exponent as a number (by value) or as a tensor on the card (read
    there)."""
    a = qcases.quantize_case((784, 1200), e=-11.0, scale=0.05, device=cuda)
    for e in (a["e"], torch.tensor(a["e"], device=cuda)):
        n = _device_ops(lambda: k1.dfxp_quantize(a["x"], e, width=10))
        assert 1 <= n <= 2, n


def test_k1_calls_on_two_streams_keep_their_own_counts(cuda):
    """Each stream has its own count words: calls queued on two streams
    at once, many times over, each give their own exact counts."""
    cases_ = [qcases.quantize_case((784, 1200), e=e, width=10, seed=i,
                                   device=cuda)
              for i, e in enumerate((-6.0, -9.0))]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, (a, s) in enumerate(zip(cases_, streams)):
            with torch.cuda.stream(s):
                outs[i].append(k1.dfxp_quantize(a["x"], a["e"], width=10))
    torch.cuda.synchronize()
    for a, got in zip(cases_, outs):
        yr, sr = dfxp_quantize_ref(a["x"], a["e"], width=10)
        for y, st in got:
            assert torch.equal(y, yr) and torch.equal(st, sr)


def test_fixed_round_routes_to_k1_on_the_card(cuda):
    from repro_torch.core.quant import enable_pallas_quantize
    x = qcases.quantize_case((64, 1200), device=cuda)["x"]
    want = fixed_round(x, 10, -6.0)
    n = k1.LAUNCHES["dfxp_quantize"]
    enable_pallas_quantize(True)
    try:
        got = fixed_round(x, 10, -6.0)
    finally:
        enable_pallas_quantize(False)
    assert k1.LAUNCHES["dfxp_quantize"] == n + 1
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


# ---------------------------------------------------------------------------
# K2: quantized matmul
# ---------------------------------------------------------------------------

def _k2_close(a):
    n = k2.launches()
    out = k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                 width_a=a["width_a"], width_b=a["width_b"])
    torch.cuda.synchronize()
    assert k2.launches() == n + 1
    want = qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                       width_a=a["width_a"], width_b=a["width_b"])
    _, _, D = k2.shapes(a["kind"], a["a"].shape, a["b"].shape)
    torch.testing.assert_close(out, want, **mcases.tolerance(D))
    return out


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("widths", [(10, 10), (None, 10), (10, None),
                                    (None, None)],
                         ids=["q-q", "raw-q", "q-raw", "raw-raw"])
def test_k2_layouts_and_widths_match_plain(cuda, kind, widths):
    _k2_close(mcases.qmm_case(kind, 100, 130, 70, width_a=widths[0],
                              width_b=widths[1], seed=4, device=cuda))


@pytest.mark.parametrize("kind,R,C,D", [("nn", 64, 1200, 784),
                                        ("nt", 64, 240, 1200),
                                        ("tn", 784, 1200, 64),
                                        ("nn", 33, 7, 65)],
                         ids=["fwd", "dgrad", "wgrad", "ragged"])
def test_k2_maxout_shapes_match_plain(cuda, kind, R, C, D):
    _k2_close(mcases.qmm_case(kind, R, C, D, seed=5, device=cuda))


def test_k2_on_grid_product_is_exact(cuda):
    """Both operands rounded at width 8 with matching steps: every product
    and partial sum is an integer multiple of 2**(e_a+e_b) below 2**24
    of them, so both sides are exact and equal bit for bit."""
    a = mcases.qmm_case("nn", 96, 80, 64, width_a=8, width_b=8, seed=6,
                        device=cuda)
    a["a"], a["b"] = a["a"] * 2.0 ** -3, a["b"] * 2.0 ** -3
    out = k2.qmm(a["a"], a["b"], -10.0, -10.0, kind="nn", width_a=8,
                 width_b=8)
    want = round_operand(a["a"], -10.0, 8) @ round_operand(a["b"], -10.0, 8)
    assert torch.equal(out, want)


@pytest.mark.parametrize("kind,R,C,D", [("nn", 64, 1200, 784),
                                        ("nt", 64, 240, 1200)],
                         ids=["fwd", "dgrad"])
def test_k2_split_k_is_bit_identical_from_run_to_run(cuda, kind, R, C, D):
    """The split partials are summed in split order by a second kernel:
    two calls give the same bits."""
    assert k2.plan(R, C, D)[1] > 1
    a = mcases.qmm_case(kind, R, C, D, seed=8, device=cuda)
    first, second = _k2_close(a), _k2_close(a)
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("width", [13, 16, 24, None],
                         ids=["w13", "w16", "w24", "raw"])
def test_k2_wide_and_raw_operands_match_plain(cuda, kind, width):
    """Widths past TF32's 11 bits go as hi + lo, three products with both
    operands split; the step 2^(3 - width) fills the grid's bits."""
    e = 0.0 if width is None else 3.0 - width
    _k2_close(mcases.qmm_case(kind, 100, 130, 70, width_a=width,
                              width_b=width, e_a=e, e_b=e, seed=9,
                              device=cuda))


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("width", [25, 31, 32])
def test_k2_widths_past_24_match_plain(cuda, kind, width):
    """Widths 25..32 (the paper's Fig. 3 computes at 31) go as hi + lo
    like any width past 12; from 25 on qmax = 2^(w-1) - 1 rounds to
    2^(w-1) in f32, as the reference's qrange does.  One operand at the
    step 2^(3 - w), one clipped (step 2^-28 at unit scale saturates the
    width-25 grid's 2^24 steps)."""
    _k2_close(mcases.qmm_case(kind, 100, 130, 70, width_a=width,
                              width_b=width, e_a=3.0 - width, e_b=-28.0,
                              seed=20, device=cuda))


def _k2_close_scaled(a, scale):
    """K2 against plain with the tolerance scaled to the product's size."""
    out = k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                 width_a=a["width_a"], width_b=a["width_b"])
    want = qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"], kind=a["kind"],
                       width_a=a["width_a"], width_b=a["width_b"])
    torch.cuda.synchronize()
    _, _, D = k2.shapes(a["kind"], a["a"].shape, a["b"].shape)
    tol = mcases.tolerance(D)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("e", [-30.0, 30.0])
def test_k2_extreme_exponents_match_plain(cuda, kind, e):
    """K1's extreme exponents: both operands on a width-10 grid of step
    2^e (one product), and a raw unit operand against one on that grid."""
    g = 2.0 ** (e + 7)                  # operand scale: mantissas ~2^7
    for wa, sa in ((10, g), (None, 1.0)):
        a = mcases.qmm_case(kind, 96, 80, 200, width_a=wa, width_b=10,
                            e_a=e, e_b=e, seed=10, device=cuda)
        a["a"], a["b"] = a["a"] * sa, a["b"] * g
        _k2_close_scaled(a, sa * g)


@pytest.mark.parametrize("kind", ["nn", "nt", "tn"])
@pytest.mark.parametrize("widths", [(None, 10), (None, None)],
                         ids=["raw-q10", "raw-raw"])
def test_k2_tiny_raw_operands_match_plain(cuda, kind, widths):
    """A raw operand scaled by 2^-120: its lo parts would be f32
    subnormals, which the tensor cores may flush; the kernel keeps them
    2^12 larger, so the result holds the tolerance scaled to 2^-120."""
    a = mcases.qmm_case(kind, 96, 80, 200, width_a=widths[0],
                        width_b=widths[1], seed=11, device=cuda)
    a["a"] = a["a"] * 2.0 ** -120
    _k2_close_scaled(a, 2.0 ** -120)


def test_fused_dot_grads_match_plain_on_the_card(cuda):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 37, 72, generator=g).to(cuda).requires_grad_(True)
    w = torch.randn(72, 56, generator=g).to(cuda).requires_grad_(True)
    r = torch.randn(3, 37, 56, generator=g).to(cuda)
    before = dict(k2.LAUNCHES)
    y = dispatch.fused_dot(x, w, -6.0, -6.0, width=10, grad_width=10,
                           e_g=-8.0)
    (y * r).sum().backward()
    torch.cuda.synchronize()
    assert {k: k2.LAUNCHES[k] - before[k] for k in before} == \
        {"qmm_nn": 1, "qmm_nt": 1, "qmm_tn": 1}
    xc, wc = x.detach().cpu().requires_grad_(True), \
        w.detach().cpu().requires_grad_(True)
    yc = dispatch.fused_dot(xc, wc, -6.0, -6.0, width=10, grad_width=10,
                            e_g=-8.0)
    (yc * r.cpu()).sum().backward()
    for got, want, D in ((y, yc, 72), (x.grad, xc.grad, 56),
                         (w.grad, wc.grad, 111)):
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   **mcases.tolerance(D))


def test_k2_wrapper_checks_its_inputs(cuda):
    a = torch.zeros(4, 5, device=cuda)
    with pytest.raises(TypeError):
        k2.qmm(a.double(), a.t().double(), 0.0, 0.0, kind="nn", width_a=10,
               width_b=10)
    with pytest.raises(ValueError, match="contiguous"):
        k2.qmm(a, torch.zeros(6, 5, device=cuda).t(), 0.0, 0.0, kind="nn",
               width_a=10, width_b=10)
    with pytest.raises(ValueError, match="widths"):
        k2.qmm(a, torch.zeros(5, 6, device=cuda), 0.0, 0.0, kind="nn",
               width_a=33, width_b=10)


# ---------------------------------------------------------------------------
# plan selection (kernels.dispatch): candidates, measurement, the cache
# ---------------------------------------------------------------------------

def _plan_case(kind, dev):
    """One key of each tuned kernel at a slice's shape: ``(case, fitted
    candidate plans, call under a plan, plain, tolerance)``."""
    if kind == "k2":                   # the maxout dgrad
        a = mcases.qmm_case("nt", 64, 240, 1200, width_b=10, seed=21,
                            device=dev)
        rule = k2.plan(64, 256, 2048)[:2]
        plans = {k2.fit_plan(1200, *p)
                 for p in dispatch.mm_candidates(rule, 64, 240)}
        return (a, plans,
                lambda p: k2.qmm(a["a"], a["b"], a["e_a"], a["e_b"],
                                 kind="nt", width_a=None, width_b=10,
                                 plan=p),
                lambda: qmatmul_ref(a["a"], a["b"], a["e_a"], a["e_b"],
                                    kind="nt", width_a=None, width_b=10),
                mcases.tolerance(1200))
    if kind == "k3":
        a = cases.decode_case(B, W, K, G, HD, 8, fill=[W, 3 * W // 2, 37, 1],
                              seed=22, device=dev)
        steps = ops._steps(B, a["k_exp"], a["v_exp"], 8, dev)
        plans = {ops.ring_plan(W, p[0])
                 for p in dispatch.attn_candidates((5,), W)}
        return (a, plans,
                lambda p: ops.launch_decode(
                    a["q"], a["k"], a["v"], a["pos"], a["q_pos"], steps,
                    width=8, scale=a["scale"], window=None, causal=True,
                    plan=p),
                lambda: _decode_plain(a), TOL)
    a = cases.prefill_case(1, C, W, K, G, HD, 8, p0=[256], n_valid=[C],
                           seed=23, device=dev)
    steps = ops._steps(1, a["k_exp"], a["v_exp"], 8, dev)
    plans = {ops.prefill_fit(1, C, W, p) for p in dispatch.prefill_candidates(
        ops.prefill_rule(8, C, G, HD))}
    return (a, plans,
            lambda p: ops.launch_prefill(
                a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["pos"],
                a["p0"], a["n_valid"], steps, width=8, scale=a["scale"],
                window=None, causal=True, plan=p),
            lambda: _prefill_plain(a), TOL)


@pytest.mark.parametrize("kind", ["k2", "k3", "k4"])
def test_every_candidate_plan_matches_plain(cuda, kind):
    """Every plan the measurement may pick at one key agrees with the
    plain version, and gives the same bits twice."""
    _, plans, call, plain, tol = _plan_case(kind, cuda)
    want = plain()
    assert len(plans) > 3
    for p in sorted(plans):
        out = call(p)
        torch.testing.assert_close(out, want, **tol, msg=f"plan {p}")
        assert torch.equal(out, call(p))


def _tuned_call(kind, a):
    if kind == "k2":
        return dispatch._qmm_auto(a["a"], a["b"], torch.tensor(
            a["e_a"], device=a["a"].device), torch.tensor(
            a["e_b"], device=a["a"].device), kind="nt", width_a=None,
            width_b=10)
    return (_decode if kind == "k3" else _prefill)(a)


def _launch_count(kind):
    return k2.launches() if kind == "k2" else sum(ops.LAUNCHES.values())


@pytest.mark.parametrize("kind", ["k2", "k3", "k4"])
def test_measured_plan_persists_and_is_reused(cuda, kind, tmp_path,
                                              monkeypatch):
    """The first call of a key times the candidates on its own inputs
    without moving ``LAUNCHES`` (the call itself counts once) and saves
    the winner; after save → reset → load the next call takes it without
    timing anything, and gives the first call's bits."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_torch.json"))
    saved = dict(dispatch._BLOCK_CACHE), set(dispatch._MEASURED), \
        dict(dispatch._RECORDS)
    dispatch.reset_autotune()
    try:
        a, plans, _, plain, tol = _plan_case(kind, cuda)
        n = _launch_count(kind)
        first = _tuned_call(kind, a)
        torch.cuda.synchronize()
        assert _launch_count(kind) == n + 1
        (key, rec), = dispatch.autotune_records().items()
        assert rec["device"] == torch.cuda.get_device_name()
        assert rec["us"] <= rec["rule_us"]
        torch.testing.assert_close(first, plain(), **tol)
        dispatch.reset_autotune()
        assert dispatch.load_autotune() == 1
        timed = []
        monkeypatch.setattr(dispatch, "_time_plan",
                            lambda run, p: timed.append(p) or 1.0)
        again = _tuned_call(kind, a)
        assert not timed and torch.equal(again, first)
        assert dispatch.autotune_cache()[key] == tuple(rec["plan"])
    finally:
        dispatch.reset_autotune()
        dispatch._BLOCK_CACHE.update(saved[0])
        dispatch._MEASURED.update(saved[1])
        dispatch._RECORDS.update(saved[2])
