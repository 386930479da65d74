"""The hand-written CUDA kernels K3-K6 against their plain versions, on the card.

Run on a machine with an H100 (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Each test builds the kernel (nvcc, at first use), runs it at the serving
slices' shapes, and holds it against the plain PyTorch version on the
same card tensors; the paged K5 is also held against K3 on the same data
laid out as a ring.  Tolerance: atol = rtol = 1e-4 on outputs of size
O(1..16) — both sides are f32, the kernel sums keys in 32-lane tiles
with an online softmax, the plain version in one einsum.  Without a card
every test skips (decided in a fixture, so all xdist workers collect the
same tests).
"""
import pytest
import torch

from repro_torch.core.quant import exact_pow2
from repro_torch.kernels.attn import cases, ops, ref

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


@pytest.mark.parametrize("width", WIDTHS, ids=WIDTH_IDS)
def test_flash_decode_paged_matches_k3_on_the_same_data(cuda, width):
    """The block tables' pages gathered into a ring, with one exponent
    per slot: K5 on the arena and K3 on the ring walk the same tiles in
    the same order, so they agree to the tolerance (and, as the card run
    records, exactly)."""
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
