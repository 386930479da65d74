"""The hand-written CUDA kernels K3/K4 against their plain versions, on the card.

Run on a machine with an H100 (no JAX needed there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Each test builds the kernel (nvcc, at first use), runs it at the serving
slice's shapes, and holds it against the plain PyTorch version on the
same card tensors.  Tolerance: atol = rtol = 1e-4 on outputs of size
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
