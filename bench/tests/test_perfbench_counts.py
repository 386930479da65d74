"""The benchmark's own operation counts against the count of the program's
dry run (``repro_torch.launch.dryrun``: its ``OpCounter`` over one traced
step on the meta device), at the cells' shapes, every remainder named
(CPU only; the dry run is a cross-check, not the yardstick)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness import core  # noqa: E402
from harness.program import port_config  # noqa: E402

SPEC = core.load_spec(ROOT, pending=True)


def _dry_run_flops(mcfg, shape, policy, opt=None) -> float:
    from repro_torch.dist import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(1, 1)
    cell = dryrun.make_cell(mcfg, shape, policy, mesh, ShardingRules(mesh),
                            opt=opt)
    return dryrun.trace(cell)["flops"]


def test_granite_train_step_against_the_dry_run():
    """8 x 512: the dry run counts 1.30e13.  It multiplies every expert's
    whole capacity (``E * C`` rows, not the ``T * k`` routed), the full
    ``T x T`` scores and values (not the causal half), and no
    RMSNorm weight (the count's ``6 * params`` takes them as products)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.optim.opt import OptConfig
    cell = core.Cell(SPEC, "granite_train_dfxp", ROOT)
    model, t = cell.model(), cell.traffic
    S = model.sizes(cell.config)
    B, T = t["batch"], t["seq_len"]
    L, D, H, hd = (S["num_hidden_layers"], S["hidden_size"],
                   S["num_attention_heads"], S["head_dim"])
    E, k, F = (S["num_local_experts"], S["num_experts_per_tok"],
               S["intermediate_size"])
    cap = -(-B * T * k * S["capacity_factor"] // E)
    counted = _dry_run_flops(
        port_config(cell, False), ShapeSpec("card", T, B, "train"),
        PrecisionPolicy("dfxp", comp_width=10, update_width=12),
        OptConfig(kind="sgd", **t["optimizer"]))
    ours = model.train_flops(S, B, T)
    capacity = 6 * 3 * D * F * (E * cap - B * T * k) * L
    masked_half = 3 * 4 * B * H * hd * T * (T / 2) * L
    norms = 6 * (2 * L + 1) * D * B * T
    assert counted == pytest.approx(1.30e13, rel=5e-3)
    assert ours + capacity + masked_half - norms == pytest.approx(
        counted, rel=1e-9)


@pytest.mark.parametrize("kind,T,B", [("prefill", 512, 1),
                                      ("decode", 1024, 64)])
def test_mamba2_serving_against_the_dry_run(kind, T, B):
    """Prefill of a 512-token prompt and one decode step of 64 slots.  The
    dry run counts products only: the scan's state is read out and written
    in once a token (``4 H P N``, the count's convention takes ``8 H P
    N``), its ``C B^T`` per chunk is counted, and decode's state update is
    elementwise (only ``C h``, ``2 H P N``, is a product)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.policy import PrecisionPolicy
    cell = core.Cell(SPEC, "mamba2_serve_chat", ROOT)
    model = cell.model()
    S = model.sizes(cell.config)
    L, H, P, N, Q = (S["num_hidden_layers"], S["heads"], S["head_dim"],
                     S["state_size"], S["chunk_size"])
    counted = _dry_run_flops(port_config(cell, False),
                             ShapeSpec(kind, T, B, kind),
                             PrecisionPolicy("dfxp"))
    if kind == "prefill":
        ours = model.prefill_flops(S, T)
        remainder = (4 * H * P * N - 2 * Q * N) * T * L
    else:
        ours = B * model.decode_flops(S)
        remainder = 6 * H * P * N * B * L
    assert ours - remainder == pytest.approx(counted, rel=1e-9)
