"""Each cell's run at smoke size on the CPU, past the harness's look for a
card: the program against the plain reference, the control, and the
timed path broken underneath (CPU only)."""
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness import core  # noqa: E402

SPEC = core.load_spec(ROOT, pending=True)   # the serving cell is pending
SEED = 2 ** 31 + 977        # past 32 signed bits, as the driver's are


def _cell(name):
    return core.Cell(SPEC, name, ROOT)


def _run(name, fault="", seed=SEED):
    import torch
    torch.set_num_threads(2)
    cell = _cell(name)
    return cell.driver().run(cell, seed=seed, seconds=3.0, trace=False,
                             device="cpu", t_start=time.perf_counter(),
                             smoke=True, fault=fault)


def _control():
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench_control",
                                                  BENCH / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["granite_train_dfxp", "mamba2_serve_chat"])
def test_program_equals_the_plain_reference_at_smoke_size(name):
    """On the CPU both sides run the same float32 operations, so every
    compared number is 0 and the run is correct."""
    run = _run(name)
    assert run["attempted"] > 0 and run["failed"] == 0
    assert all(c["value"] == 0.0 for c in run["checks"].values()), \
        run["checks"]
    assert core.checks_pass(run["checks"])
    assert all(v > 0 for v in run["e2e"].values())


@pytest.mark.parametrize("name,fault", [
    ("granite_train_dfxp", "frozen"),
    ("granite_train_dfxp", "half_batch"),
    ("mamba2_serve_chat", "token"),
    ("mamba2_serve_chat", "frozen_state"),
])
def test_a_broken_timed_path_is_not_correct(name, fault):
    run = _run(name, fault)
    assert not core.checks_pass(run["checks"]), run["checks"]


def test_the_training_controls_read_wide_of_the_sound_run():
    ctl = _control()
    out = ctl.train_readings(_cell("granite_train_dfxp"), SEED, "cpu",
                             smoke=True)
    for name in ("control_dfxp8", "fault_half_batch"):
        assert max(out[name][k] for k in ("loss_gap", "grad_norm_gap",
                                          "update_norm_gap")) > 0.01, out


def test_the_serving_control_reads_wide_of_the_sound_run():
    ctl = _control()
    out = ctl.serve_readings(_cell("mamba2_serve_chat"), SEED, "cpu",
                             smoke=True)
    assert out["control_dfxp8"]["logit_gap"] > 0, out


def test_the_closed_loop_keeps_every_seed_on_one_set_of_sizes():
    from harness import traffic as tr
    t = core.mix_params(_cell("mamba2_serve_chat"), smoke=False)
    a, b = tr.chat_plan(t, 1000, 1), tr.chat_plan(t, 1000, 2 ** 31 + 5)

    def sizes(plan, r):
        return (sorted(len(c[r]["prompt"]) for c in plan),
                sorted(c[r]["max_new"] for c in plan))

    for r in range(t["requests_per_client"]):
        assert sizes(a, r) == sizes(b, r)
    assert [len(r["prompt"]) for r in a[0]] != [len(r["prompt"]) for r in b[0]]


def test_the_idle_share_of_a_step_takes_the_untraced_step():
    """Busy 0.86 s a traced step against untraced steps of 1.075 s reads
    20% idle, whatever the traced steps' own (stretched) length."""
    reader = _cell("granite_train_dfxp").metric_reader("idle_share.train")

    class Traced:
        busy_s, window_s = 3 * 0.86, 3 * 1.25

    run = {"kind": "train", "traced": Traced(), "traced_steps": 3,
           "seconds": 43.0, "attempted": 40}
    assert abs(reader.read(run) - 20.0) < 1e-9
    assert reader.read(dict(run, traced_steps=0)) is None
