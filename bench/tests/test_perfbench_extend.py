"""The harness is driven by data: in a copy of the benchmark, a new mix, a
new per-layer metric and a new cell are added as new files and entries,
and the harness lists and runs them, with no file of it edited (CPU
only)."""
import hashlib
import json
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_added_as_files_run(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(ROOT / "src")
    before = _digests(root / "bench")

    # the new files: a mix, the cell's limits, a metric's reader
    mix = json.loads((root / "bench/traffic/train_zipf_8x512.json")
                     .read_text())
    mix.update(batch=4, seq_len=256, zipf_s=1.3,
               smoke={"batch": 4, "seq_len": 8, "calibrate_steps": 1})
    (root / "bench/traffic/train_zipf_tiny.json").write_text(json.dumps(mix))
    (root / "bench/limits/granite_train_tiny.json").write_text(json.dumps(
        json.loads((root / "bench/limits/granite_train_dfxp.json")
                   .read_text())))
    (root / "bench/metrics/steps_seen.train.py").write_text(
        "def read(run):\n"
        "    return float(len(run['outcomes'])) if run.get('outcomes') "
        "else None\n")
    # the new entries
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "granite_train_tiny",
                              "config": "granite_moe_1b",
                              "traffic": "train_zipf_tiny", "chips": 1,
                              "why": "a throwaway cell of the test"})
    spec["end_to_end"][0]["workloads"].append("granite_train_tiny")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "trainer", "moves":
                              "train_tokens_per_s",
                              "workloads": ["granite_train_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    sys.path[:0] = [str(root / "bench"), str(root / "src")]
    for name in [m for m in sys.modules if m == "harness"
                 or m.startswith("harness.")]:
        del sys.modules[name]
    try:
        from harness import core
        import torch
        torch.set_num_threads(2)
        listed = [w["name"] for w in core.load_spec(root)["workloads"]]
        assert "granite_train_tiny" in listed
        cell = core.Cell(core.load_spec(root), "granite_train_tiny", root)
        assert cell.traffic["zipf_s"] == 1.3
        assert [m["name"] for m in cell.end_to_end] == [
            "train_tokens_per_s", "setup_s"]
        run = cell.driver().run(cell, seed=11, seconds=0.3, trace=False,
                                device="cpu", t_start=time.perf_counter(),
                                smoke=True)
        assert core.checks_pass(run["checks"]), run["checks"]
        per_layer = core.read_per_layer(cell, run)
        assert per_layer["steps_seen.train"]["value"] == len(run["outcomes"])
        assert "mfu.train" not in per_layer     # nothing traced to read
    finally:
        sys.path[:2] = []
        for name in [m for m in sys.modules if m == "harness"
                     or m.startswith("harness.")]:
            del sys.modules[name]
    after = _digests(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before
