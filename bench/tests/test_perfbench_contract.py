"""``BENCHMARK.json`` against the benchmark's rules, every name's files
found, and the imports of the measured path (CPU only)."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness import core  # noqa: E402

SPEC = core.load_spec(ROOT)
# the committed cells alone, and with the pending ones that a later PR
# moves into BENCHMARK.json as they stand
SPECS = {"committed": SPEC, "with_pending": core.load_spec(ROOT, pending=True)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    script = SPEC["command"][1]
    assert any(script.startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("which", sorted(SPECS))
def test_names_units_and_keys(which):
    SPEC = SPECS[which]
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(("cell", w["name"]))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS and set(m) >= METRIC_KEYS - {"workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(("metric", m["name"]))
    for m in SPEC["per_layer"]:
        assert set(m) <= LAYER_KEYS and set(m) >= LAYER_KEYS - {"workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(("metric", m["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("which", sorted(SPECS))
def test_every_name_finds_its_files(which):
    SPEC = SPECS[which]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for w in SPEC["workloads"]:
        cell = core.Cell(SPEC, w["name"], ROOT)
        assert any(cell.config_entry["file"].startswith(p + "/")
                   for p in SPEC["paths"])
        assert cell.config["source"] == cell.config_entry["source"]
        assert cell.config["reduced"] == cell.config_entry["reduced"]
        assert callable(cell.model().make_weights)
        assert callable(cell.driver().run)
        assert set(cell.limits) >= {"logit_gap"} or set(cell.limits) >= {
            "loss_gap", "grad_norm_gap", "update_norm_gap"}
        for m in cell.per_layer:
            assert callable(cell.metric_reader(m["name"]).read)


@pytest.mark.parametrize("which", sorted(SPECS))
def test_each_cell_reports_what_its_metrics_move(which):
    SPEC = SPECS[which]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        cell = core.Cell(SPEC, w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [x["name"] for x in SPEC["workloads"]]):
            cells = e2e[m["moves"]].get("workloads")
            assert cells is None or w in cells, (m["name"], w)


@pytest.mark.parametrize("which", sorted(SPECS))
def test_layers_name_the_port_modules(which):
    SPEC = SPECS[which]
    layers = {m["layer"] for m in SPEC["per_layer"]}
    src = ROOT / "src" / "repro_torch"
    for layer in layers:
        for path in re.findall(r"[a-z_]+/[a-z_]+\.py", layer):
            assert (src / path).exists(), (layer, path)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_import_nothing_of_the_program():
    plain = [*(BENCH / "configs").glob("*.py"), *(BENCH / "metrics")
             .glob("*.py"), *(p for p in (BENCH / "harness").glob("*.py")
                              if p.name != "program.py")]
    assert plain
    for path in plain:
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
            path


def test_no_module_of_the_bench_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & set(core.FORBIDDEN), path


def test_the_measured_path_loads_no_jax(tmp_path):
    """Every cell's driver, pending ones too, at smoke size in a fresh
    interpreter that never saw ``PYTHONPATH=src`` (whose ``sitecustomize``
    would load JAX): the process ends holding no module whose whole
    top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
        "from harness import core\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "spec = core.load_spec(pending=True)\n"
        "for w in spec['workloads']:\n"
        "    cell = core.Cell(spec, w['name'])\n"
        "    cell.driver().run(cell, seed=3, seconds=0.5, trace=False,\n"
        "                      device='cpu', t_start=time.perf_counter(),\n"
        "                      smoke=True)\n"
        "print(json.dumps(core.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "autotune.json")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in core.forbidden_modules()


@pytest.mark.parametrize("name", ["run_seconds_budget"])
def test_a_full_check_fits_its_budget(name):
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_pending_cells_are_not_in_the_benchmark():
    """A pending file holds only entries that ``BENCHMARK.json`` lacks,
    and says why it waits."""
    committed = {(k, e["name"]) for k in ("configs", "workloads",
                                          "end_to_end", "per_layer")
                 for e in SPEC[k]}
    paths = sorted((BENCH / "pending").glob("*.json"))
    assert paths
    for path in paths:
        more = json.loads(path.read_text())
        assert _line(more["why_pending"])
        assert [w["name"] for w in more["workloads"]] == [path.stem]
        assert not {(k, e["name"]) for k in ("configs", "workloads",
                                             "end_to_end", "per_layer")
                    for e in more.get(k, [])} & committed
