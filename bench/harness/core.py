"""The harness's general part: finding a cell's files by name, the result
line, the device record and the check that the program loaded no JAX.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

* the configuration's ``file`` (``configs/<name>.json``) and, beside it,
  ``configs/<name>.py``: the weight maker, the plain reference and the
  work counts of that model;
* the traffic mix ``traffic/<traffic>.json``: parameters only, read by the
  general generators of :mod:`harness.traffic` and by the driver that its
  ``"driver"`` key names (``drivers/<driver>.py``);
* each per-layer metric ``metrics/<metric name>.py``: a ``read(run)`` that
  returns a number or ``None`` when the run holds nothing to read.

So a later change adds a cell, a mix, a configuration or a metric by
adding files and entries, and edits none of these.  A cell held back
from ``BENCHMARK.json`` keeps its entries in ``pending/<cell>.json``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# whole top-level module names the measured process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT, pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, also the entries of each
    ``bench/pending/<cell>.json``: a cell whose files are all here but
    that ``BENCHMARK.json`` does not list yet (the file says why).  Only
    the tests read those."""
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    if pending:
        for path in sorted((root / "bench" / "pending").glob("*.json")):
            with open(path) as f:
                more = json.load(f)
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                spec[key] = spec[key] + more.get(key, [])
    return spec


def _module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One ``workloads`` entry with its configuration, mix and metrics."""

    def __init__(self, spec: dict, workload: str, root: Path = ROOT):
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                           f"{sorted(by_name)}")
        self.root = root
        self.bench = root / "bench"
        self.workload = by_name[workload]
        self.name = workload
        cfgs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        with open(root / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(self.bench / "traffic" / f"{self.workload['traffic']}.json") as f:
            self.traffic = json.load(f)
        with open(self.bench / "limits" / f"{workload}.json") as f:
            self.limits = json.load(f)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in spec["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return any(m["name"] == metric["moves"] for m in self.end_to_end)

    def model(self):
        """The configuration's module (weight maker, reference, counts)."""
        path = (self.root / self.config_entry["file"]).with_suffix(".py")
        return _module(path, f"bench_config_{self.config_entry['name']}")

    def driver(self):
        kind = self.traffic["driver"]
        return _module(self.bench / "drivers" / f"{kind}.py",
                       f"bench_driver_{kind}")

    def metric_reader(self, name: str):
        return _module(self.bench / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}")


def forbidden_modules() -> List[str]:
    """Modules in this process whose whole top-level name is forbidden
    (``repro_torch`` passes: its top-level name is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def percentile(values: List[float], q: float) -> float:
    """Exact percentile by linear interpolation between order statistics
    (numpy's default rule), from the samples themselves."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def checks_pass(checks: Dict[str, dict]) -> bool:
    """Every compared number is finite and within its limit."""
    return all(finite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def emit(result: dict, checks: Dict[str, dict], out=None) -> None:
    """The checks as the last lines on standard error, then the result
    as the last line on standard output, its ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), file=out or sys.stdout, flush=True)


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def read_per_layer(cell: Cell, run) -> Dict[str, dict]:
    """Each per-layer metric's reader over the run; a reader that finds
    nothing returns ``None`` and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = metric(value, m["unit"])
    return out


def mix_params(cell: "Cell", smoke: bool) -> dict:
    """The mix's parameters (its ``smoke`` sizes over them for the CPU)."""
    t = dict(cell.traffic)
    if smoke:
        t.update(t.get("smoke", {}))
    return t
