"""One run of one benchmark cell on the card:

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, sets up and warms up the
program (``repro_torch``), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s``), with ``--trace 1`` a ``breakdown``, and last ``checks``:
each compared number with its limit.  It needs a CUDA card and never
falls back to the CPU; it refuses to print a result if the process
loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi: not found"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return r.stdout.strip() or r.stderr.strip()


def _host_line() -> str:
    """The host's load, its cores' clocks and the seconds a fixed piece of
    pure-Python work takes: what a host-bound run's rate leans on."""
    t0 = time.perf_counter()
    x = 0
    for i in range(2_000_000):
        x += i & 7
    spin = time.perf_counter() - t0
    try:
        with open("/proc/loadavg") as f:
            load = f.read().split()[0]
        with open("/proc/cpuinfo") as f:
            mhz = [float(ln.split(":")[1]) for ln in f
                   if ln.startswith("cpu MHz")]
        mean = sum(mhz) / len(mhz) if mhz else float("nan")
    except OSError:
        load, mean = "?", float("nan")
    return (f"load {load}, {os.cpu_count()} cpus at {mean:.0f} MHz, "
            f"spin {spin:.4f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the program keeps lives at a fixed path in the checkout
    cache = BENCH / "cache"
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cache / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import core

    cell = core.Cell(core.load_spec(ROOT), args.workload, ROOT)
    import torch
    # one host thread for the process's own CPU operations: the steps are
    # host-bound, and a pool spread over a shared host's cores waits on
    # its slowest core
    torch.set_num_threads(1)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {_card_line()}", file=sys.stderr, flush=True)
    print(f"host at start: {_host_line()}", file=sys.stderr, flush=True)
    run = cell.driver().run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda",
                            t_start=T_START)
    print(f"host at end: {_host_line()}", file=sys.stderr, flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"error: the process loaded {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if args.trace:
        traced = run["traced"]
        metrics = core.read_per_layer(cell, run)
        device.update(busy_s=traced.busy_s, window_s=traced.window_s)
        print(f"info traced: device pass {traced.window_s} s, busy "
              f"{traced.busy_s} s; host pass {traced.host_window_s} s; "
              f"window {run['seconds']} s over {len(run['step_ms'])} "
              "steps", file=sys.stderr)
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = run["setup_s"] if m["name"] == "setup_s" \
                else run["e2e"][m["name"]]
            metrics[m["name"]] = core.metric(value, m["unit"])
    for k, v in run["info"].items():
        print(f"info {k}: {v}", file=sys.stderr)
    if run.get("step_ms"):
        q = [core.percentile(run["step_ms"], p) for p in (5, 25, 50, 75, 95)]
        print(f"info step_ms p5/25/50/75/95: {q}", file=sys.stderr)
    if run.get("ttft_ms"):
        print(f"info ttft_ms: median {core.percentile(run['ttft_ms'], 50)} "
              f"p95 {core.percentile(run['ttft_ms'], 95)} "
              f"n {len(run['ttft_ms'])}", file=sys.stderr)
    result = {"correct": core.checks_pass(run["checks"]),
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": device}
    if args.trace and run["traced"].breakdown():
        result["breakdown"] = run["traced"].breakdown()
    core.emit(result, run["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
