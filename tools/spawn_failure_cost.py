"""Wall seconds of the failing world that ``tests/test_torch_dist.py``
spawns for ``launch.mesh.spawn``'s report (``failing_world``, 3 gloo
ranks on the CPU, one torch thread a rank), from its start to the
``RuntimeError``.

    PYTHONPATH=src python tools/spawn_failure_cost.py [--repeat 3]

Prints one line a run and the last report.  Imports no JAX.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import _torch_dist_ranks as R  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    msg = None
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        try:
            M.spawn(R.failing_world, 3, threads=1, timeout_s=120.0)
        except RuntimeError as e:
            msg = str(e)
        print(f"failing world of 3: {time.perf_counter() - t0:.2f}s",
              flush=True)
    print(msg)


if __name__ == "__main__":
    main()
