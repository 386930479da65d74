"""``chip_smoke.py``'s resharded checkpoint job alone, on one NVIDIA card.

    python tools/ckpt_reshard.py [--layers 1]

Run from the root of the tree to measure.  granite-moe-1b at full width,
cut to ``--layers`` layers (random weights from seed 0, on the card), is
saved whole by this process (``chip_smoke._ckpt_save``); a world of two
gloo ranks restores it under the EP layout of ``ShardingRules`` on a 1 x
2 mesh, holds every leaf to ``shard_local`` of the whole tree and saves
its shards back (``chip_smoke._shard_rank``'s ``ckpt`` job); this process
then compares the two saves byte for byte (``chip_smoke._ckpt_check``).
Prints the card's name and power limit, the job's lines and seconds, and
exits 1 on any difference.  Imports no JAX.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=C.CKPT_LAYERS)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(configs.get("granite_moe_1b"),
                              num_layers=args.layers)
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    job = C._ckpt_save(cfg, params)
    t0 = time.perf_counter()
    ranks = M.spawn(C._shard_rank, C.WORLD, [("ckpt", job)],
                    backend="gloo", timeout_s=300.0, threads=4)
    world_s = time.perf_counter() - t0
    bad = C._ckpt_check(job, [r["ckpt"] for r in ranks])
    print(f"world of {C.WORLD} ranks (their start included): "
          f"{world_s:.2f}s; faults: {bad}", flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
