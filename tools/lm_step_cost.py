"""Wall ms and device operations of one LM_100M DFXP training step of the
port on one NVIDIA card, so that two trees of the port can be compared.

    python tools/lm_step_cost.py [--steps 20]

Run from the root of the tree to measure (it imports that tree's
``src``).  LM_100M (``examples/train_lm``: 12 layers, d_model 512, vocab
32768, tied) at batch 16 x 128, DFXP 10/12 with the fused matmul (K2)
and K1, adamw 3e-3, random weights from seed 0: the trainer CLI runs 3
steps (calibration, and every launch plan selected: a fresh plan cache
under a temporary directory), then the supervised step is called
``--steps`` times, each timed on the host clock up to a device
synchronize, and its device operations (kernels, copies, memsets) are
counted once with ``torch.profiler`` after a warm-up call.  Prints the
card's name and power limit first, then one JSON line.  Imports no JAX.
"""
import argparse
import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ARGV = ["--arch", "lm_100m", "--global-batch", "16", "--seq-len", "128",
        "--comp-width", "10", "--update-width", "12",
        "--update-interval", "20", "--optimizer", "adamw", "--lr", "3e-3",
        "--fused-matmul", "--device", "cuda", "--arithmetic", "dfxp",
        "--calibrate-steps", "2", "--steps", "3"]


def device_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # some profiler sessions record no device work
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if n:
            return n
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    tmp = tempfile.mkdtemp(prefix="lm_step_cost_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = f"{tmp}/autotune_torch.json"
    sys.path.insert(0, str(Path.cwd() / "src"))
    from repro_torch.core import prng
    from repro_torch.core.quant import enable_pallas_quantize
    from repro_torch.data import SyntheticLM
    from repro_torch.examples import train_lm
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.launch.train import build_policy
    from repro_torch.models import transformer as T
    from repro_torch.optim.opt import OptConfig
    from repro_torch.train import TrainSupervisor
    train_lm.register()
    cfg = train_lm.LM_100M
    enable_pallas_quantize(True)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            state = train.main(ARGV)
        ns = type("Args", (), dict(
            arithmetic="dfxp", comp_width=10, update_width=12,
            update_interval=20, storage="sim", max_overflow_rate=1e-4,
            fused_matmul=True))
        pol = build_policy(ns)
        data = SyntheticLM(cfg.vocab_size, 128, 16, seed=0)
        sup = TrainSupervisor(
            lambda p, b, s, e: T.loss_fn(cfg, pol, p, b, e, s),
            T.group_shapes(cfg), pol,
            OptConfig(kind="adamw", lr=3e-3, lr_decay_steps=1000), state,
            batch_fn=lambda c: {k: torch.from_numpy(v).cuda()
                                for k, v in data.batch(c).items()},
            rng=prng.PRNGKey(0, "cuda"))
        sup.cursor = 3
        for _ in range(2):
            sup.step_once()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            sup.step_once()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        ops = device_ops(sup.step_once)
    finally:
        enable_pallas_quantize(False)
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"ms_per_step_median": statistics.median(ms),
           "ms_per_step_mean": statistics.fmean(ms),
           "ms_per_step_min": min(ms), "steps": len(ms),
           "device_ops_per_step": ops,
           "plan_cache": hasattr(dispatch, "autotune_cache")}
    if out["plan_cache"]:
        out["plans_measured"] = len(dispatch.autotune_records())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
