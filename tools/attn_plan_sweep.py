"""Device time of the attention kernels K3 (flash-decode), K4
(flash-prefill) and K6 (paged flash-prefill) under other plans than
``attn.ops.ring_splits``, ``attn.ops.prefill_plan`` and
``attn.ops.prefill_paged_plan`` pick, on one NVIDIA card.

    PYTHONPATH=src python tools/attn_plan_sweep.py

At the serving slices' shapes (K3: B=4 slots, W=400, K=8, G=4, hd=128;
K4: B=1, C=128 at p0=256, W=400; K6: B=1, C=64 at p0=384 over 8 pages of
64 rows), int8 and f32 pools, each plan is launched through the
wrappers' launchers (``launch_decode``, ``launch_prefill``,
``launch_prefill_paged``) on a ring of seeded inputs larger than the L2,
checked against the plain version (atol = rtol = 1e-4), and timed with
``torch.profiler``: the split pass (``main``) and the merge of the splits
(``combine``), device time per call over 20 calls.  The plan the wrapper
picks is marked.  The card's name and power limit come first.  Imports no
JAX.
"""
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.attn import cases, ops, ref

B, W, K, G, HD, C = 4, 400, 8, 4, 128, 128
DECODE_PLANS = [(1, 13), (2, 7), (3, 5), (4, 4), (5, 3), (7, 2), (13, 1)]
# (warps, splits): each block's visible tiles (8 ring, 1-4 own) in S even
# parts; 8 warps (128-row blocks) is the instance hd = 128 has
PREFILL_PLANS = [(8, 1), (8, 2), (8, 3), (8, 4), (8, 6), (8, 8)]
# K6: 16 blocks a split; each block's list holds 12 history tiles (p0 =
# 384) and the chunk's 2
PAGE, NBLK, CP = 64, 8, 64
PAGED_PLANS = [(8, s) for s in range(1, 9)]


def device_us(fn, kernel: str, n_iter: int = 20) -> dict:
    """Device µs per call of ``fn`` by kernel (main / combine)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", 0)
        if us > 0 and kernel in evt.key:
            k = "combine" if "combine" in evt.key else "main"
            out[k] = out.get(k, 0.0) + us / n_iter
    return out


def sweep(name, kernel, launch, plain, copies, plans, picked):
    a0 = copies[0]
    want = plain(a0)
    n = len(copies)
    for plan in plans:
        ok = torch.allclose(launch(a0, plan), want, atol=1e-4, rtol=1e-4)
        same = torch.equal(launch(a0, plan), launch(a0, plan))
        it = iter(range(1 << 30))
        t = device_us(lambda: launch(copies[next(it) % n], plan), kernel)
        mark = "  <- picked" if tuple(plan) == tuple(picked) else ""
        print(f"{name} plan={plan} ok={ok} same_bits={same} "
              + " ".join(f"{k}={v:.2f}us" for k, v in t.items())
              + f" total={sum(t.values()):.2f}us{mark}", flush=True)
        if not (ok and same):
            raise SystemExit(f"{name} plan {plan} disagrees with the plain "
                             f"version or with itself")


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")

    def steps(a, n):
        return ops._steps(n, a["k_exp"], a["v_exp"], a["width"], dev)

    for width, tag in ((8, "int8"), (None, "f32")):
        copies = [cases.decode_case(B, W, K, G, HD, width, seed=s,
                                    device=dev) for s in range(24)]
        for a in copies:
            a["steps"] = steps(a, B)
        sweep(f"K3 {tag}", "flash_decode_kernel",
              lambda a, plan: ops.launch_decode(
                  a["q"], a["k"], a["v"], a["pos"], a["q_pos"], a["steps"],
                  width=a["width"], scale=a["scale"], window=a["window"],
                  causal=True, plan=plan),
              lambda a: ref.decode_attention_ref(
                  a["q"], a["k"], a["v"], a["pos"], a["q_pos"],
                  k_exp=a["k_exp"], v_exp=a["v_exp"], width=a["width"],
                  scale=a["scale"], window=a["window"]),
              copies, DECODE_PLANS, ops.ring_splits(B, K, W))
        del copies
        copies = [cases.prefill_case(1, C, W, K, G, HD, width, p0=[256],
                                     n_valid=[C], seed=s, device=dev)
                  for s in range(24)]
        for a in copies:
            a["steps"] = steps(a, 1)
        sweep(f"K4 {tag}", "flash_prefill_kernel",
              lambda a, plan: ops.launch_prefill(
                  a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["pos"],
                  a["p0"], a["n_valid"], a["steps"], width=a["width"],
                  scale=a["scale"], window=a["window"], causal=True,
                  plan=plan),
              lambda a: ref.prefill_attention_ref(
                  a["q"], a["k"], a["v"], a["pos"], a["k_new"], a["v_new"],
                  a["p0"], a["n_valid"], k_exp=a["k_exp"], v_exp=a["v_exp"],
                  width=a["width"], scale=a["scale"], window=a["window"]),
              copies, PREFILL_PLANS, ops.prefill_plan(1, C, W, K, G, HD))
        del copies
        copies = [cases.prefill_paged_case(1, CP, PAGE, NBLK, K, G, HD,
                                           width, p0=[384], n_valid=[CP],
                                           seed=s, device=dev)
                  for s in range(24)]
        for a in copies:
            a["steps"] = steps(a, a["k"].shape[0])
        sweep(f"K6 {tag}", "flash_prefill_paged_kernel",
              lambda a, plan: ops.launch_prefill_paged(
                  a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
                  a["pos"], a["p0"], a["n_valid"], a["steps"],
                  width=a["width"], scale=a["scale"], window=a["window"],
                  causal=True, plan=plan),
              lambda a: ref.paged_prefill_attention_ref(
                  a["q"], a["k"], a["v"], a["bt"], a["pos"], a["k_new"],
                  a["v_new"], a["p0"], a["n_valid"], k_exp=a["k_exp"],
                  v_exp=a["v_exp"], width=a["width"], scale=a["scale"],
                  window=a["window"]),
              copies, PAGED_PLANS,
              ops.prefill_paged_plan(1, CP, NBLK, PAGE, K, G, HD))
        del copies


if __name__ == "__main__":
    main()
