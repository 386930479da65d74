"""Device time of the quantized matmul kernel K2 under other tile and
split-K plans than ``qmatmul.ops.plan`` picks, on one NVIDIA card.

    PYTHONPATH=src python tools/qmm_plan_sweep.py

For the training path's products (the maxout forward, dgrad and wgrad)
and the llama3-8B chunk product, each plan ``(bn, splits, per)`` is
launched through the kernel library's C entry point on a ring of seeded
operands larger than the L2, checked against the plain version within
``cases.tolerance``, and timed with ``torch.profiler``: the split pass
(``main``) and the reduction of the splits (``reduce``), device time per
call over 20 calls.  The plan that ``ops.plan`` picks is marked.  The
card's name and power limit come first.  Imports no JAX.
"""
import ctypes
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels.qmatmul import cases as mc
from repro_torch.kernels.qmatmul import ops as k2
from repro_torch.kernels.qmatmul.ref import qmatmul_ref

SHAPES = {"fwd": ("nn", 64, 1200, 784, None, 10),
          "dgrad": ("nt", 64, 240, 1200, None, 10),
          "wgrad": ("tn", 784, 1200, 64, None, None),
          "llama_chunk": ("nn", 128, 14336, 4096, None, 10)}
PLANS = {"fwd": [(64, 1, 25), (64, 3, 9), (64, 5, 5), (64, 7, 4), (64, 9, 3),
                 (64, 13, 2), (32, 3, 9), (32, 4, 7), (32, 5, 5), (32, 7, 4),
                 (32, 9, 3), (32, 13, 2)],
         "dgrad": [(32, 1, 38), (32, 4, 10), (32, 8, 5), (32, 10, 4),
                   (32, 13, 3), (32, 19, 2), (32, 38, 1), (64, 8, 5),
                   (64, 13, 3), (64, 19, 2)],
         "wgrad": [(64, 1, 2), (32, 1, 2), (64, 2, 1), (32, 2, 1)],
         "llama_chunk": [(64, 1, 128), (32, 1, 128)]}


def launch(a: dict, bn: int, splits: int, per: int) -> torch.Tensor:
    """One K2 call under the given plan (the wrapper's work, by hand)."""
    R, C, D = k2.shapes(a["kind"], a["a"].shape, a["b"].shape)
    dev = a["a"].device
    steps = torch.stack([*k2._steps(a["e_a"], a["width_a"], dev),
                         *k2._steps(a["e_b"], a["width_b"], dev)])
    c = torch.empty((R, C), device=dev)
    ws = torch.empty((splits, R, C), device=dev) if splits > 1 else None
    rc = build.library("qmatmul").qmatmul_launch(
        ctypes.c_void_p(a["a"].data_ptr()), ctypes.c_void_p(a["b"].data_ptr()),
        ctypes.c_void_p(steps.data_ptr()), ctypes.c_void_p(c.data_ptr()),
        ctypes.c_void_p(None if ws is None else ws.data_ptr()), R, C, D,
        k2._KIND[a["kind"]], int(a["width_a"] or 0), int(a["width_b"] or 0),
        bn, splits, per,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"qmm launch failed: CUDA error {rc}")
    return c


def device_us(fn, n_iter: int = 20) -> dict:
    """Device µs per call of ``fn`` by K2 kernel (main / reduce)."""
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
        if us > 0 and "qmm_kernel" in evt.key:
            k = "reduce" if "reduce" in evt.key else "main"
            out[k] = out.get(k, 0.0) + us / n_iter
    return out


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name, (kind, R, C, D, wa, wb) in SHAPES.items():
        n = 2 if name == "llama_chunk" else 24
        copies = [mc.qmm_case(kind, R, C, D, width_a=wa, width_b=wb, seed=s,
                              device="cuda") for s in range(n)]
        a0 = copies[0]
        want = qmatmul_ref(a0["a"], a0["b"], a0["e_a"], a0["e_b"], kind=kind,
                           width_a=wa, width_b=wb)
        picked = k2.plan(R, C, D)
        for bn, splits, per in PLANS[name]:
            ok = torch.allclose(launch(a0, bn, splits, per), want,
                                **mc.tolerance(D))
            it = iter(range(1 << 30))
            t = device_us(lambda: launch(copies[next(it) % n], bn, splits,
                                         per))
            mark = "  <- ops.plan" if (bn, splits, per) == picked else ""
            print(f"{name} bn={bn} splits={splits} per={per} ok={ok} "
                  + " ".join(f"{k}={v:.2f}us" for k, v in t.items())
                  + f" total={sum(t.values()):.2f}us{mark}", flush=True)
            if not ok:
                raise SystemExit(f"{name} plan {(bn, splits, per)} disagrees "
                                 f"with the plain version")
        del copies


if __name__ == "__main__":
    main()
