"""Device time of whole calls of K1 (fused quantize) and K6 (paged
flash-prefill) against their kernels alone, on one NVIDIA card.

    PYTHONPATH=src python tools/call_probe.py

For each case, through the public wrappers only (``dfxp.ops.dfxp_quantize``,
``attn.ops.flash_prefill_paged``, so it also runs on an older tree of the
port): the device time per call of the kernel's own launches
(``kernel_us``) and of every device operation the call puts on the
stream (``call_us``: the wrapper's small kernels, copies and memsets
too), from ``torch.profiler`` over 20 calls on a ring of 24 seeded
inputs past the L2, and the number of device operations of one call
(``ops``).  K1 also times ``torch.fake_quantize_per_tensor_affine``, the
same rounding without the counts, as ``library_us``.  The card's name and
power limit come first.  Imports no JAX.
"""
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.attn import cases as acases
from repro_torch.kernels.attn import ops as aops
from repro_torch.kernels.dfxp import cases as qcases
from repro_torch.kernels.dfxp import ops as k1


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profiled(fn, n_iter: int = 20):
    """(the device events of ``n_iter`` calls of ``fn`` by name, after a
    warm-up call, and ``n_iter``)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):         # some sessions record no device activity
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_iter):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if _on_device(e)]
        if evts:
            return evts, n_iter
    raise SystemExit("the profiler recorded no device activity")


def row(name, kernel, fn, copies, library=None) -> dict:
    it = iter(range(1 << 30))

    def call(f=fn):
        return f(copies[next(it) % len(copies)])
    evts, n = profiled(call)
    out = {"kernel_us": sum(_us(e) for e in evts if kernel in e.key) / n,
           "call_us": sum(_us(e) for e in evts) / n,
           "ops": sum(e.count for e in evts) / n}
    if library is not None:
        evts, n = profiled(lambda: call(library))
        out["library_us"] = sum(_us(e) for e in evts) / n
    print(f"{name}: {json.dumps(out)}", flush=True)
    return out


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")

    def quantize(a):
        return k1.dfxp_quantize(a["x"], a["e"], width=a["width"])

    def fake_quantize(a):
        q = 2 ** (a["width"] - 1)
        return torch.fake_quantize_per_tensor_affine(
            a["x"], 2.0 ** a["e"], 0, -q, q - 1)

    for tag, shape, kw, n in (
            ("K1 maxout_w_fc0 f32", (784, 1200), dict(e=-11.0, scale=0.05),
             24),
            ("K1 maxout_pre f32", (64, 1200), dict(), 24),
            ("K1 llama3_8b_w_up f32", (4096, 14336),
             dict(e=-12.0, scale=0.02), 2)):
        copies = [qcases.quantize_case(shape, seed=s, device=dev, **kw)
                  for s in range(n)]
        row(f"{tag} {shape}", "dfxp_quantize_kernel", quantize, copies,
            fake_quantize)
        del copies

    def paged(a):
        return aops.flash_prefill_paged(
            a["q"], a["k_new"], a["v_new"], a["k"], a["v"], a["bt"],
            a["pos"], a["p0"], a["n_valid"], a["k_exp"], a["v_exp"],
            width=a["width"], scale=a["scale"], window=a["window"])

    for width, tag in ((8, "int8"), (None, "f32")):
        copies = [acases.prefill_paged_case(1, 64, 64, 8, 8, 4, 128, width,
                                            p0=[384], n_valid=[64], seed=s,
                                            device=dev) for s in range(24)]
        row(f"K6 {tag} (B=1, C=64, p0=384, P=64, nblocks=8)",
            "flash_prefill_paged_kernel", paged, copies)
        del copies


if __name__ == "__main__":
    main()
