"""Where the flash-prefill kernel K4 spends its time, on one NVIDIA card:
device time of variants of its body (``prefill_common.cuh``, which K6
shares) with parts of the work cut out, at the serving slice's int8 shape (B=1, C=128, p0=256, W=400, K=8,
G=4, hd=128), one split (S=1) and the wrapper's four.

    PYTHONPATH=src python tools/k4_attribution.py

Variants (their results are wrong by design and are not checked):
``full`` the kernel as it is; ``no_pv`` without the p·v products;
``no_qk`` without the q·k products; ``no_mma`` without both;
``no_tiles`` without the tile loop (staging of the query rows, votes,
the first tile's copy and the output only).  Each variant is the header
with one loop bound edited, beside ``flash_prefill.cu`` as it is, built with ``nvcc`` into ``build/k4_variants/``
and timed through ``attn.ops.launch_prefill`` with ``torch.profiler``
(the split pass only, device time per call over 20 calls, on a ring of
24 inputs past the L2).  Imports no JAX.
"""
import ctypes
import subprocess
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels.attn import cases, ops

SRC = build.csrc("flash_prefill")
BODY = "prefill_common.cuh"
OUT = build.BUILD_DIR.parent / "k4_variants"
QK = "#pragma unroll 1\n  for (int d0 = 0; d0 < HD; d0 += 32) {"
PV = "#pragma unroll\n  for (int jg = 0; jg < DPL; ++jg) {"
LOOP = "  for (int i = 0; i < n_tiles; ++i) {"


def variants() -> dict:
    base = (SRC / BODY).read_text()
    for anchor in (QK, PV, LOOP):
        assert base.count(anchor) == 1, anchor
    no_qk = QK.replace("d0 < HD", "d0 < 0")
    no_pv = PV.replace("jg < DPL", "jg < 0")
    return {"full": base, "no_pv": base.replace(PV, no_pv),
            "no_qk": base.replace(QK, no_qk),
            "no_mma": base.replace(PV, no_pv).replace(QK, no_qk),
            "no_tiles": base.replace(LOOP, LOOP.replace("i < n_tiles",
                                                        "i < 0 * n_tiles"))}


def device_us(fn, n_iter: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and "flash_prefill_kernel" in e.key
               and "combine" not in e.key) / n_iter


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    procs = {}
    for name, text in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in SRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / BODY).write_text(text)
        (d / "flash_prefill.cu").write_text(
            (SRC / "flash_prefill.cu").read_text())
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(d / "lib.so"),
             str(d / "flash_prefill.cu")])
    for name, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed for variant {name}")
    dev = torch.device("cuda")
    copies = [cases.prefill_case(1, 128, 400, 8, 4, 128, 8, p0=[256],
                                 n_valid=[128], seed=s, device=dev)
              for s in range(24)]
    for a in copies:
        a["steps"] = ops._steps(1, a["k_exp"], a["v_exp"], 8, dev)
    _, fn_name, argtypes = build.SIGNATURES["flash_prefill"]
    keys = ("q", "k_new", "v_new", "k", "v", "pos", "p0", "n_valid", "steps")
    for name in procs:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        build._LOADED["flash_prefill"] = lib
        for splits in (1, 4):
            it = iter(range(1 << 30))
            t = device_us(lambda: ops.launch_prefill(
                *(copies[next(it) % 24][k] for k in keys), width=8,
                scale=128 ** -0.5, window=None, causal=True,
                plan=(8, splits)))
            print(f"K4 variant {name} S={splits} main={t:.2f}us", flush=True)
    build._LOADED.pop("flash_prefill")


if __name__ == "__main__":
    main()
