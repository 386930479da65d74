"""Where the fused quantize kernel K1 spends its time, on one NVIDIA card:
device time of variants of ``dfxp_quantize.cu`` that end the call in other
ways, at the training path's shapes (784x1200 and 64x1200 f32) and
llama3-8B's ``w_up`` (4096x14336 f32).

    PYTHONPATH=src python tools/k1_attribution.py

Variants: ``full`` the kernel as it is (each block adds its counts and a
ticket to one 64-bit word per count; the last adder writes the total);
``no_counts`` without any count tail (each block ends after its data;
its counts are wrong by design and not checked), the least the data pass
takes; ``last_block`` per-block count slots, a fence and a ticket, the
last block summing the slots (an earlier build of K1); ``red_ticket`` the
counts added to two accumulators with atomics, a fence and a ticket, the
last block reading and clearing the accumulators; ``two_kernels`` the
counts added to the accumulators with atomics and a second one-thread
kernel that writes the f32 stats and clears them (two device operations
a call); ``unroll4`` the kernel with 4 vectors in flight per thread
instead of 2.  Each variant is built with ``nvcc`` into
``build/k1_variants/``, run through the wrapper
(``dfxp.ops.dfxp_quantize``), checked bit-exact against the plain version
(all but ``no_counts``), and timed with ``torch.profiler``: device time
per call of all its device operations over 20 calls on a ring of inputs
past the L2.  ``torch.fake_quantize_per_tensor_affine`` (the rounding
without the counts) is timed beside them.  The card's name and power
limit come first.  Imports no JAX.
"""
import ctypes
import json
import re
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build
from repro_torch.kernels.dfxp import cases as qcases
from repro_torch.kernels.dfxp import ops as k1
from repro_torch.kernels.dfxp.ref import dfxp_quantize_ref

SRC = build.csrc("dfxp_quantize") / "dfxp_quantize.cu"
OUT = build.BUILD_DIR.parent / "k1_variants"
# the count tail of the kernel: from its shared arrays to its closing brace
TAIL = re.compile(
    r"  __shared__ unsigned int part\[2\]\[kWarps\];\n.*?\n}\n", re.S)
KERNEL = "template <typename T>\n__global__"
BLOCK_SUM = """// Sum of v over the block, in thread 0 (every thread must call it).
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long v, unsigned long long* part) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) part[warp] = v;
  __syncthreads();
  unsigned long long s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += part[w];
  return s;
}

"""
SUMS = """  __shared__ unsigned long long part[kWarps];
  const unsigned long long a = block_sum(r.over, part);
  const unsigned long long b = block_sum(r.over_half, part);
"""
TAILS = {
    "no_counts": "  if (r.over == 12345u && r.over_half == 54321u) "
                 "stats[0] = 0.f;\n}\n",
    "last_block": SUMS + """  __shared__ bool last;
  if (threadIdx.x == 0) {
    acc[1 + 2 * blockIdx.x] = a;
    acc[2 + 2 * blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(&acc[0], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile unsigned long long* slots = acc + 1;
  unsigned long long sa = 0, sb = 0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads) {
    sa += slots[2 * i];
    sb += slots[2 * i + 1];
  }
  sa = block_sum(sa, part);
  sb = block_sum(sb, part);
  if (threadIdx.x == 0) {
    stats[0] = __ull2float_rn(sa);
    stats[1] = __ull2float_rn(sb);
    acc[0] = 0ull;
  }
}
""",
    "red_ticket": SUMS + """  if (threadIdx.x == 0) {
    if (a) atomicAdd(&acc[1], a);
    if (b) atomicAdd(&acc[2], b);
    __threadfence();
    if (atomicAdd(&acc[0], 1ull) == gridDim.x - 1) {
      __threadfence();
      stats[0] = __ull2float_rn(atomicExch(&acc[1], 0ull));
      stats[1] = __ull2float_rn(atomicExch(&acc[2], 0ull));
      acc[0] = 0ull;
    }
  }
}
""",
    "two_kernels": SUMS + """  if (threadIdx.x == 0) {
    if (a) atomicAdd(&acc[1], a);
    if (b) atomicAdd(&acc[2], b);
  }
}

__global__ void dfxp_quantize_kernel_finish(unsigned long long* acc,
                                            float* stats) {
  stats[0] = __ull2float_rn(acc[1]);
  stats[1] = __ull2float_rn(acc[2]);
  acc[1] = acc[2] = 0ull;
}
""",
}
# blocks a variant may have (one wave of the kernel on an H100): the
# last_block variant keeps a count slot per block
MAX_BLOCKS = 132 * 8
FINISH = """  return cudaGetLastError();
}

}  // namespace"""


def variants() -> dict:
    base = SRC.read_text()
    assert len(TAIL.findall(base)) == 1 and base.count(FINISH) == 1
    assert base.count(KERNEL) == 1
    out = {"full": base}
    for name, tail in TAILS.items():
        out[name] = TAIL.sub(lambda m: tail, base).replace(
            KERNEL, BLOCK_SUM + KERNEL)
    out["two_kernels"] = out["two_kernels"].replace(FINISH, """\
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dfxp_quantize_kernel_finish<<<1, 1, 0, stream>>>(
      reinterpret_cast<unsigned long long*>(acc), stats);
  return cudaGetLastError();
}

}  // namespace""")
    out["unroll4"] = base.replace("constexpr int kUnroll = 2;",
                                  "constexpr int kUnroll = 4;")
    assert out["unroll4"] != base
    return out


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
               if str(getattr(e, "device_type", "")).endswith("CUDA")) \
        / n_iter


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    procs = {}
    for name, text in variants().items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "dfxp_quantize.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(d / "lib.so"),
             str(d / "dfxp_quantize.cu")])
    for name, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed for variant {name}")
    dev = torch.device("cuda")
    shapes = {"784x1200": ((784, 1200), dict(e=-11.0, scale=0.05), 24),
              "64x1200": ((64, 1200), dict(), 24),
              "w_up": ((4096, 14336), dict(e=-12.0, scale=0.02), 2)}
    cases = {tag: [qcases.quantize_case(shape, seed=s, device=dev, **kw)
                   for s in range(n)]
             for tag, (shape, kw, n) in shapes.items()}

    def timed(fn):
        out = {}
        for tag, copies in cases.items():
            it = iter(range(1 << 30))
            out[tag] = device_us(
                lambda: fn(copies[next(it) % len(copies)]))
        return out

    def fake(a):
        q = 2 ** (a["width"] - 1)
        return torch.fake_quantize_per_tensor_affine(
            a["x"], 2.0 ** a["e"], 0, -q, q - 1)

    print(f"fake_quantize: {json.dumps(timed(fake))}", flush=True)
    _, fn_name, argtypes = build.SIGNATURES["dfxp_quantize"]
    for name in procs:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        build._LOADED["dfxp_quantize"] = lib
        # zeroed room for every variant's words (the last_block variant's
        # ticket and per-block slots), where the wrapper finds it
        stream = torch.cuda.current_stream(dev)
        k1._SCRATCH[(dev.index or 0, stream.cuda_stream)] = torch.zeros(
            1 + 2 * MAX_BLOCKS, dtype=torch.int64, device=dev)

        def call(a):
            return k1.dfxp_quantize(a["x"], a["e"], width=a["width"])
        exact = None
        if name != "no_counts":
            exact = True
            for copies in cases.values():
                a = copies[0]
                for _ in range(2):          # the second call reuses scratch
                    y, st = call(a)
                    yr, sr = dfxp_quantize_ref(a["x"], a["e"],
                                               width=a["width"])
                    exact &= bool(torch.equal(y, yr) and torch.equal(st, sr))
        print(f"K1 variant {name}: bit_exact={exact} "
              f"{json.dumps(timed(call))}", flush=True)
    build._LOADED.pop("dfxp_quantize")
    k1._SCRATCH.clear()


if __name__ == "__main__":
    main()
