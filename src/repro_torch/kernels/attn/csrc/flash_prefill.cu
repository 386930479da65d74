// K4 — flash-prefill: a chunk of C queries attends the packed history
// ring, then its own f32 K/V causally, in one joint softmax, for Hopper
// (sm_90a), with both products on the tensor cores.
//
// Replaces the Pallas kernel `flash_prefill_call`
// (src/repro/kernels/attn/prefill_kernel.py:125), which keeps (m, l, acc)
// for all C*G rows of a kv head in VMEM across a sequential grid of
// history splits plus one self step.
//
// The design, its bound and its arithmetic are prefill_common.cuh's,
// which K6 (flash_prefill_paged.cu) shares; this source gives it the
// slot-major ring as its history: tile t of slot b is ring rows
// t*32 .. t*32 + 31 of [B, W, K, hd] (the last tile may be short), all
// dequantized by the slot's steps.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.051 ms at B=1,
// C=128, p0=256, W=400, K=8, G=4, hd=128, int8, 17x the route's bound;
// tools/k4_attribution.py puts most of it in the mma.sync products (about
// a quarter of the TF32 peak per SM) and in per-split fixed work, so
// wgmma is the next step.
#include "prefill_common.cuh"

namespace {

using namespace attn;

// The slot's ring rows for one kv head, one step pair per slot.
template <typename T>
struct RingSrc {
  const T* k;
  const T* v;
  long base;          // element of ring row 0 of this slot and kv head
  long row_stride;    // K * hd
  int W;
  float ks, vs;
  __device__ const T* kbase(int t) const {
    return k + base + (long)t * kTile * row_stride;
  }
  __device__ const T* vbase(int t) const {
    return v + base + (long)t * kTile * row_stride;
  }
  __device__ int rows(int t) const { return min(kTile, W - t * kTile); }
  __device__ float kstep(int) const { return ks; }
  __device__ float vstep(int) const { return vs; }
};

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * warps_for(DPL)) flash_prefill_kernel(
    PrefillArgs a, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ steps) {
  const int kh = blockIdx.y, b = blockIdx.z / a.S;
  const RingSrc<T> src{k, v, ((long)b * a.W * a.K + kh) * a.hd,
                       (long)a.K * a.hd, a.W, steps[2 * b], steps[2 * b + 1]};
  prefill_split<T, DPL>(src, a);
}

__global__ void flash_prefill_kernel_combine(const float* __restrict__ ws,
                                             float* __restrict__ out, int S,
                                             long rows, int hd) {
  combine_splits(ws, out, S, rows, hd);
}

template <typename T, int DPL>
struct Launch {
  static cudaError_t run(const PrefillArgs& a, const int& warps,
                         const cudaStream_t& s, const void* const& k,
                         const void* const& v, const float* const& steps) {
    if (warps != warps_for(DPL)) return cudaErrorInvalidValue;
    PrefillArgs at = a;
    at.copy_h = copy_mode<T>(a.hd, k, v);
    auto kernel = flash_prefill_kernel<T, DPL>;
    return launch_prefill<DPL>(kernel, flash_prefill_kernel_combine, at, s,
                               static_cast<const T*>(k),
                               static_cast<const T*>(v), steps);
  }
};

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.  The
// plan: blocks of 16 * warps query rows (warps 8 for hd <= 128, else 2),
// each block's list of visible ring and chunk tiles cut into `splits`
// even ranges; with splits > 1, ws is an f32 workspace of
// splits * B * C * K * G * (hd + 2) floats.  Returns the cudaError_t of
// the first launch, else of the second (0 on success).
extern "C" int flash_prefill_launch(const float* q, const float* kn,
                                    const float* vn, const void* k,
                                    const void* v, const int* pos,
                                    const int* p0, const int* nv,
                                    const float* steps, float* out,
                                    float* ws, int B, int C, int W, int K,
                                    int G, int hd, int kv_dtype, float scale,
                                    int window, int causal, int warps,
                                    int splits, void* stream) {
  if (B < 1 || C < 1 || W < 1 || K < 1 || G < 1 || hd < 1 ||
      hd > 32 * kMaxDpl || B > 65535 || K > 65535 || splits < 1 ||
      (long)B * splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PrefillArgs a{q, kn, vn, pos, p0, nv, out, ws, B, C, W, K, G, hd,
                      scale, window, causal, splits,
                      copy_mode<float>(hd, q, q), kCopy1,
                      copy_mode<float>(hd, kn, vn)};
  return (int)dispatch<Launch>(kv_dtype, hd, a, warps, s, k, v, steps);
}
