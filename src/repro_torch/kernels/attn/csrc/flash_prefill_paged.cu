// K6 — paged flash-prefill: a chunk of C queries attends the paged
// history through its block table, then its own f32 K/V causally, in one
// joint softmax, for Hopper (sm_90a), with both products on the tensor
// cores.
//
// Replaces the Pallas kernel `flash_prefill_paged_call`
// (src/repro/kernels/attn/prefill_kernel.py:281), whose grid (B, K,
// nblocks + 1) streams page bt[b, r] at split r (scalar prefetch) and
// scores the chunk's own K/V at the last step, with (m, l, acc) of all
// C*G rows in VMEM scratch.
//
// The design, its bound and its arithmetic are K4's (prefill_common.cuh,
// one code with flash_prefill.cu); this source gives it the page arena as
// its history.  Tile t of slot b is its logical rows t*32 .. t*32 + 31:
// with a page size P that is a multiple of 32 (the wrapper's contract)
// they are rows (t*32) % P .. + 31 of the one page bt[b, t*32 / P] of the
// [n_pages, P, K, hd] arena, dequantized by that page's own steps
// (steps[2 * page], steps[2 * page + 1]).  The positions [B, nblocks*P]
// are K4's ring positions with W = nblocks*P, so the votes, masks, splits
// and merge are K4's: a tile of the null page (block-table entry 0,
// positions -1) or past a slot's frontier is never loaded, and a page
// that prefix sharing or a copy-on-write fork maps into several tables is
// read through whichever row names it.
// What bounds it on an H100: operations, as K4 (attn/cases.py
// prefill_paged_bounds).  The first version ran every product as scalar
// f32 FMAs, 32 query rows a block, 38x its f32 bound.
#include "prefill_common.cuh"

namespace {

using namespace attn;

// The slot's logical rows through its block-table row, for one kv head,
// each page with its own step pair.
template <typename T>
struct PageSrc {
  const T* k;
  const T* v;
  const int* bt_row;    // bt[b, :]
  const float* steps;   // [n_pages, 2]
  int P;
  long row_stride;      // K * hd
  long head;            // kh * hd
  __device__ int page(int t) const { return bt_row[t * kTile / P]; }
  __device__ long base(int t) const {
    return ((long)page(t) * P + (t * kTile) % P) * row_stride + head;
  }
  __device__ const T* kbase(int t) const { return k + base(t); }
  __device__ const T* vbase(int t) const { return v + base(t); }
  __device__ int rows(int) const { return kTile; }
  __device__ float kstep(int t) const { return steps[2 * page(t)]; }
  __device__ float vstep(int t) const { return steps[2 * page(t) + 1]; }
};

template <typename T, int DPL>
__global__ void __launch_bounds__(32 * warps_for(DPL))
flash_prefill_paged_kernel(PrefillArgs a, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ bt,
                           const float* __restrict__ steps, int nblocks,
                           int P) {
  const int kh = blockIdx.y, b = blockIdx.z / a.S;
  const PageSrc<T> src{k, v, bt + (long)b * nblocks, steps, P,
                       (long)a.K * a.hd, (long)kh * a.hd};
  prefill_split<T, DPL>(src, a);
}

__global__ void flash_prefill_paged_kernel_combine(
    const float* __restrict__ ws, float* __restrict__ out, int S, long rows,
    int hd) {
  combine_splits(ws, out, S, rows, hd);
}

template <typename T, int DPL>
struct Launch {
  static cudaError_t run(const PrefillArgs& a, const int& warps,
                         const cudaStream_t& s, const void* const& k,
                         const void* const& v, const int* const& bt,
                         const float* const& steps, const int& nblocks,
                         const int& P) {
    if (warps != warps_for(DPL)) return cudaErrorInvalidValue;
    PrefillArgs at = a;
    at.copy_h = copy_mode<T>(a.hd, k, v);
    auto kernel = flash_prefill_paged_kernel<T, DPL>;
    return launch_prefill<DPL>(kernel, flash_prefill_paged_kernel_combine,
                               at, s, static_cast<const T*>(k),
                               static_cast<const T*>(v), bt, steps, nblocks,
                               P);
  }
};

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.  P
// must be a multiple of 32.  The plan as K4's: blocks of 16 * warps query
// rows (warps 8 for hd <= 128, else 2), each block's list of visible
// history and chunk tiles cut into `splits` even ranges; with splits > 1,
// ws is an f32 workspace of splits * B * C * K * G * (hd + 2) floats.
// Returns the cudaError_t of the first launch, else of the second (0 on
// success).
extern "C" int flash_prefill_paged_launch(
    const float* q, const float* kn, const float* vn, const void* k,
    const void* v, const int* bt, const int* pos, const int* p0,
    const int* nv, const float* steps, float* out, float* ws, int B, int C,
    int nblocks, int P, int K, int G, int hd, int kv_dtype, float scale,
    int window, int causal, int warps, int splits, void* stream) {
  if (B < 1 || C < 1 || nblocks < 1 || P < kTile || P % kTile != 0 ||
      (long)nblocks * P > 2147483647L || K < 1 || G < 1 || hd < 1 ||
      hd > 32 * kMaxDpl || B > 65535 || K > 65535 || splits < 1 ||
      (long)B * splits > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PrefillArgs a{q, kn, vn, pos, p0, nv, out, ws, B, C, nblocks * P,
                      K, G, hd, scale, window, causal, splits,
                      copy_mode<float>(hd, q, q), kCopy1,
                      copy_mode<float>(hd, kn, vn)};
  return (int)dispatch<Launch>(kv_dtype, hd, a, warps, s, k, v, bt, steps,
                               nblocks, P);
}
