// K5 — paged flash-decode: single-query GQA attention through a
// per-request block table over a paged KV arena, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_decode_paged_call`
// (src/repro/kernels/attn/attn_kernel.py:248), whose grid (B, K, nblocks)
// streams page bt[b, r] at split r through a scalar-prefetch index map,
// with (m, l, acc) carried in VMEM scratch across the page axis.
//
// What bounds it on an H100: bytes.  One call must read the K/V pages its
// block tables map once — at the serving shape (B=4 slots, P=64,
// nblocks=8, K=8, hd=128, int8) at most 4.2 MB — and does 4*K*G*hd flops
// per visible key: ~1 us at 3.35 TB/s.  What held the first version far
// above that was latency: one block per (kv head, slot), 32 blocks for 132
// SMs, each walking all its tiles in turn and staging each one with one
// scalar load per thread per key.
//
// Design: decode_common.cuh's split decode, shared with K3.  Here a split
// is a contiguous range of `pps` block-table entries (the wrapper's
// decode_splits picks S so that K * B * S blocks fill a wave of SMs); with
// a page size P that is a multiple of 32, the tile of logical rows
// [w0, w0 + 32) lies in one page, bt_row[w0 / P], at offsets w0 % P ..,
// and carries that page's steps.  Any hd <= 256 (the instance of the next
// multiple of 32, dims past hd zero); flash_decode_paged_kernel_combine
// merges the splits.
#include "decode_common.cuh"

namespace {

using namespace attn;

// The tiles of one split: block-table entries [blk0, blk0 + pps).
template <typename T>
struct PagedSrc {
  const T* k;
  const T* v;
  const int* bt_row;
  const int* pos_row;               // the split's first logical row
  const float* steps;
  int blk0, P, K, kh, hd, n_tiles;
  long row_stride;

  __device__ int page(int t) const { return bt_row[blk0 + t * kTile / P]; }
  __device__ int pos(int t, int lane) const {
    return pos_row[t * kTile + lane];
  }
  __device__ long base(int t) const {
    return (((long)page(t) * P + (t * kTile) % P) * K + kh) * hd;
  }
  __device__ const T* kbase(int t) const { return k + base(t); }
  __device__ const T* vbase(int t) const { return v + base(t); }
  __device__ int rows(int) const { return kTile; }
  __device__ float kstep(int t) const { return steps[2 * page(t)]; }
  __device__ float vstep(int t) const { return steps[2 * page(t) + 1]; }
};

template <typename T, int DPL>
__global__ void __launch_bounds__(1024) flash_decode_paged_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ bt,
    const int* __restrict__ pos, const int* __restrict__ qpos,
    const float* __restrict__ steps, float* __restrict__ out,
    float* __restrict__ ws, int B, int nblocks, int P, int K, int G, int hd,
    float scale, int window, int causal, int pps, int copy) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int blk0 = blockIdx.z * pps;
  PagedSrc<T> src;
  src.k = k;
  src.v = v;
  src.bt_row = bt + (long)b * nblocks;
  src.pos_row = pos + (long)b * nblocks * P + (long)blk0 * P;
  src.steps = steps;
  src.blk0 = blk0;
  src.P = P;
  src.K = K;
  src.kh = kh;
  src.hd = hd;
  src.n_tiles = max(min(pps, nblocks - blk0), 0) * (P / kTile);
  src.row_stride = (long)K * hd;
  decode_split<T, DPL>(src, q, out, ws, B, K, G, hd, scale, window, causal,
                       qpos[b], copy);
}

__global__ void flash_decode_paged_kernel_combine(const float* __restrict__ ws,
                                                  float* __restrict__ out,
                                                  int S, int rows, int hd) {
  combine_splits(ws, out, S, rows, hd);
}

template <typename T, int DPL>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* bt, const int* pos, const int* qpos,
                   const float* steps, float* out, float* ws, int B,
                   int nblocks, int P, int K, int G, int hd, float scale,
                   int window, int causal, int splits, int pps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DPL>(G, pps * (P / kTile));
  cudaError_t err = allow_smem(flash_decode_paged_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_paged_kernel<T, DPL>
      <<<dim3(K, B, splits), 32 * G, smem, stream>>>(
          q, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos,
          qpos, steps, out, ws, B, nblocks, P, K, G, hd, scale, window,
          causal, pps, copy_mode<T>(hd, k, v));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_decode_paged_kernel_combine<<<B * K * G, hd, 0, stream>>>(
      ws, out, splits, B * K * G, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const float* q, const void* k, const void* v,
                  const int* bt, const int* pos, const int* qpos,
                  const float* steps, float* out, float* ws, int B,
                  int nblocks, int P, int K, int G, float scale, int window,
                  int causal, int splits, int pps, cudaStream_t s) {
#define K5_HD(DPL)                                                          \
  case DPL:                                                                \
    return launch<T, DPL>(q, k, v, bt, pos, qpos, steps, out, ws, B,       \
                          nblocks, P, K, G, hd, scale, window, causal,     \
                          splits, pps, s);
  switch (dpl_of(hd)) {
    K5_HD(1)
    K5_HD(2)
    K5_HD(3)
    K5_HD(4)
    K5_HD(5)
    K5_HD(6)
    K5_HD(7)
    K5_HD(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef K5_HD
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.  P
// must be a multiple of 32, hd in 1..256.  The block table's entries are
// cut into `splits` ranges of `pps` entries; with splits > 1, ws is an f32
// workspace of splits * B * K * G * (hd + 2) floats.  Returns the
// cudaError_t of the first launch, else of the second (0 on success).
extern "C" int flash_decode_paged_launch(
    const float* q, const void* k, const void* v, const int* bt,
    const int* pos, const int* qpos, const float* steps, float* out,
    float* ws, int B, int nblocks, int P, int K, int G, int hd, int kv_dtype,
    float scale, int window, int causal, int splits, int pps, void* stream) {
  if (B < 1 || nblocks < 1 || P < kTile || P % kTile != 0 || K < 1 ||
      G < 1 || G > 32 || hd < 1 || hd > 32 * kMaxDpl || B > 65535 ||
      splits < 1 || splits > 65535 || pps < 1 ||
      (long)(splits - 1) * pps >= nblocks ||
      (long)splits * pps < nblocks || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)by_hd<int8_t>(hd, q, k, v, bt, pos, qpos, steps, out, ws,
                                B, nblocks, P, K, G, scale, window, causal,
                                splits, pps, s);
    case 1:
      return (int)by_hd<int16_t>(hd, q, k, v, bt, pos, qpos, steps, out, ws,
                                 B, nblocks, P, K, G, scale, window, causal,
                                 splits, pps, s);
    case 2:
      return (int)by_hd<float>(hd, q, k, v, bt, pos, qpos, steps, out, ws, B,
                               nblocks, P, K, G, scale, window, causal,
                               splits, pps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
