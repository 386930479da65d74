// K5 — paged flash-decode: single-query GQA attention through a
// per-request block table over a paged KV arena.
//
// Replaces the Pallas kernel `flash_decode_paged_call`
// (src/repro/kernels/attn/attn_kernel.py), whose grid (B, K, nblocks)
// streams page bt[b, r] at split r through a scalar-prefetch index map,
// with (m, l, acc) carried in VMEM scratch across the page axis.
//
// What bounds it on an H100: bytes.  One call must read the K/V pages
// its block tables map once — at the serving shape (B=4 slots, P=64,
// nblocks=8, K=8, hd=128, int8) at most 4.2 MB — and does 4*K*G*hd flops
// per visible key (a few MFLOP): ~1 us at 3.35 TB/s, far below the f32
// rate.  As for K3, launch latency and the serial walk over the pages
// inside one block set the time of this first version.
//
// Design: K3's (attn_common.cuh): one block per (kv head, slot), one
// warp per query row of the head's group.  The block walks the slot's
// nblocks*P logical rows in 32-key tiles; scalar prefetch becomes each
// block reading its own block-table row, and since P % 32 == 0 (the
// wrapper's contract) a tile is 32 rows of one page, staged dequantized
// by that page's steps.  Masking is K3's, on the logical positions: an
// unwritten row (every row of the null page 0) has pos == -1.  A tile in
// which no lane is visible is skipped after one block-wide vote: it
// would add exact zeros, so skipping it changes no bit of the output,
// and unmapped blocks of short requests cost one pos load, not a page.
#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void flash_decode_paged_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ bt,
    const int* __restrict__ pos, const int* __restrict__ qpos,
    const float* __restrict__ steps, float* __restrict__ out, int nblocks,
    int P, int K, int G, int hd, float scale, int window, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (hd + 1);
  float* qs = vs + kTile * hd;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Wp = nblocks * P;

  const long qoff = ((long)b * K + kh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) qs[i] = q[qoff + i];
  const int qp = qpos[b];
  const int* bt_row = bt + (long)b * nblocks;
  const int* pos_row = pos + (long)b * Wp;

  RowState<1> st;
  st.init();
  for (int w0 = 0; w0 < Wp; w0 += kTile) {
    const int p = pos_row[w0 + lane];
    const int dlt = qp - p;
    const bool valid[1] = {p >= 0 && (!causal || dlt >= 0) &&
                           (window <= 0 || dlt < window)};
    // the vote is also the barrier after which the previous tile is
    // consumed and the query rows are staged
    if (!__syncthreads_or(valid[0])) continue;
    stage_page_tile(k, v, bt_row, steps, w0, P, K, kh, hd, ks, vs);
    __syncthreads();
    tile_update<1>(st, qs + warp * hd, ks, vs, hd, scale, valid, lane);
  }
  st.store(0, out + qoff + (long)warp * hd, hd, lane);
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* bt, const int* pos, const int* qpos,
                   const float* steps, float* out, int B, int nblocks, int P,
                   int K, int G, int hd, float scale, int window, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(hd, G) * sizeof(float);
  cudaError_t err = allow_smem(flash_decode_paged_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_paged_kernel<T><<<dim3(K, B), 32 * G, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos, qpos,
      steps, out, nblocks, P, K, G, hd, scale, window, causal);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.
// P must be a multiple of 32.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_decode_paged_launch(
    const float* q, const void* k, const void* v, const int* bt,
    const int* pos, const int* qpos, const float* steps, float* out, int B,
    int nblocks, int P, int K, int G, int hd, int kv_dtype, float scale,
    int window, int causal, void* stream) {
  if (B < 1 || nblocks < 1 || P < kTile || P % kTile != 0 || K < 1 ||
      G < 1 || G > 32 || hd < 1 || hd > 32 * kMaxDpl || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch<int8_t>(q, k, v, bt, pos, qpos, steps, out, B,
                                 nblocks, P, K, G, hd, scale, window, causal,
                                 s);
    case 1:
      return (int)launch<int16_t>(q, k, v, bt, pos, qpos, steps, out, B,
                                  nblocks, P, K, G, hd, scale, window,
                                  causal, s);
    case 2:
      return (int)launch<float>(q, k, v, bt, pos, qpos, steps, out, B,
                                nblocks, P, K, G, hd, scale, window, causal,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
