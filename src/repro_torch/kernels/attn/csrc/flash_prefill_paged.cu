// K6 — paged flash-prefill: a chunk of C queries attends the paged
// history through its block table, then its own f32 K/V causally, in one
// joint softmax.
//
// Replaces the Pallas kernel `flash_prefill_paged_call`
// (src/repro/kernels/attn/prefill_kernel.py), whose grid (B, K,
// nblocks + 1) streams page bt[b, r] at split r (scalar prefetch) and
// scores the chunk's own K/V at the last step, with (m, l, acc) of all
// C*G rows in VMEM scratch.
//
// What bounds it on an H100: f32 arithmetic.  One chunk (B=1, C=64,
// p0=384, K=8, G=4, hd=128) does 4*K*G*hd flops for each visible
// (query, key) pair — ~0.4 GFLOP — and moves ~3 MB, so the bound is
// a few us at the 67 TFLOP/s f32 rate outside the tensor cores.
//
// Design: K4's.  The C*G rows of a kv head are tiled across blocks, 32
// per block and 4 per warp (grid (ceil(C*G / 32), K, B)); each block
// walks the slot's nblocks*P logical history rows in 32-key tiles,
// reading its own block-table row: with P % 32 == 0 (the wrapper's
// contract) a tile is 32 rows of one page, staged dequantized by that
// page's steps (attn_common.cuh).  History masking is K4's on logical
// positions (0 <= pos < p0, causal, window, rows c >= n_valid); a tile
// no row of the block can see is skipped after a block-wide vote (its
// contribution would be exact zeros), so the null pages past a short
// request's frontier cost one pos load each.  The final pass scores the
// chunk against its own f32 K/V exactly as K4 does.
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kRpw = 4;                  // query rows per warp
constexpr int kWarps = 8;
constexpr int kRows = kRpw * kWarps;     // query rows per block

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
flash_prefill_paged_kernel(const float* __restrict__ q,
                           const float* __restrict__ kn,
                           const float* __restrict__ vn,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const int* __restrict__ bt,
                           const int* __restrict__ pos,
                           const int* __restrict__ p0s,
                           const int* __restrict__ nvs,
                           const float* __restrict__ steps,
                           float* __restrict__ out, int C, int nblocks,
                           int P, int K, int G, int hd, float scale,
                           int window, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (hd + 1);
  float* qs = vs + kTile * hd;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int rows = C * G;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Wp = nblocks * P;

  // query row r = c*G + g sits at q[((b*C + c)*K + kh)*G + g][0 .. hd)
  auto row_off = [&](int r) {
    const int c = r / G, g = r - c * G;
    return (((long)b * C + c) * K + kh) * G * hd + (long)g * hd;
  };
  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    const int rr = i / hd, d = i - rr * hd;
    const int r = r0 + rr;
    qs[i] = r < rows ? q[row_off(r) + d] : 0.f;
  }
  const int p0 = p0s[b], nv = nvs[b];

  int cq[kRpw];
  bool row_ok[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = r0 + warp * kRpw + i;
    cq[i] = r / G;
    row_ok[i] = r < rows && cq[i] < nv;
  }
  const float* qw = qs + warp * kRpw * hd;
  RowState<kRpw> st;
  st.init();

  // history: the slot's pages through its block table, 0 <= pos < p0
  if (p0 > 0) {
    const int* bt_row = bt + (long)b * nblocks;
    const int* pos_row = pos + (long)b * Wp;
    for (int w0 = 0; w0 < Wp; w0 += kTile) {
      const int p = pos_row[w0 + lane];
      const bool key_ok = p >= 0 && p < p0;
      bool valid[kRpw];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
        const int dlt = p0 + cq[i] - p;
        valid[i] = row_ok[i] && key_ok && (!causal || dlt >= 0) &&
                   (window <= 0 || dlt < window);
        any = any || valid[i];
      }
      // the vote is also the barrier after which the previous tile is
      // consumed and the query rows are staged
      if (!__syncthreads_or(any)) continue;
      stage_page_tile(k, v, bt_row, steps, w0, P, K, kh, hd, ks, vs);
      __syncthreads();
      tile_update<kRpw>(st, qw, ks, vs, hd, scale, valid, lane);
    }
  }

  // self block: the chunk's own f32 K/V, keys j < n_valid (K4's pass)
  const long row_stride = (long)K * hd;
  const int c_last = min(rows - 1, r0 + kRows - 1) / G;
  const int j_end = causal ? min(nv, c_last + 1) : nv;
  const float* knb = kn + ((long)b * C * K + kh) * hd;
  const float* vnb = vn + ((long)b * C * K + kh) * hd;
  for (int j0 = 0; j0 < j_end; j0 += kTile) {
    __syncthreads();
    stage_tile(knb + j0 * row_stride, vnb + j0 * row_stride, row_stride,
               min(kTile, C - j0), 1.f, 1.f, hd, ks, vs);
    __syncthreads();
    const int j = j0 + lane;
    bool valid[kRpw];
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      const int dj = cq[i] - j;
      valid[i] = row_ok[i] && j < nv && (!causal || dj >= 0) &&
                 (window <= 0 || dj < window);
    }
    tile_update<kRpw>(st, qw, ks, vs, hd, scale, valid, lane);
  }

#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = r0 + warp * kRpw + i;
    if (r < rows) st.store(i, out + row_off(r), hd, lane);
  }
}

template <typename T>
cudaError_t launch(const float* q, const float* kn, const float* vn,
                   const void* k, const void* v, const int* bt,
                   const int* pos, const int* p0, const int* nv,
                   const float* steps, float* out, int B, int C, int nblocks,
                   int P, int K, int G, int hd, float scale, int window,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(hd, kRows) * sizeof(float);
  cudaError_t err = allow_smem(flash_prefill_paged_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C * G + kRows - 1) / kRows, K, B);
  flash_prefill_paged_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      q, kn, vn, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos,
      p0, nv, steps, out, C, nblocks, P, K, G, hd, scale, window, causal);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.
// P must be a multiple of 32.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int flash_prefill_paged_launch(
    const float* q, const float* kn, const float* vn, const void* k,
    const void* v, const int* bt, const int* pos, const int* p0,
    const int* nv, const float* steps, float* out, int B, int C, int nblocks,
    int P, int K, int G, int hd, int kv_dtype, float scale, int window,
    int causal, void* stream) {
  if (B < 1 || C < 1 || nblocks < 1 || P < kTile || P % kTile != 0 ||
      K < 1 || G < 1 || hd < 1 || hd > 32 * kMaxDpl || B > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch<int8_t>(q, kn, vn, k, v, bt, pos, p0, nv, steps,
                                 out, B, C, nblocks, P, K, G, hd, scale,
                                 window, causal, s);
    case 1:
      return (int)launch<int16_t>(q, kn, vn, k, v, bt, pos, p0, nv, steps,
                                  out, B, C, nblocks, P, K, G, hd, scale,
                                  window, causal, s);
    case 2:
      return (int)launch<float>(q, kn, vn, k, v, bt, pos, p0, nv, steps, out,
                                B, C, nblocks, P, K, G, hd, scale, window,
                                causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
