// Shared pieces of the attention kernels: the constants and warp
// reductions all of them use, and the first version's staging and online
// softmax (stage_tile, stage_page_tile, RowState, tile_update, smem_floats),
// which only K6 (paged flash-prefill) still runs: K3 and K5 run
// decode_common.cuh's split decode, K4 its own tensor-core kernel.
//
// The first version walks the keys of one (slot, kv head) in tiles of 32,
// one key per lane.  A tile is staged into shared memory by the whole block,
// dequantized on the way in (value = mantissa * step, step = 2**e of the
// slot, or 1 for a float pool).  Each warp then owns a few query rows
// and runs the online softmax over the tile with the running
// (m, l, acc) of its rows in registers:
//
//   s     = (q . k) * scale,          masked lanes -> -1e30
//   m_new = max(m, max_lanes s)
//   p     = masked ? 0 : exp(s - m_new)          (an exact 0 when masked)
//   l     = l * exp(m - m_new) + sum_lanes p
//   acc   = acc * exp(m - m_new) + sum_lanes p * v
//
// m starts at -inf, so the first correction is exp(-inf) = 0; m_new is
// always finite (>= -1e30), so exp(-inf - -inf) never happens.  The
// caller divides acc by max(l, 1e-30): a row with every lane masked
// gives 0, not NaN.  Lanes past the end of a tile's rows are staged as
// zero K/V rows and masked by index, so the pool is never padded.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kTile = 32;      // keys per tile: one per lane
constexpr int kMaxDpl = 8;     // head dims per lane: head_dim <= 256
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory floats a block needs for one K tile (rows padded by one
// float so that lane j reading row j hits bank (j + d) % 32), one V tile
// and `q_rows` query rows.
__host__ __device__ inline size_t smem_floats(int hd, int q_rows) {
  return (size_t)kTile * (hd + 1) + (size_t)kTile * hd + (size_t)q_rows * hd;
}

// Stage rows [0, n_rows) of a K/V tile whose row r starts at
// base + r * row_stride, dequantized by (kstep, vstep); rows past n_rows
// are zero.  ks has row stride hd + 1, vs row stride hd.
template <typename T>
__device__ void stage_tile(const T* __restrict__ kbase,
                           const T* __restrict__ vbase, long row_stride,
                           int n_rows, float kstep, float vstep, int hd,
                           float* ks, float* vs) {
  for (int i = threadIdx.x; i < kTile * hd; i += blockDim.x) {
    const int j = i / hd;
    const int d = i - j * hd;
    float kv = 0.f, vv = 0.f;
    if (j < n_rows) {
      kv = static_cast<float>(kbase[j * row_stride + d]) * kstep;
      vv = static_cast<float>(vbase[j * row_stride + d]) * vstep;
    }
    ks[j * (hd + 1) + d] = kv;
    vs[j * hd + d] = vv;
  }
}

// Paged variants (K5, K6): with a page size P that is a multiple of
// kTile, the logical rows [w0, w0 + kTile) of a slot lie in one page,
// bt_row[w0 / P], at offsets w0 % P ..; the tile is that page's rows,
// staged by stage_tile from the page's base with the page's own steps
// (steps[2 * page], steps[2 * page + 1]).  Arena layout [n_pages, P, K,
// hd]: row stride K * hd inside a page, as in a slot-major ring.
template <typename T>
__device__ void stage_page_tile(const T* __restrict__ k,
                                const T* __restrict__ v,
                                const int* __restrict__ bt_row,
                                const float* __restrict__ steps, int w0,
                                int P, int K, int kh, int hd, float* ks,
                                float* vs) {
  const int page = bt_row[w0 / P];
  const long base = (((long)page * P + w0 % P) * K + kh) * hd;
  stage_tile(k + base, v + base, (long)K * hd, kTile, steps[2 * page],
             steps[2 * page + 1], hd, ks, vs);
}

// Running softmax state of the RPW query rows one warp owns; lane l holds
// head dims l, l + 32, ... of each row's accumulator.
template <int RPW>
struct RowState {
  float m[RPW];
  float l[RPW];
  float acc[RPW][kMaxDpl];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < kMaxDpl; ++dd) acc[i][dd] = 0.f;
    }
  }

  // Write acc / max(l, 1e-30) of row i to dst[0 .. hd).
  __device__ void store(int i, float* dst, int hd, int lane) const {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kMaxDpl; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) dst[d] = acc[i][dd] * inv;
    }
  }
};

// One staged tile through the online softmax of a warp's RPW rows.
// qs: the warp's first query row in shared memory (row stride hd);
// valid[i]: whether this lane's key may be seen by row i.  All 32 lanes
// must call this together (it shuffles).
template <int RPW>
__device__ void tile_update(RowState<RPW>& st, const float* qs,
                            const float* ks, const float* vs, int hd,
                            float scale, const bool (&valid)[RPW],
                            int lane) {
  float s[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) s[i] = 0.f;
  const float* krow = ks + lane * (hd + 1);
  for (int d = 0; d < hd; ++d) {
    const float kd = krow[d];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = fmaf(qs[i * hd + d], kd, s[i]);
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float si = valid[i] ? s[i] * scale : kNeg;
    const float m_new = fmaxf(st.m[i], warp_max(si));
    const float p = valid[i] ? expf(si - m_new) : 0.f;
    const float corr = expf(st.m[i] - m_new);
    st.l[i] = st.l[i] * corr + warp_sum(p);
#pragma unroll
    for (int dd = 0; dd < kMaxDpl; ++dd) st.acc[i][dd] *= corr;
    st.m[i] = m_new;
    s[i] = p;
  }
  for (int j = 0; j < kTile; ++j) {
    const float* vrow = vs + j * hd;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float pj = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
      for (int dd = 0; dd < kMaxDpl; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hd) st.acc[i][dd] = fmaf(pj, vrow[d], st.acc[i][dd]);
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn
