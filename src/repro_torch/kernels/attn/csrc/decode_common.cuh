// What the flash-decode kernels K3 (slot-major ring, flash_decode.cu) and
// K5 (paged arena, flash_decode_paged.cu) share, for Hopper (sm_90a): one
// implementation of the split design, which the two sources instantiate
// with their own way of finding a tile's rows and steps (a `Src`, below).
// K4 and K6 (prefill_common.cuh) use its staging pieces (cp.async,
// stage_rows).
//
// The design, per block of grid (K, B, S): one warp per query row of a kv
// head's group, one lane per key of a 32-key tile, a contiguous range of
// the slot's tiles per split.
//   * visibility first: the block reads the positions of all its tiles at
//     once and keeps each tile's vote (a ballot of its visible lanes);
//     tiles no lane sees are never loaded (they would add exact zeros), so
//     a short slot or a sliding window costs one pos load per masked tile;
//   * loads in flight: the raw mantissas of the visible tiles are copied
//     into a ring of stages in shared memory (3 for int8/int16, 2 for
//     f32), two tiles ahead of the one being used, with 16-byte cp.async
//     where a row is whole 16-byte pieces, else 4-byte cp.async, else one
//     value at a time; they are dequantized when read: the tile's step, a
//     power of two, is applied to the dot product and to the softmax
//     weight, which changes no bit against dequantizing each element;
//   * the head dimension is a template, HD = 32 * DPL >= hd: each lane
//     holds DPL consecutive dims of the accumulator and reads them from a
//     V row in one vector load, and the q.k product reads 16 bytes of a K
//     row at a time, fully unrolled, in four chains.  A head dim that is
//     not a multiple of 32 runs on the next instance up, with dims past hd
//     zero in q, K and V (stage_rows writes them), so any hd <= 256 is
//     taken;
//   * the split's partial (m, l, acc) goes to a workspace and a second
//     kernel merges the S partials of each query row in split order
//     (deterministic, no atomics): m* = max m_s, l* = sum l_s e^(m_s - m*),
//     out = sum acc_s e^(m_s - m*) / max(l*, 1e-30).  A split that sees no
//     key has m = -inf, l = 0, acc = 0 and weighs exactly 0; a row that
//     sees no key in any split gives 0.  With S = 1 the block writes the
//     output itself.
// The online softmax of one tile (m starts at -inf; masked lanes score
// -1e30 and weigh an exact 0):
//   s = (q . k) * step_k * scale,  m' = max(m, max_lanes s),
//   p = exp(s - m'),  l = l e^(m - m') + sum p,
//   acc = acc e^(m - m') + sum (p * step_v) * v.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"

namespace attn {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The 32-bit word w as 4 / sizeof(T) values of T, converted to float.
// int8 and int16 exactly by the float trick: the value plus 2^7 (2^15)
// placed in the low mantissa bits of 2^23 by one byte permute, then
// 2^23 + 2^7 (2^15) subtracted — an add at full rate, where an
// int-to-float conversion runs at a quarter.
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack<int8_t>(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;              // each byte + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + i)) -
             8388736.f;
}
template <>
__device__ __forceinline__ void unpack<int16_t>(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80008000u;              // each half + 32768
  out[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7410)) - 8421376.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7432)) - 8421376.f;
}
template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float* out) {
  out[0] = __uint_as_float(w);
}

// N consecutive values of T from shared memory, as floats, in the widest
// loads their alignment (N * sizeof(T) bytes) allows.
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* p, float* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPer = 4 / (int)sizeof(T);         // values per 32-bit word
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      unpack<T>(u.x, out + (4 * i + 0) * kPer);
      unpack<T>(u.y, out + (4 * i + 1) * kPer);
      unpack<T>(u.z, out + (4 * i + 2) * kPer);
      unpack<T>(u.w, out + (4 * i + 3) * kPer);
    }
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      unpack<T>(u.x, out + (2 * i + 0) * kPer);
      unpack<T>(u.y, out + (2 * i + 1) * kPer);
    }
  } else if constexpr (kBytes % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i)
      unpack<T>(reinterpret_cast<const uint32_t*>(p)[i], out + i * kPer);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(p[i]);
  }
}

// How a row of hd values of T is copied: whole 16-byte pieces, 4-byte
// words, or one value at a time (rows and base 16- / 4-byte aligned).
enum CopyMode { kCopy1 = 0, kCopy4 = 1, kCopy16 = 2 };

template <typename T>
inline int copy_mode(int hd, const void* a, const void* b) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  const int bytes = hd * (int)sizeof(T);
  if (bytes % 16 == 0 && addr % 16 == 0) return kCopy16;
  if (bytes % 4 == 0 && addr % 4 == 0) return kCopy4;
  return kCopy1;
}

// Fill a 32-row tile of HD values of T at dst (row stride `stride`
// bytes), by the block's threads: rows j < n_rows get the hd values at
// src + j * row_stride (copied as `mode` says), everything else — dims
// hd .. HD of those rows and all of rows n_rows .. 31 — is written as
// zero, so a tile never holds data of an earlier one past its own.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int stride,
                                           const T* __restrict__ src,
                                           long row_stride, int n_rows,
                                           int hd, int HD, int mode) {
  const int bytes = hd * (int)sizeof(T);
  if (mode == kCopy16) {
    const int per = bytes / 16;
    for (int i = threadIdx.x; i < n_rows * per; i += blockDim.x) {
      const int j = i / per, c = i - j * per;
      cp_async16(dst + j * stride + c * 16,
                 reinterpret_cast<const unsigned char*>(src + j * row_stride) +
                     c * 16);
    }
  } else if (mode == kCopy4) {
    const int per = bytes / 4;
    for (int i = threadIdx.x; i < n_rows * per; i += blockDim.x) {
      const int j = i / per, c = i - j * per;
      cp_async4(dst + j * stride + c * 4,
                reinterpret_cast<const unsigned char*>(src + j * row_stride) +
                    c * 4);
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      reinterpret_cast<T*>(dst + j * stride)[d] = src[j * row_stride + d];
    }
  }
  if (hd < HD) {
    const int pad = HD - hd;
    for (int i = threadIdx.x; i < n_rows * pad; i += blockDim.x) {
      const int j = i / pad, d = hd + i % pad;
      reinterpret_cast<T*>(dst + j * stride)[d] = T(0);
    }
  }
  if (n_rows < kTile) {
    const int words = HD * (int)sizeof(T) / 4;
    for (int i = threadIdx.x; i < (kTile - n_rows) * words; i += blockDim.x) {
      const int j = n_rows + i / words, c = i % words;
      reinterpret_cast<uint32_t*>(dst + j * stride)[c] = 0u;
    }
  }
}

// Shared-memory geometry of the decode kernels: a raw K or V tile is 32
// rows of HD values of T, each row padded by 16 bytes so that the 16-byte
// row reads of a quarter warp hit distinct banks and every row starts
// 16-byte aligned.
template <typename T, int DPL>
struct Geo {
  static constexpr int kHd = 32 * DPL;
  static constexpr int kRow = kHd * (int)sizeof(T);     // bytes
  static constexpr int kStride = kRow + 16;             // bytes
  static constexpr int kChunks = kRow / 16;             // 16-byte pieces
  static constexpr int kTileBytes = kTile * kStride;
  static constexpr int kStages = sizeof(T) == 4 ? 2 : 3;
  static constexpr int kStageBytes = 2 * kTileBytes;    // K and V
  static_assert(kRow % 16 == 0, "rows must be whole 16-byte pieces");
};

// Dynamic shared memory of one decode block, bytes: the stage ring, the
// query rows (f32, HD each) and one vote and one index per tile of the
// block's range.
template <typename T, int DPL>
size_t smem_bytes(int G, int n_tiles) {
  using Gm = Geo<T, DPL>;
  return (size_t)Gm::kStages * Gm::kStageBytes +
         (size_t)G * Gm::kHd * sizeof(float) + (size_t)n_tiles * 8 + 16;
}

// One split of a decode: the block (kv head kh, slot b, split blockIdx.z)
// walks the n_tiles tiles `src` gives it.  Src provides
//   int n_tiles;  long row_stride;                     (elements of T)
//   int pos(t, lane): the lane's key position in tile t (-1: none);
//   const T* kbase(t), vbase(t): row 0 of tile t for this kv head;
//   int rows(t): rows of tile t that exist (the rest read as zero);
//   float kstep(t), vstep(t): the tile's steps.
// q: f32 [B, K, G, hd]; out: f32 [B, K, G, hd]; ws (S > 1): acc [S, rows,
// hd], then m [S, rows], then l [S, rows], rows = B * K * G.
template <typename T, int DPL, typename Src>
__device__ __forceinline__ void decode_split(
    const Src& src, const float* __restrict__ q, float* __restrict__ out,
    float* __restrict__ ws, int B, int K, int G, int hd, float scale,
    int window, int causal, int qp, int copy) {
  using Gm = Geo<T, DPL>;
  constexpr int HD = Gm::kHd;
  constexpr int EPC = 16 / (int)sizeof(T);      // values per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + Gm::kStages * Gm::kStageBytes);
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int n_tiles = src.n_tiles;
  unsigned* votes = reinterpret_cast<unsigned*>(qs + G * HD);
  int* vis = reinterpret_cast<int*>(votes + n_tiles);
  int* n_vis = vis + n_tiles;

  const long qoff = ((long)b * K + kh) * G * hd;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i - g * HD;
    qs[i] = d < hd ? q[qoff + (long)g * hd + d] : 0.f;
  }
  for (int t = warp; t < n_tiles; t += nwarps) {
    const int p = src.pos(t, lane);
    const int dlt = qp - p;
    const bool ok = p >= 0 && (!causal || dlt >= 0) &&
                    (window <= 0 || dlt < window);
    const unsigned vote = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) votes[t] = vote;
  }
  __syncthreads();
  if (warp == 0) {                   // the visible tiles, in order
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool seen = t < n_tiles && votes[t] != 0u;
      const unsigned ball = __ballot_sync(0xffffffffu, seen);
      if (seen) vis[n + __popc(ball & ((1u << lane) - 1u))] = t;
      n += __popc(ball);
    }
    if (lane == 0) *n_vis = n;
  }
  __syncthreads();
  const int nv = *n_vis;

  auto issue = [&](int t, int stage) {
    unsigned char* ks = ring + stage * Gm::kStageBytes;
    const int rows = src.rows(t);
    stage_rows<T>(ks, Gm::kStride, src.kbase(t), src.row_stride, rows, hd,
                  HD, copy);
    stage_rows<T>(ks + Gm::kTileBytes, Gm::kStride, src.vbase(t),
                  src.row_stride, rows, hd, HD, copy);
  };

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  const float* qrow = qs + warp * HD;

#pragma unroll
  for (int st = 0; st < Gm::kStages - 1; ++st) {
    if (st < nv) issue(vis[st], st);
    cp_async_commit();
  }
  for (int i = 0; i < nv; ++i) {
    cp_async_wait<Gm::kStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration i - 1, finished by
    // every thread at the barrier above
    const int nx = i + Gm::kStages - 1;
    if (nx < nv) issue(vis[nx], nx % Gm::kStages);
    cp_async_commit();
    const int t = vis[i];
    const float kstep = src.kstep(t), vstep = src.vstep(t);
    const bool valid = (votes[t] >> lane) & 1u;
    const unsigned char* ks = ring + (i % Gm::kStages) * Gm::kStageBytes;
    const unsigned char* vs = ks + Gm::kTileBytes;

    // s = q . k_lane over the raw mantissas, four chains
    const T* krow = reinterpret_cast<const T*>(ks + lane * Gm::kStride);
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < Gm::kChunks; ++c) {
      float kf[EPC];
      load_vals<T, EPC>(krow + c * EPC, kf);
#pragma unroll
      for (int x = 0; x < EPC; x += 4) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qrow + c * EPC + x);
        s4[0] = fmaf(qv.x, kf[x + 0], s4[0]);
        s4[1] = fmaf(qv.y, kf[x + 1], s4[1]);
        s4[2] = fmaf(qv.z, kf[x + 2], s4[2]);
        s4[3] = fmaf(qv.w, kf[x + 3], s4[3]);
      }
    }
    const float s = ((s4[0] + s4[1]) + (s4[2] + s4[3])) * kstep;
    const float si = valid ? s * scale : kNeg;
    const float m_new = fmaxf(m, warp_max(si));
    const float p = valid ? expf(si - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= corr;
    m = m_new;
    const float pv = p * vstep;     // p * (mantissa * step), exactly
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pv, j);
      float vf[DPL];
      load_vals<T, DPL>(
          reinterpret_cast<const T*>(vs + j * Gm::kStride) + lane * DPL, vf);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[d] = fmaf(pj, vf[d], acc[d]);
    }
  }
  cp_async_wait<0>();
  const long row = ((long)b * K + kh) * G + warp;
  if (gridDim.z == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int dd = lane * DPL + d;
      if (dd < hd) out[row * hd + dd] = acc[d] * inv;
    }
    return;
  }
  const long rows = (long)B * K * G;
  float* wacc = ws + (split * rows + row) * hd;
#pragma unroll
  for (int d = 0; d < DPL; ++d) {
    const int dd = lane * DPL + d;
    if (dd < hd) wacc[dd] = acc[d];
  }
  if (lane == 0) {
    ws[gridDim.z * rows * hd + split * rows + row] = m;
    ws[gridDim.z * rows * (hd + 1) + split * rows + row] = l;
  }
}

// Merge the S partials of query row blockIdx.x in split order, one thread
// per head dim (blockDim.x = hd); the layout of decode_split's workspace.
__device__ __forceinline__ void combine_splits(const float* __restrict__ ws,
                                               float* __restrict__ out,
                                               int S, long rows, int hd) {
  const long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* ms = ws + (long)S * rows * hd;
  const float* ls = ms + (long)S * rows;
  float mstar = -INFINITY;
  for (int s = 0; s < S; ++s) mstar = fmaxf(mstar, ms[s * rows + row]);
  float l = 0.f, o = 0.f;
  if (mstar != -INFINITY) {          // else no split saw a key: 0
    for (int s = 0; s < S; ++s) {
      const float m = ms[s * rows + row];
      const float w = m == -INFINITY ? 0.f : expf(m - mstar);
      l += ls[s * rows + row] * w;
      o += ws[((long)s * rows + row) * hd + d] * w;
    }
  }
  out[row * hd + d] = o / fmaxf(l, 1e-30f);
}

// hd -> the DPL of the instance that takes it: ceil(hd / 32), 1..8.
__host__ __device__ inline int dpl_of(int hd) { return (hd + 31) / 32; }

}  // namespace attn
