// What the flash-prefill kernels K4 (slot-major ring, flash_prefill.cu)
// and K6 (paged arena, flash_prefill_paged.cu) share, for Hopper
// (sm_90a): one implementation of the tensor-core design, which the two
// sources instantiate with their own way of finding a history tile's rows
// and steps (a `Src`, as decode_common.cuh's decode_split takes one).
//
// What bounds it on an H100: operations.  One K4 chunk (B=1, C=128, p0=256
// history + 128 self keys, K=8, G=4, hd=128, int8) needs 672 MFLOP of
// unmasked work and moves ~6 MB: 10 us at the 67 TFLOP/s of f32 outside
// the tensor cores, 3.0 us on this route (1.48 GFLOP of TF32 products:
// 2 a term on the history, 3 on the chunk's own keys) at 495 TFLOP/s,
// 1.8 us by bytes (attn/cases.py prefill_bounds, prefill_paged_bounds).
// The first versions ran every q.k and p.v as scalar FMAs from shared
// memory, 29x (K4) and 38x (K6) their f32 bounds.  The design:
//   * tiles: each (slot, kv head) is Q [C*G, hd] (row r = c*G + g) against
//     the keys; a block of 8 warps owns 128 query rows (a warp 16; 2 warps
//     past hd = 128, for shared memory) and walks 32-key tiles: the
//     history's tiles (0 <= pos < p0; ring rows for K4, the rows of one
//     page for K6, whose page size is a multiple of 32), then the chunk's
//     own tiles (self, j < n_valid), one list, through a 2-stage cp.async
//     ring; one block fills an SM's shared memory, so 8 warps an SM hide
//     the latency of the fragment reads and the mma chains;
//   * products on TF32 mma.sync.m16n8k8 at f32 accuracy, as K2 does: an
//     operand exact in TF32 goes in one piece — int8 mantissas, with the
//     tile's step applied to the score and to the weight after the
//     product, a power of two and so exact — and any other (q, p, int16
//     mantissas, f32 history, the chunk's own K/V) as hi = tf32(x) plus
//     lo = tf32((x - hi) * 2^12), lo kept 2^12 clear of subnormals (the
//     rounding by an integer add and mask, the int8/int16 conversion by
//     decode_common.cuh's unpack, both at full rate); the products hi*hi
//     plus the cross terms, lo terms in their own fragment.  On the int8
//     main path that is 2 products for q.k and 2 for p.v.  Each 32-wide
//     slice of a reduction (32 dims of q.k, the 32 keys of a tile for
//     p.v) accumulates in a fresh fragment that is added to the running
//     sum in f32, so the tensor cores never sum more than 32 products;
//   * the online softmax runs on the accumulator fragments
//     (FlashAttention-2): a thread owns two rows' (m, l), the row max by
//     shuffles in its quad, l summed over the quad at the end; the score
//     fragment is the p.v product's A operand as it stands (tile_mma's
//     fragment orders: the k slots of both products are assigned so that
//     each thread reads 8 contiguous values of a K row and 4 of a V row,
//     rows padded so no read has a bank conflict).  A row with every key
//     masked gives 0;
//   * staging: tiles are copied raw with cp.async into a ring of stages
//     (decode_common.cuh's stage_rows: 16-byte copies where rows allow,
//     rows past the source's and dims past hd written as zeros), ahead of
//     the tile in use; history tiles that no row of the block sees are
//     skipped by their votes (a K6 tile of a null page, whose positions
//     are all -1, among them), self tiles outside the causal and window
//     range of the block's rows by arithmetic (exact: they add zeros);
//   * filling the card: each block lists the tiles its rows see and takes
//     the s-th of S even parts of that list (grid (C*G / rows, K, B*S)),
//     so the splits share the visible tiles whatever the history holds;
//     each split writes its partial (m, l, acc) and the source's combine
//     kernel merges them in split order, as K3 does (deterministic, no
//     atomics).  The wrappers' prefill_plan / prefill_paged_plan pick S
//     from sweeps on the card (tools/attn_plan_sweep.py, PERF.md);
//   * the query rows come in with cp.async, all at once, and are split
//     into hi and lo planes in place.
// Any hd <= 256 runs on the instance of the next multiple of 32 (dims past
// hd zero), any G, B and K up to 65535.
#pragma once

#include "decode_common.cuh"

namespace attn {

constexpr float kLoScale = 4096.f;     // lo parts are kept times 2^12
constexpr float kLoUnscale = 1.f / 4096.f;

// The bits of x rounded to TF32 (nearest, ties away from zero), low 13
// bits zero: half of the dropped bits added to the magnitude, then
// cleared — what cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions at full rate.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits((x - __uint_as_float(hi)) * kLoScale);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand value (read from storage type TS) as TF32 parts: int8
// mantissas are exact (hi only); everything else is split.
template <typename TS>
struct Operand {
  static constexpr bool kSplit = sizeof(TS) > 1;
  __device__ static void get(float x, uint32_t& hi, uint32_t& lo) {
    if constexpr (kSplit) {
      split_tf32(x, hi, lo);
    } else {
      hi = __float_as_uint(x);
      lo = 0u;
    }
  }
};

// Row strides (bytes) of a staged K or V tile of HD values of TS, padded
// so that each fragment read of a warp is free of bank conflicts: a K row
// is read 8 values at a time (thread t of row g at dims 8t..8t+7), which
// wants a stride of 8 (int8), 16 (int16) or 4 (f32) words mod 32; a V row
// 4 values at a time (thread g at 4(8 jg + g)), which wants 4.  Every row
// stays 16-byte aligned.
__host__ __device__ constexpr int padded_row(int words, int want) {
  return 4 * (words + (want - words % 32 + 32) % 32);
}
template <typename TS>
__host__ __device__ constexpr int k_stride(int hd_pad) {
  return padded_row(hd_pad * (int)sizeof(TS) / 4,
                    sizeof(TS) == 1 ? 8 : sizeof(TS) == 2 ? 16 : 4);
}
template <typename TS>
__host__ __device__ constexpr int v_stride(int hd_pad) {
  return padded_row(hd_pad * (int)sizeof(TS) / 4, 4);
}

// Warps per block: 8 (128 query rows) up to hd = 128, else 2, as shared
// memory allows; one block per SM either way.
__host__ __device__ constexpr int warps_for(int dpl) { return dpl <= 4 ? 8 : 2; }

template <int DPL>
struct PGeo {
  static constexpr int kHd = 32 * DPL;
  static constexpr int kWarps = warps_for(DPL);
  static constexpr int kRows = 16 * kWarps;             // query rows
  static constexpr int kQStride = kHd + 4;              // floats
  // a stage: a K and a V tile of 32 rows at f32's strides (the chunk's
  // own tiles); a history tile of T uses part of it
  static constexpr int kKBytes = kTile * k_stride<float>(kHd);
  static constexpr int kStageBytes = kKBytes + kTile * v_stride<float>(kHd);
  static constexpr int kStages = 2;
  static constexpr size_t kQBytes = 2ull * kRows * kQStride * 4;  // hi, lo
  static constexpr size_t kFixed = (size_t)kStages * kStageBytes + kQBytes;
};

template <int DPL>
size_t prefill_smem_bytes(int n_list) {
  return PGeo<DPL>::kFixed + (size_t)n_list * 8 + 16;
}

// Per-thread state of a warp's 16 rows: rows g and g + 8 of the warp.
// o[j][x]: output tile j = 4 jg + jj, x = 2h + e: row g + 8h, head dim
// 4 (8 jg + 2t + e) + jj (the p.v product's column order, below).
template <int DPL>
struct Acc {
  float o[4 * DPL][4];
  float m[2], l[2];
};

// One staged 32-key tile through the warp's 16 rows.  ks/vs: the tile's
// K and V rows (storage TS, strides k_stride / v_stride); qh/ql: the
// warp's first Q row (hi / lo planes, stride QS floats); kpos/kok: the
// absolute position and availability of this thread's 8 keys (key
// n*8 + 2t + e at [n][e]); qa/qb and oka/okb: its two rows' absolute
// positions and whether they are valid rows.
//
// Fragment orders (m16n8k8: thread (g, t) = (lane / 4, lane % 4)).  The
// sums over the k index do not care which value sits in which k slot, so
// the slots are assigned to make each thread's reads contiguous:
//   q.k, k step s of a 32-dim slice at d0: slot t <-> dim d0 + 8t + 2s,
//     slot t + 4 <-> d0 + 8t + 2s + 1 (a thread reads 8 dims of a row);
//   p.v, k step n: slot t <-> key 8n + 2t, slot t + 4 <-> key 8n + 2t + 1,
//     so the score fragment is the A operand as it stands; output tile
//     j = 4 jg + jj, column c <-> head dim 4 (8 jg + c) + jj (a thread
//     reads 4 consecutive values of a V row).
template <typename TS, int DPL, int QS>
__device__ __forceinline__ void tile_mma(
    Acc<DPL>& st, const unsigned char* ks, const unsigned char* vs,
    const float* qh, const float* ql, const int (&kpos)[4][2],
    const bool (&kok)[4][2], int qa, int qb, bool oka, bool okb,
    float kstep, float vstep, float scale, int window, int causal,
    int lane) {
  constexpr int HD = 32 * DPL;
  constexpr int KS = k_stride<TS>(HD), VS = v_stride<TS>(HD);
  constexpr bool kSplit = Operand<TS>::kSplit;
  const int g = lane / 4, t = lane % 4;

  // S = Q K^T over 32-dim slices, hi*hi + (lo*hi [+ hi*lo]) * 2^-12
  float s[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[n][x] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < HD; d0 += 32) {
    float qv[4][8];                    // hi row g, hi g + 8, lo g, lo g + 8
    load_vals<float, 8>(qh + g * QS + d0 + 8 * t, qv[0]);
    load_vals<float, 8>(qh + (g + 8) * QS + d0 + 8 * t, qv[1]);
    load_vals<float, 8>(ql + g * QS + d0 + 8 * t, qv[2]);
    load_vals<float, 8>(ql + (g + 8) * QS + d0 + 8 * t, qv[3]);
    uint32_t bh[4][8], bl[4][8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float kf[8];
      load_vals<TS, 8>(
          reinterpret_cast<const TS*>(ks + (n * 8 + g) * KS) + d0 + 8 * t,
          kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) Operand<TS>::get(kf[i], bh[n][i], bl[n][i]);
    }
    float ph[4][4], pl[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) ph[n][x] = pl[n][x] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t ah[4] = {
          __float_as_uint(qv[0][2 * k]), __float_as_uint(qv[1][2 * k]),
          __float_as_uint(qv[0][2 * k + 1]), __float_as_uint(qv[1][2 * k + 1])};
      const uint32_t al[4] = {
          __float_as_uint(qv[2][2 * k]), __float_as_uint(qv[3][2 * k]),
          __float_as_uint(qv[2][2 * k + 1]), __float_as_uint(qv[3][2 * k + 1])};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t b[2] = {bh[n][2 * k], bh[n][2 * k + 1]};
        mma(ph[n], ah, b);
        mma(pl[n], al, b);
        if (kSplit) {
          const uint32_t c[2] = {bl[n][2 * k], bl[n][2 * k + 1]};
          mma(pl[n], ah, c);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] += ph[n][x] + pl[n][x] * kLoUnscale;
  }

  // online softmax on the fragment: x = 0, 1 row g (keys 2t, 2t + 1 of
  // each n8 tile), x = 2, 3 row g + 8
  const float sc = kstep * scale;
  float mx[2] = {kNeg, kNeg};
  bool valid[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int e = x & 1, h = x >> 1;
      const int dlt = (h ? qb : qa) - kpos[n][e];
      const bool ok = (h ? okb : oka) && kok[n][e] &&
                      (!causal || dlt >= 0) && (window <= 0 || dlt < window);
      valid[n][x] = ok;
      s[n][x] = ok ? s[n][x] * sc : kNeg;
      mx[h] = fmaxf(mx[h], s[n][x]);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    corr[h] = expf(st.m[h] - m_new);
    st.m[h] = m_new;
    st.l[h] *= corr[h];
  }
  uint32_t pa_h[4][4], pa_l[4][4];     // A fragments of p, by key step n
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float p[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int h = x >> 1;
      p[x] = valid[n][x] ? expf(s[n][x] - st.m[h]) : 0.f;
      st.l[h] += p[x];
    }
    // a0 = (row g, key 2t), a1 = (g + 8, 2t), a2 = (g, 2t + 1),
    // a3 = (g + 8, 2t + 1)
    split_tf32(p[0], pa_h[n][0], pa_l[n][0]);
    split_tf32(p[2], pa_h[n][1], pa_l[n][1]);
    split_tf32(p[1], pa_h[n][2], pa_l[n][2]);
    split_tf32(p[3], pa_h[n][3], pa_l[n][3]);
  }
#pragma unroll
  for (int j = 0; j < 4 * DPL; ++j) {
#pragma unroll
    for (int x = 0; x < 4; ++x) st.o[j][x] *= corr[x >> 1];
  }

  // O += P V, four output tiles at a time, each in a fresh fragment
#pragma unroll
  for (int jg = 0; jg < DPL; ++jg) {
    float oh[4][4], ol[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x) oh[jj][x] = ol[jj][x] = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v0[4], v1[4];
      const int off = 4 * (8 * jg + g);
      load_vals<TS, 4>(
          reinterpret_cast<const TS*>(vs + (n * 8 + 2 * t) * VS) + off, v0);
      load_vals<TS, 4>(
          reinterpret_cast<const TS*>(vs + (n * 8 + 2 * t + 1) * VS) + off,
          v1);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bh[2], bl[2];
        Operand<TS>::get(v0[jj], bh[0], bl[0]);
        Operand<TS>::get(v1[jj], bh[1], bl[1]);
        mma(oh[jj], pa_h[n], bh);
        mma(ol[jj], pa_l[n], bh);
        if (kSplit) mma(ol[jj], pa_h[n], bl);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        st.o[4 * jg + jj][x] += (oh[jj][x] + ol[jj][x] * kLoUnscale) * vstep;
  }
}

// The arguments of a prefill call that do not depend on where the
// history lives.  q/out: f32 [B, C, K, G, hd]; kn/vn: f32 [B, C, K, hd]
// (the chunk's own K/V); pos: int32 [B, W], the logical position of each
// history row (-1: empty); p0s/nvs: int32 [B]; ws (S > 1): acc [S, rows,
// hd], then m [S, rows], then l [S, rows], rows = B * C * K * G; copy_*:
// the CopyMode of the query rows, the history rows and the chunk's rows.
struct PrefillArgs {
  const float* q;
  const float* kn;
  const float* vn;
  const int* pos;
  const int* p0s;
  const int* nvs;
  float* out;
  float* ws;
  int B, C, W, K, G, hd;
  float scale;
  int window, causal, S, copy_q, copy_h, copy_s;
};

// One split of a prefill: the block (query-row tile blockIdx.x, kv head
// blockIdx.y, slot and split blockIdx.z = b * S + s) walks its share of
// the tiles its rows see.  Src provides, for history tile t (the slot's
// logical rows t*32 .. t*32 + 31) of this block's kv head:
//   long row_stride;                                  (elements of T)
//   const T* kbase(t), vbase(t): its row 0;
//   int rows(t): its rows that exist (the rest are staged as zeros);
//   float kstep(t), vstep(t): its steps.
// The block's list of tiles: the history tiles 0 .. nh - 1 that some row
// of the block sees, then the chunk tiles nh .. nh + ns - 1 that hold a
// key some row sees; split s of S takes list entries [s n / S,
// (s + 1) n / S) of the n it has, so the splits share the visible tiles
// evenly whatever the history holds.
template <typename T, int DPL, typename Src>
__device__ __forceinline__ void prefill_split(const Src& src,
                                              const PrefillArgs& a) {
  using Gm = PGeo<DPL>;
  constexpr int HD = Gm::kHd, QS = Gm::kQStride, WARPS = Gm::kWarps;
  const float* __restrict__ q = a.q;
  const float* __restrict__ kn = a.kn;
  const float* __restrict__ vn = a.vn;
  const int* __restrict__ pos = a.pos;
  float* __restrict__ out = a.out;
  float* __restrict__ ws = a.ws;
  const int B = a.B, C = a.C, W = a.W, K = a.K, G = a.G, hd = a.hd;
  const int window = a.window, causal = a.causal, S = a.S;
  const float scale = a.scale;
  const int nh = (W + kTile - 1) / kTile, ns = (C + kTile - 1) / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qh = reinterpret_cast<float*>(smem + Gm::kStages * Gm::kStageBytes);
  float* ql = qh + Gm::kRows * QS;
  int* list = reinterpret_cast<int*>(ql + Gm::kRows * QS);
  int* n_list = list + nh + ns;
  unsigned* votes = reinterpret_cast<unsigned*>(n_list + 1);

  const int kh = blockIdx.y, b = blockIdx.z / S, split_id = blockIdx.z % S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int R = C * G, r0 = blockIdx.x * Gm::kRows;
  const int p0 = a.p0s[b], nv = a.nvs[b];
  // the block's rows: chunk positions c_first .. c_last, valid below nv
  const int c_first = r0 / G;
  const int c_last = min(R - 1, r0 + Gm::kRows - 1) / G;
  const bool any_row = c_first < nv;

  auto row_off = [&](int r) {          // q/out row r = c*G + g
    const int c = r / G, g = r - c * G;
    return (((long)b * C + c) * K + kh) * G * hd + (long)g * hd;
  };
  // the block's query rows: raw f32 into the hi plane, every row in
  // flight at once (cp.async) while the votes are taken, rows past R and
  // dims past hd zero; then each value split in place into its hi and lo
  // planes
  const int qw = a.copy_q == kCopy16 ? 4 : 1;
  for (int i = threadIdx.x; i < Gm::kRows * (hd / qw); i += blockDim.x) {
    const int rr = i / (hd / qw), c = (i - rr * (hd / qw)) * qw;
    const int r = r0 + rr;
    float* dst = qh + rr * QS + c;
    if (r >= R) {
      for (int e = 0; e < qw; ++e) dst[e] = 0.f;
    } else if (qw == 4) {
      cp_async16(dst, q + row_off(r) + c);
    } else {
      cp_async4(dst, q + row_off(r) + c);
    }
  }
  for (int i = threadIdx.x; i < Gm::kRows * (HD - hd); i += blockDim.x)
    qh[(i / (HD - hd)) * QS + hd + i % (HD - hd)] = 0.f;
  cp_async_commit();
  // history votes: a tile is loaded if some key in it is history
  // (0 <= pos < p0) within the window of the block's first row (the most
  // permissive; causal holds for every history key)
  const int* pos_row = pos + (long)b * W;
  for (int t = warp; t < nh; t += WARPS) {
    const int w = t * kTile + lane;
    const int p = w < W ? pos_row[w] : -1;
    const bool ok = any_row && p >= 0 && p < p0 &&
                    (window <= 0 || p0 + c_first - p < window);
    const unsigned vote = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) votes[t] = vote;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < nh; t0 += 32) {
      const int t = t0 + lane;
      const bool seen = t < nh && votes[t] != 0u;
      const unsigned ball = __ballot_sync(0xffffffffu, seen);
      if (seen) list[n + __popc(ball & ((1u << lane) - 1u))] = t;
      n += __popc(ball);
    }
    if (lane == 0) {
      // self tiles that hold a key some row of the block sees
      const int j_hi = causal ? min(nv, c_last + 1) : nv;
      const int j_lo = window > 0 ? c_first - window + 1 : 0;
      for (int t = nh; t < nh + ns; ++t) {
        const int j0 = (t - nh) * kTile;
        if (any_row && j0 < j_hi && j0 + kTile > j_lo) list[n++] = t;
      }
      *n_list = n;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < Gm::kRows * HD; i += blockDim.x) {
    const int off = (i / HD) * QS + i % HD;
    uint32_t h, l;
    split_tf32(qh[off], h, l);
    qh[off] = __uint_as_float(h);
    ql[off] = __uint_as_float(l);
  }
  __syncthreads();
  const int n_all = *n_list;
  const int e0 = (int)((long)n_all * split_id / S);
  const int n_tiles = (int)((long)n_all * (split_id + 1) / S) - e0;
  list += e0;

  auto issue = [&](int t, int stage) {
    unsigned char* ks = ring + stage * Gm::kStageBytes;
    unsigned char* vs = ks + Gm::kKBytes;
    if (t < nh) {
      const int rows = src.rows(t);
      stage_rows<T>(ks, k_stride<T>(HD), src.kbase(t), src.row_stride, rows,
                    hd, HD, a.copy_h);
      stage_rows<T>(vs, v_stride<T>(HD), src.vbase(t), src.row_stride, rows,
                    hd, HD, a.copy_h);
    } else {
      const int j0 = (t - nh) * kTile;
      const long off = (((long)b * C + j0) * K + kh) * hd;
      const int rows = min(kTile, C - j0);
      stage_rows<float>(ks, k_stride<float>(HD), kn + off, (long)K * hd,
                        rows, hd, HD, a.copy_s);
      stage_rows<float>(vs, v_stride<float>(HD), vn + off, (long)K * hd,
                        rows, hd, HD, a.copy_s);
    }
  };

  Acc<DPL> st;
#pragma unroll
  for (int j = 0; j < 4 * DPL; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) st.o[j][x] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
  const int g = lane / 4, tq = lane % 4;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int ca = ra / G, cb = rb / G;
  const bool oka = ra < R && ca < nv, okb = rb < R && cb < nv;
  const float* qhw = qh + warp * 16 * QS;
  const float* qlw = ql + warp * 16 * QS;

#pragma unroll
  for (int s = 0; s < Gm::kStages - 1; ++s) {
    if (s < n_tiles) issue(list[s], s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<Gm::kStages - 2>();
    __syncthreads();
    const int nx = i + Gm::kStages - 1;
    if (nx < n_tiles) issue(list[nx], nx % Gm::kStages);
    cp_async_commit();
    const int t = list[i];
    const unsigned char* ks = ring + (i % Gm::kStages) * Gm::kStageBytes;
    const unsigned char* vs = ks + Gm::kKBytes;
    int kpos[4][2];
    bool kok[4][2];
    if (t < nh) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int w = t * kTile + n * 8 + 2 * tq + e;
          const int p = w < W ? pos_row[w] : -1;
          kpos[n][e] = p;
          kok[n][e] = p >= 0 && p < p0;
        }
      tile_mma<T, DPL, QS>(st, ks, vs, qhw, qlw, kpos, kok, p0 + ca,
                           p0 + cb, oka, okb, src.kstep(t), src.vstep(t),
                           scale, window, causal, lane);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = (t - nh) * kTile + n * 8 + 2 * tq + e;
          kpos[n][e] = p0 + j;
          kok[n][e] = j < nv;
        }
      tile_mma<float, DPL, QS>(st, ks, vs, qhw, qlw, kpos, kok, p0 + ca,
                               p0 + cb, oka, okb, 1.f, 1.f, scale, window,
                               causal, lane);
    }
  }
  cp_async_wait<0>();

  // l over the quad; acc / l (or the split's partial acc) goes through
  // the warp's own Q rows in shared memory (no other warp reads them), so
  // each row leaves in coalesced stores
  const long rows_all = (long)B * C * K * G;
  float* ob = qh + warp * 16 * QS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
    const float mul = S == 1 ? 1.f / fmaxf(st.l[h], 1e-30f) : 1.f;
    const int r = h ? rb : ra;
    if (S > 1 && tq == 0 && r < R) {
      const long row = row_off(r) / hd;
      ws[S * rows_all * hd + split_id * rows_all + row] = st.m[h];
      ws[S * rows_all * (hd + 1) + split_id * rows_all + row] = st.l[h];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4 * DPL; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ob[(g + 8 * h) * QS + 4 * (8 * (j / 4) + 2 * tq + e) + j % 4] =
            st.o[j][2 * h + e] * mul;
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + warp * 16 + rr;
    if (r >= R) break;
    const long off = row_off(r);
    float* dst = S == 1 ? out + off
                        : ws + ((long)split_id * rows_all + off / hd) * hd;
    for (int d = lane; d < hd; d += 32) dst[d] = ob[rr * QS + d];
  }
}

// Launch one prefill call: `kernel` (a __global__ taking the PrefillArgs
// and then `extra`, the source's own arguments) on grid
// (ceil(C*G / rows), K, B*S), then, with S > 1, `combine` (a __global__
// over combine_splits) on one block per query row.  The instance is DPL's.
template <int DPL, typename Kernel, typename Combine, typename... Extra>
cudaError_t launch_prefill(Kernel kernel, Combine combine,
                           const PrefillArgs& a, cudaStream_t stream,
                           Extra... extra) {
  const size_t smem = prefill_smem_bytes<DPL>((a.W + kTile - 1) / kTile +
                                              (a.C + kTile - 1) / kTile);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = PGeo<DPL>::kRows;
  const long row_tiles = ((long)a.C * a.G + kRows - 1) / kRows;
  if (row_tiles > 2147483647L || (long)a.B * a.S > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, a.K, a.B * a.S);
  kernel<<<grid, 32 * PGeo<DPL>::kWarps, smem, stream>>>(a, extra...);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  const long rows = (long)a.B * a.C * a.K * a.G;
  if (rows > 2147483647L) return cudaErrorInvalidValue;
  combine<<<(unsigned)rows, a.hd, 0, stream>>>(a.ws, a.out, a.S, rows, a.hd);
  return cudaGetLastError();
}

// Go<T, DPL>::run(args...) for the instance that takes the history's
// storage type (kv_dtype 0 int8, 1 int16, 2 float32) and head dim hd.
template <template <typename, int> class Go, typename T, typename... Args>
cudaError_t by_dpl(int hd, const Args&... args) {
  switch (dpl_of(hd)) {
    case 1: return Go<T, 1>::run(args...);
    case 2: return Go<T, 2>::run(args...);
    case 3: return Go<T, 3>::run(args...);
    case 4: return Go<T, 4>::run(args...);
    case 5: return Go<T, 5>::run(args...);
    case 6: return Go<T, 6>::run(args...);
    case 7: return Go<T, 7>::run(args...);
    case 8: return Go<T, 8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, int> class Go, typename... Args>
cudaError_t dispatch(int kv_dtype, int hd, const Args&... args) {
  switch (kv_dtype) {
    case 0: return by_dpl<Go, int8_t>(hd, args...);
    case 1: return by_dpl<Go, int16_t>(hd, args...);
    case 2: return by_dpl<Go, float>(hd, args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
