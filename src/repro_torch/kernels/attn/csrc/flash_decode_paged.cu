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
// scalar load per thread per key.  The design now:
//   * a split over the pages (flash-decoding), the card's form of the TPU
//     kernel's sequential page axis: grid (K, B, S), each block takes a
//     contiguous range of `pps` block-table entries (the wrapper picks S
//     so that K * B * S fills a wave of SMs) and writes its partial
//     (m, l, acc) to a workspace; flash_decode_paged_kernel_combine merges
//     the S partials of each query row in split order (deterministic):
//     m* = max m_s, l* = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*)
//     / max(l*, 1e-30).  A split that sees no key has m = -inf, l = 0,
//     acc = 0 and weighs exactly 0; a row that sees no key in any split
//     gives 0.  With S = 1 the block writes the output itself;
//   * visibility first: the block reads the positions of all its tiles at
//     once and keeps each 32-key tile's vote (a ballot of its visible
//     lanes); tiles no lane sees are never loaded (they would add exact
//     zeros), so unmapped blocks of short requests cost one pos load;
//   * loads in flight: the raw mantissas of the visible tiles are copied
//     with 16-byte cp.async into a ring of stages in shared memory (3 for
//     int8/int16, 2 for f32), two tiles ahead of the one being used, and
//     dequantized when read: the page's step, a power of two, is applied
//     to the dot product and to the softmax weight, which changes no bit
//     against dequantizing each element;
//   * the head dimension is a template (hd = 32 * DPL): the q.k dot
//     product reads 16 bytes of a key row at a time, fully unrolled, in
//     four independent chains; each lane holds DPL consecutive dims of
//     the accumulator and reads them from a V row in one vector load.
// One warp per query row of the head's group (blockDim = 32 * G), one lane
// per key of a tile; the online softmax is K3's (attn_common.cuh), whose
// functions K3, K4 and K6 keep using unchanged.
#include "attn_common.cuh"

namespace {

using namespace attn;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out);
template <>
__device__ __forceinline__ void unpack<int8_t>(uint32_t w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}
template <>
__device__ __forceinline__ void unpack<int16_t>(uint32_t w, float* out) {
  out[0] = static_cast<float>(static_cast<int16_t>(w & 0xffffu));
  out[1] = static_cast<float>(static_cast<int16_t>(w >> 16));
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

// Shared-memory geometry: a raw K or V tile is 32 rows of hd values of T,
// each row padded by 16 bytes so that the 16-byte row reads of a quarter
// warp hit distinct banks and every row starts 16-byte aligned.
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

// Dynamic shared memory of one block, bytes: the stage ring, the query
// rows (f32) and one vote and one index per tile of the block's range.
template <typename T, int DPL>
size_t smem_bytes(int G, int n_tiles) {
  using Gm = Geo<T, DPL>;
  return (size_t)Gm::kStages * Gm::kStageBytes +
         (size_t)G * Gm::kHd * sizeof(float) + (size_t)n_tiles * 8 + 16;
}

template <typename T, int DPL>
__global__ void __launch_bounds__(1024) flash_decode_paged_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ bt,
    const int* __restrict__ pos, const int* __restrict__ qpos,
    const float* __restrict__ steps, float* __restrict__ out,
    float* __restrict__ ws, int B, int nblocks, int P, int K, int G,
    float scale, int window, int causal, int pps) {
  using Gm = Geo<T, DPL>;
  constexpr int HD = Gm::kHd;
  constexpr int EPC = 16 / (int)sizeof(T);      // values per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + Gm::kStages * Gm::kStageBytes);
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int blk0 = split * pps;
  const int n_tiles = max(min(pps, nblocks - blk0), 0) * (P / kTile);
  unsigned* votes = reinterpret_cast<unsigned*>(qs + G * HD);
  int* vis = reinterpret_cast<int*>(votes + n_tiles);
  int* n_vis = vis + n_tiles;

  const long qoff = ((long)b * K + kh) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) qs[i] = q[qoff + i];
  const int qp = qpos[b];
  const int* bt_row = bt + (long)b * nblocks;
  const int* pos_row = pos + (long)b * nblocks * P + (long)blk0 * P;
  for (int t = warp; t < n_tiles; t += nwarps) {
    const int p = pos_row[t * kTile + lane];
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

  // tile t of the range: rows (blk0 * P + t * 32) .. + 32 of one page
  auto issue = [&](int t, int stage) {
    const int w0 = t * kTile;
    const int page = bt_row[blk0 + w0 / P];
    const long base = (((long)page * P + w0 % P) * K + kh) * HD;
    unsigned char* ks = ring + stage * Gm::kStageBytes;
    unsigned char* vs = ks + Gm::kTileBytes;
    for (int i = threadIdx.x; i < kTile * Gm::kChunks; i += blockDim.x) {
      const int j = i / Gm::kChunks, c = i - j * Gm::kChunks;
      const long off = base + (long)j * K * HD;
      cp_async16(ks + j * Gm::kStride + c * 16,
                 reinterpret_cast<const unsigned char*>(k + off) + c * 16);
      cp_async16(vs + j * Gm::kStride + c * 16,
                 reinterpret_cast<const unsigned char*>(v + off) + c * 16);
    }
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
    const int page = bt_row[blk0 + t * kTile / P];
    const float kstep = steps[2 * page], vstep = steps[2 * page + 1];
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
    for (int d = 0; d < DPL; ++d) out[row * HD + lane * DPL + d] = acc[d] * inv;
    return;
  }
  // partials: acc [S, rows, hd], then m [S, rows], then l [S, rows]
  const long rows = (long)B * K * G;
  float* wacc = ws + (split * rows + row) * HD;
#pragma unroll
  for (int d = 0; d < DPL; ++d) wacc[lane * DPL + d] = acc[d];
  if (lane == 0) {
    ws[gridDim.z * rows * HD + split * rows + row] = m;
    ws[gridDim.z * rows * (HD + 1) + split * rows + row] = l;
  }
}

// One block per query row, one thread per head dim: merge the S partials
// of the row in split order.
__global__ void flash_decode_paged_kernel_combine(const float* __restrict__ ws,
                                                  float* __restrict__ out,
                                                  int S, int rows, int hd) {
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

template <typename T, int DPL>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* bt, const int* pos, const int* qpos,
                   const float* steps, float* out, float* ws, int B,
                   int nblocks, int P, int K, int G, float scale, int window,
                   int causal, int splits, int pps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DPL>(G, pps * (P / kTile));
  cudaError_t err = allow_smem(flash_decode_paged_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_paged_kernel<T, DPL>
      <<<dim3(K, B, splits), 32 * G, smem, stream>>>(
          q, static_cast<const T*>(k), static_cast<const T*>(v), bt, pos,
          qpos, steps, out, ws, B, nblocks, P, K, G, scale, window, causal,
          pps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_decode_paged_kernel_combine<<<B * K * G, 32 * DPL, 0, stream>>>(
      ws, out, splits, B * K * G, 32 * DPL);
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
                          nblocks, P, K, G, scale, window, causal, splits, \
                          pps, s);
  switch (hd / 32) {
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.  P
// must be a multiple of 32 and hd a multiple of 32 up to 256; the arenas
// 16-byte aligned.  The block table's entries are cut into `splits`
// ranges of `pps` entries; with splits > 1, ws is an f32 workspace of
// splits * B * K * G * (hd + 2) floats.  Returns the cudaError_t of the
// first launch, else of the second (0 on success).
extern "C" int flash_decode_paged_launch(
    const float* q, const void* k, const void* v, const int* bt,
    const int* pos, const int* qpos, const float* steps, float* out,
    float* ws, int B, int nblocks, int P, int K, int G, int hd, int kv_dtype,
    float scale, int window, int causal, int splits, int pps, void* stream) {
  if (B < 1 || nblocks < 1 || P < kTile || P % kTile != 0 || K < 1 ||
      G < 1 || G > 32 || hd < 32 || hd > 256 || hd % 32 != 0 ||
      B > 65535 || splits < 1 || splits > 65535 || pps < 1 ||
      (long)(splits - 1) * pps >= nblocks ||
      (long)splits * pps < nblocks || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(k) || !aligned16(v))
    return (int)cudaErrorMisalignedAddress;
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
