// K2: quantized matmul with per-operand DFXP rounding fused into the tile
// reads, for Hopper (sm_90a): split-K, cp.async staging, TF32 tensor cores
// at float32 accuracy.
//
// Replaces the Pallas TPU kernel `qmm_2d`
// (src/repro/kernels/qmatmul/qmatmul_kernel.py:78), all three layouts:
//   nn  C[R,C] = q(A)[R,D]   @ q(B)[D,C]     (forward)
//   nt  C[R,C] = q(A)[R,D]   @ q(B)[C,D]^T   (dgrad)
//   tn  C[R,C] = q(A)[D,R]^T @ q(B)[D,C]     (wgrad)
// where q(.) rounds an operand half-to-even onto its own width-bit grid of
// step 2**e and clips it (width 0 = the operand is used raw), exactly as
// the reference's `_load` does per tile.
//
// What bounds it.  The training path's products are skinny (the maxout
// forward [64,784]x[784,1200], dgrad [64,1200]x[240,1200]^T): about a
// microsecond of bytes or tensor-core work, so a 64x64 tiling that gives
// 19 or 4 blocks on 132 SMs, each walking the whole reduction, is bound
// by latency: a lone block of four warps takes ~2 us per 32-deep slice on
// the H100 whatever the depth of its copy ring (PERF.md).  The large
// products (llama3-8B chunk [128,4096]x[4096,14336]) are bound by
// operations.  The design:
//   * split-K: the wrapper's plan (ops.plan) keeps 64x64 tiles where they
//     fill a wave of SMs, and otherwise takes 64x32 tiles and cuts the
//     reduction into S contiguous ranges of >= 2 slices, about two waves
//     of blocks; each split writes its partial tile to an f32 workspace
//     [S, R, C] and a second kernel (qmm_kernel_splitk_reduce) sums the S
//     partials in split order, so the result is bit-identical from run to
//     run (no atomics);
//   * loads in flight: each slice of A and B is copied with 16-byte
//     cp.async into a 3-stage ring in shared memory, so slices k+1 and k+2
//     load while slice k is multiplied; ragged edges (and operands whose
//     rows are not 16-byte aligned) fall back to 4-byte copies that fill
//     zeros out of range;
//   * rounding out of shared memory: once a slice has landed, each thread
//     rounds the chunks it copied itself onto their grid (`qround`, the
//     same rintf and clip as the plain version) and splits them in place,
//     once per element and slice; the copy stays a byte copy, the rounded
//     operand is the plain version's bit for bit, and the mma loop only
//     reads fragments;
//   * TF32 tensor cores at f32 accuracy (mma.sync m16n8k8, f32
//     accumulation).  An operand rounded at width <= 12 is m * 2^e with
//     |m| <= 2^11: at most 11 significant bits, exact in TF32.  Any other
//     operand (raw, or a width of 13..32) is split into hi = tf32(x) and
//     lo = tf32((x - hi) * 2^12); the products hi*hi plus the cross terms
//     lo*hi and hi*lo (lo terms in their own accumulator, scaled back by
//     2^-12 at the end) reproduce the f32 product to about 2^-22 relative
//     per term.  The 2^12 keeps lo in f32's normal range for operands
//     down to ~2^-114, so a flush of subnormal tensor-core inputs cannot
//     drop it there.  Each 32-deep slice accumulates into a fresh
//     register tile that is added to the running sum with an f32 add, so
//     the tensor cores' own accumulation never runs over more than 32
//     products;
//   * the three layouts differ only in how a tile is addressed: each copy
//     walks its operand's contiguous axis, and the fragment reads index
//     shared memory through the layout, so no transposed copy is made.
// Later options (ROADMAP): wgmma (TF32 operands K-major only, so the nn B
// and tn A tiles would need a transpose in shared memory) and TMA for the
// large shapes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BK = 32;
constexpr int kThreads = 128;          // 4 warps as 2 x 2 warp tiles
constexpr int kStages = 3;
constexpr float kLoScale = 4096.f;     // lo parts are kept times 2^12
constexpr float kLoUnscale = 1.f / 4096.f;

struct Grid {
  float step, inv, qmax, qmin;
  bool on;
};

__device__ __forceinline__ float qround(float v, const Grid& g) {
  if (!g.on) return v;
  float m = rintf(v * g.inv);
  if (m > g.qmax) m = g.qmax;
  if (m < g.qmin) m = g.qmin;
  return m * g.step;
}

// x rounded to TF32 (nearest, ties away from zero), low 13 bits zero.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32((x - h) * kLoScale));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes, or 4 zero bytes when !ok (nothing is read then).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a ROWS x COLS tile (COLS along the operand's contiguous axis) from
// src[row0.., col0..] (leading dimension ld, n_rows x n_cols in range) to
// dst (row stride dst_stride floats); out of range reads as 0.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const float* __restrict__ src,
                                          int ld, int n_rows, int n_cols,
                                          int row0, int col0, bool vec) {
  constexpr int kCpr = COLS / 4;                 // 16-byte chunks per row
  constexpr int kN = ROWS * kCpr;
  static_assert(kN % kThreads == 0, "tile must split evenly over threads");
#pragma unroll
  for (int it = 0; it < kN / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kCpr, c = (i % kCpr) * 4;
    const int gr = row0 + r, gc = col0 + c;
    float* d = dst + r * dst_stride + c;
    const bool row_ok = gr < n_rows;
    const float* s = src + (size_t)(row_ok ? gr : 0) * ld;
    if (vec && row_ok && gc + 3 < n_cols) {
      cp_async16(d, s + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && gc + e < n_cols;
        cp_async4(d + e, ok ? s + gc + e : src, ok);
      }
    }
  }
}

// Round (and split) in place the chunks of a ROWS x COLS tile that this
// thread copied in load_tile (the same chunk-to-thread map, so once its
// own copies have landed no barrier is needed before reading them): each
// value onto its grid, then, for a SPLIT operand, hi = tf32(v) stays in
// the tile and lo = tf32((v - hi) * 2^12) goes to the same place in lo.
template <int ROWS, int COLS, bool SPLIT>
__device__ __forceinline__ void transform_tile(float* tile, float* lo,
                                               int stride, const Grid& g) {
  constexpr int kCpr = COLS / 4;
  constexpr int kN = ROWS * kCpr;
#pragma unroll
  for (int it = 0; it < kN / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int off = (i / kCpr) * stride + (i % kCpr) * 4;
    float4 v = *reinterpret_cast<float4*>(tile + off);
    v.x = qround(v.x, g);
    v.y = qround(v.y, g);
    v.z = qround(v.z, g);
    v.w = qround(v.w, g);
    if (SPLIT) {
      uint32_t h[4], l[4];
      split(v.x, h[0], l[0]);
      split(v.y, h[1], l[1]);
      split(v.z, h[2], l[2]);
      split(v.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(tile + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      *reinterpret_cast<float4*>(tile + off) = v;
    }
  }
}

// Shared-memory geometry.  A is [BM][BK] (k contiguous) for nn/nt and
// [BK][BM] for tn; B is [BK][BN] for nn/tn and [BN][BK] for nt.  Row
// strides of 4 (k-contiguous) or 8 (m/n-contiguous) floats past the tile
// keep the fragment reads free of bank conflicts and rows 16-byte
// aligned.  A ring of kStages stages of (A, B), then two lo planes (by
// slice parity) of each split operand.
template <bool A_T, bool B_T, bool A_SPLIT, bool B_SPLIT, int BN>
struct Smem {
  static constexpr int kSa = A_T ? BM + 8 : BK + 4;
  static constexpr int kSb = B_T ? BK + 4 : BN + 8;
  static constexpr int kA = A_T ? BK * kSa : BM * kSa;
  static constexpr int kB = B_T ? BN * kSb : BK * kSb;
  static constexpr int kStage = kA + kB;                 // floats
  static constexpr int kLo = (A_SPLIT ? kA : 0) + (B_SPLIT ? kB : 0);
  static constexpr size_t kBytes =
      ((size_t)kStages * kStage + 2 * (size_t)kLo) * sizeof(float);
};

// A_T: A is stored [D, R] (tn).  B_T: B is stored [C, D] (nt).  A_SPLIT /
// B_SPLIT: that operand is not exact in TF32 and goes as hi + lo.  The
// block computes the BM x BN tile (blockIdx.y, blockIdx.x) over slices
// [blockIdx.z * per, min((blockIdx.z + 1) * per, ceil(D / BK))) and
// writes it to out + blockIdx.z * R * C.
template <bool A_T, bool B_T, bool A_SPLIT, bool B_SPLIT, int BN>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ steps, float* __restrict__ out, int R,
           int C, int D, int width_a, int width_b, int per, int vec_a,
           int vec_b) {
  using S = Smem<A_T, B_T, A_SPLIT, B_SPLIT, BN>;
  constexpr int WN = BN / 2;             // warp tile: 32 x WN
  constexpr int MT = 2, NT = WN / 8;     // m16n8 tiles per warp
  constexpr bool kLo = A_SPLIT || B_SPLIT;
  extern __shared__ __align__(16) float smem[];
  float* lo_planes = smem + kStages * S::kStage;

  Grid ga, gb;
  ga.on = width_a > 0;
  gb.on = width_b > 0;
  ga.step = steps[0];
  ga.inv = steps[1];
  gb.step = steps[2];
  gb.inv = steps[3];
  // the bounds as the reference forms them (qrange, rounded to f32): from
  // width 25 on, 2^(w-1) - 1 rounds to 2^(w-1), as in K1; 1u << 31 is
  // still defined at width 32
  ga.qmax = ga.on ? (float)((1u << (width_a - 1)) - 1u) : 0.f;
  ga.qmin = ga.on ? -(float)(1u << (width_a - 1)) : 0.f;
  gb.qmax = gb.on ? (float)((1u << (width_b - 1)) - 1u) : 0.f;
  gb.qmin = gb.on ? -(float)(1u << (width_b - 1)) : 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;          // mma groupID, thread in group
  const int wm = (warp / 2) * 32, wn = (warp % 2) * WN;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int n_slices = (D + BK - 1) / BK;
  const int s_begin = blockIdx.z * per;
  const int s_end = min(s_begin + per, n_slices);
  const int n = max(s_end - s_begin, 0);

  auto issue = [&](int sl, int stage) {
    float* As = smem + stage * S::kStage;
    float* Bs = As + S::kA;
    const int k0 = (s_begin + sl) * BK;
    if (A_T)
      load_tile<BK, BM>(As, S::kSa, a, R, D, R, k0, r0, vec_a);
    else
      load_tile<BM, BK>(As, S::kSa, a, D, R, D, r0, k0, vec_a);
    if (B_T)
      load_tile<BN, BK>(Bs, S::kSb, b, D, C, D, c0, k0, vec_b);
    else
      load_tile<BK, BN>(Bs, S::kSb, b, C, D, C, k0, c0, vec_b);
  };

  float acc[MT][NT][4], lo[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = lo[i][j][x] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n) issue(st, st);
    cp_async_commit();
  }
  for (int sl = 0; sl < n; ++sl) {
    float* As = smem + (sl % kStages) * S::kStage;
    float* Bs = As + S::kA;
    float* Al = lo_planes + (sl & 1) * S::kLo;
    float* Bl = Al + (A_SPLIT ? S::kA : 0);
    cp_async_wait<kStages - 2>();
    if (A_T)
      transform_tile<BK, BM, A_SPLIT>(As, Al, S::kSa, ga);
    else
      transform_tile<BM, BK, A_SPLIT>(As, Al, S::kSa, ga);
    if (B_T)
      transform_tile<BN, BK, B_SPLIT>(Bs, Bl, S::kSb, gb);
    else
      transform_tile<BK, BN, B_SPLIT>(Bs, Bl, S::kSb, gb);
    // after this barrier the slice is rounded and split for every warp,
    // and every thread has finished iteration sl - 1: its stage may be
    // refilled, and its lo planes (the other parity) are not read again
    // before they are rewritten in iteration sl + 1
    __syncthreads();
    if (sl + kStages - 1 < n)
      issue(sl + kStages - 1, (sl + kStages - 1) % kStages);
    cp_async_commit();
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[i][j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = wm + i * 16 + g + (x & 1) * 8;
          const int k = kk + t + (x >> 1) * 4;
          const int off = A_T ? k * S::kSa + m : m * S::kSa + k;
          ah[i][x] = __float_as_uint(As[off]);
          if (A_SPLIT) al[i][x] = __float_as_uint(Al[off]);
        }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int nn = wn + j * 8 + g;
          const int k = kk + t + x * 4;
          const int off = B_T ? nn * S::kSb + k : k * S::kSb + nn;
          bh[j][x] = __float_as_uint(Bs[off]);
          if (B_SPLIT) bl[j][x] = __float_as_uint(Bl[off]);
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma(part[i][j], ah[i], bh[j]);
          if (A_SPLIT) mma(lo[i][j], al[i], bh[j]);
          if (B_SPLIT) mma(lo[i][j], ah[i], bl[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][j][x] += part[i][j][x];
  }
  cp_async_wait<0>();

  float* dst = out + (size_t)blockIdx.z * R * C;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = r0 + wm + i * 16 + g + (x >> 1) * 8;
        const int col = c0 + wn + j * 8 + 2 * t + (x & 1);
        if (r < R && col < C) {
          float v = acc[i][j][x];
          if (kLo) v += lo[i][j][x] * kLoUnscale;
          dst[(size_t)r * C + col] = v;
        }
      }
}

// c[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order.  The
// loads of eight splits are issued before their adds, so a thread waits
// on memory once per eight splits, not once per split.
template <typename V>
__device__ __forceinline__ void add_to(V& s, const V& x);
template <>
__device__ __forceinline__ void add_to<float>(float& s, const float& x) {
  s += x;
}
template <>
__device__ __forceinline__ void add_to<float4>(float4& s, const float4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

template <typename V>
__device__ __forceinline__ void reduce_splits(const V* __restrict__ ws,
                                              V* __restrict__ c, long n,
                                              int S) {
  constexpr int kBatch = 8;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    V s = ws[i];
    int k = 1;
    for (; k + kBatch <= S; k += kBatch) {
      V x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) x[j] = ws[(long)(k + j) * n + i];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) add_to(s, x[j]);
    }
    for (; k < S; ++k) add_to(s, ws[(long)k * n + i]);
    c[i] = s;
  }
}

__global__ void qmm_kernel_splitk_reduce(const float* __restrict__ ws,
                                         float* __restrict__ c, long n,
                                         int S) {
  if (n % 4 == 0)
    reduce_splits(reinterpret_cast<const float4*>(ws),
                  reinterpret_cast<float4*>(c), n / 4, S);
  else
    reduce_splits(ws, c, n, S);
}

template <bool A_T, bool B_T, bool A_SPLIT, bool B_SPLIT, int BN>
cudaError_t launch_main(const float* a, const float* b, const float* steps,
                        float* out, int R, int C, int D, int width_a,
                        int width_b, int splits, int per, int vec_a,
                        int vec_b, cudaStream_t stream) {
  auto kernel = qmm_kernel<A_T, B_T, A_SPLIT, B_SPLIT, BN>;
  constexpr size_t bytes = Smem<A_T, B_T, A_SPLIT, B_SPLIT, BN>::kBytes;
  static bool opted = false;             // once per instantiation
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM, splits);
  kernel<<<grid, kThreads, bytes, stream>>>(a, b, steps, out, R, C, D,
                                            width_a, width_b, per, vec_a,
                                            vec_b);
  return cudaGetLastError();
}

template <bool A_T, bool B_T, int BN>
cudaError_t by_route(bool sa, bool sb, const float* a, const float* b,
                     const float* steps, float* out, int R, int C, int D,
                     int wa, int wb, int splits, int per, int va, int vb,
                     cudaStream_t s) {
  if (sa && sb)
    return launch_main<A_T, B_T, true, true, BN>(a, b, steps, out, R, C, D,
                                                 wa, wb, splits, per, va,
                                                 vb, s);
  if (sa)
    return launch_main<A_T, B_T, true, false, BN>(a, b, steps, out, R, C, D,
                                                  wa, wb, splits, per, va,
                                                  vb, s);
  if (sb)
    return launch_main<A_T, B_T, false, true, BN>(a, b, steps, out, R, C, D,
                                                  wa, wb, splits, per, va,
                                                  vb, s);
  return launch_main<A_T, B_T, false, false, BN>(a, b, steps, out, R, C, D,
                                                 wa, wb, splits, per, va, vb,
                                                 s);
}

template <bool A_T, bool B_T>
cudaError_t by_tile(int bn, bool sa, bool sb, const float* a,
                    const float* b, const float* steps, float* out, int R,
                    int C, int D, int wa, int wb, int splits, int per,
                    int va, int vb, cudaStream_t s) {
  if (bn == 64)
    return by_route<A_T, B_T, 64>(sa, sb, a, b, steps, out, R, C, D, wa, wb,
                                  splits, per, va, vb, s);
  return by_route<A_T, B_T, 32>(sa, sb, a, b, steps, out, R, C, D, wa, wb,
                                splits, per, va, vb, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// a, b, c: contiguous f32; kind 0 = nn (a[R,D], b[D,C]), 1 = nt (a[R,D],
// b[C,D]), 2 = tn (a[D,R], b[D,C]); c[R,C].  steps: f32 [4] = [step_a,
// 1/step_a, step_b, 1/step_b]; width 0 = raw operand, else 2..32.  The
// plan (ops.plan): output tiles 64 x bn (bn 32 or 64), `splits` ranges of
// `per` 32-deep slices of the reduction; with splits > 1, ws is an f32
// workspace [splits, R, C] and a second kernel sums it into c.  Returns
// the CUDA error of the first launch, else of the second (0 = launched).
extern "C" int qmatmul_launch(const float* a, const float* b,
                              const float* steps, float* c, float* ws, int R,
                              int C, int D, int kind, int width_a,
                              int width_b, int bn, int splits, int per,
                              cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  const int n_slices = (D + BK - 1) / BK;
  if (width_a < 0 || width_a > 32 || width_b < 0 || width_b > 32 ||
      width_a == 1 || width_b == 1 || (bn != 32 && bn != 64) ||
      splits < 1 || splits > 65535 || per < 1 ||
      (long)(splits - 1) * per >= (long)(n_slices > 0 ? n_slices : 1) ||
      (splits > 1 && ws == nullptr) || (R + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  // exact in TF32: rounded at width <= 12; everything else is split
  const bool sa = width_a == 0 || width_a > 12;
  const bool sb = width_b == 0 || width_b > 12;
  // 16-byte copies need 16-byte rows along the contiguous axis
  const int ld_a = kind == 2 ? R : D, ld_b = kind == 1 ? D : C;
  const int va = aligned16(a) && ld_a % 4 == 0;
  const int vb = aligned16(b) && ld_b % 4 == 0;
  float* out = splits > 1 ? ws : c;
  cudaError_t err;
  switch (kind) {
    case 0:
      err = by_tile<false, false>(bn, sa, sb, a, b, steps, out, R, C, D,
                                  width_a, width_b, splits, per, va, vb,
                                  stream);
      break;
    case 1:
      err = by_tile<false, true>(bn, sa, sb, a, b, steps, out, R, C, D,
                                 width_a, width_b, splits, per, va, vb,
                                 stream);
      break;
    case 2:
      err = by_tile<true, false>(bn, sa, sb, a, b, steps, out, R, C, D,
                                 width_a, width_b, splits, per, va, vb,
                                 stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long n = (long)R * C;
  const long work = n % 4 == 0 ? n / 4 : n;
  const int threads = 256;
  const long blocks = (work + threads - 1) / threads;
  qmm_kernel_splitk_reduce<<<(int)(blocks < 4096 ? blocks : 4096), threads,
                             0, stream>>>(ws, c, n, splits);
  return (int)cudaGetLastError();
}
