// K2: quantized matmul with per-operand DFXP rounding fused into the tile
// loads, f32 accumulation, for Hopper (sm_90a).
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
// Bound: operations for the large shapes (2·R·C·D f32 flops at the card's
// f32 rate, outside the tensor cores), bytes for skinny ones.  The product
// stays in true f32 (no TF32, no fp16 tensor cores): the training path
// feeds raw, off-grid activations and cotangents (dispatch.tape_dot), so
// only an f32 product matches the reference.  Design, simple first:
//   * one block of 256 threads per 64x64 output tile; a loop over the
//     reduction in 16-deep slices takes the place of the TPU's sequential
//     reduction grid axis, with the accumulator in registers (4x4 per
//     thread) instead of a VMEM scratch tile;
//   * each slice of A and B is staged in shared memory, rounded as it is
//     loaded (one rounding per element per output tile, as on the TPU);
//   * the three layouts differ only in how a tile is indexed: each load
//     walks its operand's contiguous axis with consecutive threads, so no
//     transposed copy is made;
//   * ragged edges are masked by index: out-of-range elements load as 0
//     and only in-range outputs are stored.
// Later options (ROADMAP): exact fp16 mantissas on wgmma for widths <= 11,
// TMA staging, double buffering.
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kThreads = 256;
constexpr int TM = 4, TN = 4;          // outputs per thread: rows, columns
constexpr int PAD = 1;                 // shared-memory row padding

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

// A_T: A is stored [D, R] (tn).  B_T: B is stored [C, D] (nt).
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ steps, float* __restrict__ c, int R,
           int C, int D, int width_a, int width_b) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];
  Grid ga, gb;
  ga.on = width_a > 0;
  gb.on = width_b > 0;
  ga.step = steps[0];
  ga.inv = steps[1];
  gb.step = steps[2];
  gb.inv = steps[3];
  ga.qmax = ga.on ? (float)((1u << (width_a - 1)) - 1u) : 0.f;
  ga.qmin = ga.on ? -(float)(1u << (width_a - 1)) : 0.f;
  gb.qmax = gb.on ? (float)((1u << (width_b - 1)) - 1u) : 0.f;
  gb.qmin = gb.on ? -(float)(1u << (width_b - 1)) : 0.f;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      int rr, dd;
      if (A_T) {
        rr = e % BM;
        dd = e / BM;
      } else {
        dd = e % BK;
        rr = e / BK;
      }
      const int r = r0 + rr, d = d0 + dd;
      float v = 0.f;
      if (r < R && d < D)
        v = qround(A_T ? a[(size_t)d * R + r] : a[(size_t)r * D + d], ga);
      As[dd][rr] = v;
    }
#pragma unroll
    for (int i = 0; i < BN * BK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      int cc, dd;
      if (B_T) {
        dd = e % BK;
        cc = e / BK;
      } else {
        cc = e % BN;
        dd = e / BN;
      }
      const int col = c0 + cc, d = d0 + dd;
      float v = 0.f;
      if (col < C && d < D)
        v = qround(B_T ? b[(size_t)col * D + d] : b[(size_t)d * C + col], gb);
      Bs[dd][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < C) c[(size_t)r * C + col] = acc[i][j];
    }
  }
}

}  // namespace

// a, b, c: contiguous f32; kind 0 = nn (a[R,D], b[D,C]), 1 = nt (a[R,D],
// b[C,D]), 2 = tn (a[D,R], b[D,C]); c[R,C].  steps: f32 [4] = [step_a,
// 1/step_a, step_b, 1/step_b]; width 0 = raw operand, else 2..24.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int qmatmul_launch(const float* a, const float* b,
                              const float* steps, float* c, int R, int C,
                              int D, int kind, int width_a, int width_b,
                              cudaStream_t stream) {
  if (R <= 0 || C <= 0) return 0;
  if (width_a < 0 || width_a > 24 || width_b < 0 || width_b > 24 ||
      width_a == 1 || width_b == 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0:
      qmm_kernel<false, false><<<grid, kThreads, 0, stream>>>(
          a, b, steps, c, R, C, D, width_a, width_b);
      break;
    case 1:
      qmm_kernel<false, true><<<grid, kThreads, 0, stream>>>(
          a, b, steps, c, R, C, D, width_a, width_b);
      break;
    case 2:
      qmm_kernel<true, false><<<grid, kThreads, 0, stream>>>(
          a, b, steps, c, R, C, D, width_a, width_b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
