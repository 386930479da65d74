// K1: fused DFXP quantize with overflow counts, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dfxp_quantize_2d`
// (src/repro/kernels/dfxp/dfxp_kernel.py:45).  For every element
//     m = round_half_even(x * inv_step)
//     y = clip(m, qmin, qmax) * step
// and two integer counts: m outside [qmin, qmax], and m outside the half
// range [qmin/2, qmax/2] (would overflow at e - 1), the two statistics of
// the paper's scale controller (§5).
//
// Bound: bytes.  One read and one write of x, nothing else (a few flops
// per element against 8 bytes for f32), so the least time is the bytes
// over the card's memory rate.  The design does what that asks: one pass,
// a grid-stride loop over the flat tensor with the ragged tail masked by
// index (no padded copy), the counts kept in registers, summed over a warp
// by shuffles and over the block in shared memory, and added with one
// 64-bit atomic per block into two int64 counters.  Integer counts are
// exact in any order, so the result does not depend on the schedule.
//
// Bit-exact with the plain version (kernels/dfxp/ref.py) and with the
// reference's `fixed_round`:
//   * rintf rounds half to even (roundf would round half away from zero);
//   * step and inv_step are exact powers of two built by the caller, and
//     x * inv_step equals x / step for a power of two (both are the
//     correctly rounded value of the same real number);
//   * the clamp is two explicit compares, so NaN stays NaN (fminf/fmaxf
//     would turn it into a bound) and is counted nowhere, like
//     torch.clamp and jnp.clip;
//   * f16 and bf16 are read and written in their own type, with the
//     arithmetic in f32 and a round-to-nearest-even store;
//   * built without --use_fast_math (no flush to zero, exact rounding).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of an H100

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __half* p, long long i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__half* p, long long i, float v) {
  p[i] = __float2half_rn(v);
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dfxp_quantize_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ steps,
                     unsigned long long* __restrict__ counts, long long n,
                     float qmax, float qmin, float hmax, float hmin) {
  const float step = steps[0];
  const float inv_step = steps[1];
  unsigned int over = 0, over_half = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float m = rintf(load_f(x, i) * inv_step);
    over += (m > qmax) | (m < qmin);
    over_half += (m > hmax) | (m < hmin);
    float c = m;
    if (c > qmax) c = qmax;
    if (c < qmin) c = qmin;
    store_f(y, i, c * step);
  }
  for (int off = 16; off > 0; off >>= 1) {
    over += __shfl_down_sync(0xffffffffu, over, off);
    over_half += __shfl_down_sync(0xffffffffu, over_half, off);
  }
  __shared__ unsigned int part[2][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = over;
    part[1][warp] = over_half;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += part[0][w];
      b += part[1][w];
    }
    if (a) atomicAdd(&counts[0], a);
    if (b) atomicAdd(&counts[1], b);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* steps,
                   long long* counts, long long n, int width,
                   cudaStream_t stream) {
  // the bounds as the reference forms them: Python floats rounded to f32
  const double q = std::ldexp(1.0, width - 1);
  const float qmax = (float)(q - 1.0), qmin = (float)(-q);
  const float hmax = (float)((q - 1.0) / 2.0), hmin = (float)(-q / 2.0);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dfxp_quantize_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), steps,
      reinterpret_cast<unsigned long long*>(counts), n, qmax, qmin, hmax,
      hmin);
  return cudaGetLastError();
}

}  // namespace

// x, y: n elements of dtype (0 = f32, 1 = f16, 2 = bf16), contiguous;
// steps: f32 [2] = [2**e, 2**-e]; counts: int64 [2], zeroed by the caller.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int dfxp_quantize_launch(const void* x, void* y,
                                    const float* steps, long long* counts,
                                    long long n, int dtype, int width,
                                    cudaStream_t stream) {
  if (n <= 0) return 0;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(x, y, steps, counts, n, width, stream);
      break;
    case 1:
      err = launch<__half>(x, y, steps, counts, n, width, stream);
      break;
    case 2:
      err = launch<__nv_bfloat16>(x, y, steps, counts, n, width, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
