// K1: fused DFXP quantize with overflow counts, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dfxp_quantize_2d`
// (src/repro/kernels/dfxp/dfxp_kernel.py:45).  For every element
//     m = round_half_even(x * 2^-e)
//     y = clip(m, qmin, qmax) * 2^e
// and two integer counts: m outside [qmin, qmax], and m outside the half
// range [qmin/2, qmax/2] (would overflow at e - 1), the two statistics of
// the paper's scale controller (§5), returned as f32 like `fixed_round`'s.
//
// Bound: bytes.  One read and one write of x, nothing else (a few flops
// per element against 8 bytes for f32), so the least time is the bytes
// over the card's memory rate, and what reaches it is enough bytes in
// flight: at ~0.7 us of latency, 3.35 TB/s over 132 SMs wants ~17 KB in
// flight per SM (Little's law).  The first version kept one 4-byte load
// per thread in flight (8 KB an SM at 2,048 threads) and reached 44% of
// the rate.  The design:
//   * each thread loads kUnroll = 2 16-byte vectors (4 f32, or 8 f16 or
//     bf16) before it uses any of them, 32 bytes in flight per thread
//     (64 KB an SM at 2,048 threads), then rounds and stores them as
//     vectors; the grid is one wave of the blocks that fit on the card
//     (132 SMs times the occupancy the kernel reaches), striding over the
//     flat tensor.  Two vectors rather than four spread the training
//     path's small tensors over twice the blocks, which measured faster
//     there and no slower on llama3-8B's w_up (tools/k1_attribution.py);
//   * that vector path runs when x and y are both 16-byte aligned; the
//     ragged tail past the whole vectors, or all of x when a pointer is
//     not aligned (a contiguous view at an odd element offset is a legal
//     input), takes scalar steps in the same kernel, kUnroll loads in
//     flight per thread;
//   * one device operation per call: the step 2^e and 1/step are built
//     in the kernel (ldexpf, bit-equal to core/quant.py exact_pow2) from
//     the f32 exponent, read from device memory or passed by value, and
//     the kernel writes the f32 counts itself.  Each block sums its two
//     counts (registers, warp shuffles, shared memory) and adds
//     (count << 11) + 1 to one 64-bit word per count with an atomic: the
//     low 11 bits count the blocks that have added, so the value the
//     atomic returns tells a block whether it is the last (G - 1 blocks
//     before it) and, then, the exact total; that block writes the count
//     as f32 and clears the word for the next call.  No fence and no
//     second pass: one round trip to the L2 after a block's data, which
//     overlaps the draining of its stores (tools/k1_attribution.py times
//     this against a fence-and-ticket tail, a second kernel, and no
//     counts at all).  The wrapper keeps the two words per stream, zeroed
//     once, so no two calls that may run at once share them.  Integer
//     counts are exact in any order, so the result does not depend on the
//     schedule.
//
// Bit-exact with the plain version (kernels/dfxp/ref.py) and with the
// reference's `fixed_round`:
//   * rintf rounds half to even (roundf would round half away from zero);
//   * step and inv_step are exact powers of two, and x * inv_step equals
//     x / step for a power of two (both are the correctly rounded value of
//     the same real number);
//   * the clamp is two explicit compares, so NaN stays NaN (fminf/fmaxf
//     would turn it into a bound) and is counted nowhere, like
//     torch.clamp and jnp.clip;
//   * f16 and bf16 are read and written in their own type, with the
//     arithmetic in f32 and a round-to-nearest-even store;
//   * the counts are summed as integers and rounded to f32 once, as
//     torch's int64 count converted to float32;
//   * built without --use_fast_math (no flush to zero, exact rounding).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;      // vectors (or scalars) in flight per thread
constexpr int kTicketBits = 11;               // blocks a call may have
constexpr unsigned long long kTicket = (1ull << kTicketBits) - 1;

// 16 bytes of T as N floats.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float (&f)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__half* p, const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 t = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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

// The rounding of one value, counting as it goes.
struct Rounder {
  float step, inv_step, qmax, qmin, hmax, hmin;
  unsigned int over, over_half;
  __device__ float operator()(float x) {
    const float m = rintf(x * inv_step);
    over += (m > qmax) | (m < qmin);
    over_half += (m > hmax) | (m < hmin);
    float c = m;
    if (c > qmax) c = qmax;
    if (c < qmin) c = qmin;
    return c * step;
  }
};

// acc: the two words of the counts (0 between calls), each
// (sum << kTicketBits) + blocks that have added.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dfxp_quantize_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ e_ptr, float e_val,
                     unsigned long long* __restrict__ acc,
                     float* __restrict__ stats, long long n, int vec,
                     float qmax, float qmin, float hmax, float hmin) {
  const int e = (int)(e_ptr != nullptr ? *e_ptr : e_val);
  Rounder r{ldexpf(1.f, e), ldexpf(1.f, -e), qmax, qmin, hmax, hmin, 0u, 0u};
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  const long long first = (long long)blockIdx.x * kThreads * kUnroll +
                          threadIdx.x;
  long long done = 0;               // elements the vector path took
  if (vec) {
    constexpr int N = Pack<T>::N;
    const long long nv = n / N;
    for (long long base = first; base < nv; base += stride) {
      float f[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        if (i < nv) Pack<T>::load(x + i * N, f[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        if (i < nv) {
#pragma unroll
          for (int j = 0; j < N; ++j) f[u][j] = r(f[u][j]);
          Pack<T>::store(y + i * N, f[u]);
        }
      }
    }
    done = nv * N;
  }
  for (long long base = done + first; base < n; base += stride) {
    float f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) f[u] = load_f(x, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) store_f(y, i, r(f[u]));
    }
  }

  __shared__ unsigned int part[2][kWarps];
  unsigned int a = r.over, b = r.over_half;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sa = 0, sb = 0;
    for (int w = 0; w < kWarps; ++w) {
      sa += part[0][w];
      sb += part[1][w];
    }
    const unsigned long long last = gridDim.x - 1;
    const unsigned long long oa =
        atomicAdd(&acc[0], (sa << kTicketBits) + 1);
    const unsigned long long ob =
        atomicAdd(&acc[1], (sb << kTicketBits) + 1);
    if ((oa & kTicket) == last) {
      stats[0] = __ull2float_rn((oa >> kTicketBits) + sa);
      acc[0] = 0ull;
    }
    if ((ob & kTicket) == last) {
      stats[1] = __ull2float_rn((ob >> kTicketBits) + sb);
      acc[1] = 0ull;
    }
  }
}

// Blocks of one wave on the current device: SMs times the blocks of
// kernel that fit on one, computed once per type.
template <typename T>
int wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, dfxp_quantize_kernel<T>, kThreads, 0) != cudaSuccess)
      return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* e_ptr, float e_val,
                   long long* acc, float* stats, long long n, int width,
                   cudaStream_t stream) {
  // the bounds as the reference forms them: Python floats rounded to f32
  const double q = std::ldexp(1.0, width - 1);
  const float qmax = (float)(q - 1.0), qmin = (float)(-q);
  const float hmax = (float)((q - 1.0) / 2.0), hmin = (float)(-q / 2.0);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long items = vec ? n / Pack<T>::N + n % Pack<T>::N : n;
  long long blocks = (items + (long long)kThreads * kUnroll - 1) /
                     ((long long)kThreads * kUnroll);
  const int wave = wave_blocks<T>();
  if (wave <= 0) return cudaErrorInvalidValue;
  if (blocks > wave) blocks = wave;
  if (blocks > (long long)kTicket) blocks = kTicket;
  dfxp_quantize_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), e_ptr, e_val,
      reinterpret_cast<unsigned long long*>(acc), stats, n, vec, qmax,
      qmin, hmax, hmin);
  return cudaGetLastError();
}

}  // namespace

// x, y: n > 0 elements of dtype (0 = f32, 1 = f16, 2 = bf16), contiguous;
// the exponent: f32 at e_ptr on the device, or e_val when e_ptr is null;
// acc: int64 [2], zero (the kernel leaves it so), not shared with a call
// on another stream; stats: f32 [2] written with (n_overflow,
// n_overflow_half).  Returns the CUDA error of the launch (0 = launched).
extern "C" int dfxp_quantize_launch(const void* x, void* y,
                                    const float* e_ptr, float e_val,
                                    long long* acc, float* stats,
                                    long long n, int dtype, int width,
                                    cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, y, e_ptr, e_val, acc, stats, n, width,
                                stream);
    case 1:
      return (int)launch<__half>(x, y, e_ptr, e_val, acc, stats, n, width,
                                 stream);
    case 2:
      return (int)launch<__nv_bfloat16>(x, y, e_ptr, e_val, acc, stats, n,
                                        width, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
