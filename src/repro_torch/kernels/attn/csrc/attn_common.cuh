// Shared pieces of the attention kernels K3-K6: the tile width, the head
// dims a lane may hold, the score of a masked key, warp reductions and the
// opt-in to more than 48 KB of shared memory.  The kernels' designs live
// in decode_common.cuh (K3, K5) and prefill_common.cuh (K4, K6).
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

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn
