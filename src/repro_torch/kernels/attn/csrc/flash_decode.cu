// K3 — flash-decode: single-query GQA attention over a slot-major KV ring.
//
// Replaces the Pallas kernel `flash_decode_call`
// (src/repro/kernels/attn/attn_kernel.py), whose grid walks W in
// sequential splits with (m, l, acc) carried in VMEM scratch.
//
// What bounds it on an H100: bytes.  One call reads the B*W*K*hd*2 K/V
// mantissas once (3.3 MB for int8 at B=4, W=400, K=8, hd=128) and does
// 4*B*K*G*W*hd flops (26 MFLOP): ~1 us at 3.35 TB/s, far below the f32
// rate.  At these sizes launch latency and the serial walk over W inside
// one block dominate; that is the known cost of this first version.
//
// Design: one block per (kv head, slot), one warp per query row of the
// head's group (G warps).  The block loops over W in 32-key tiles: the
// whole block stages the tile's int8/int16/f32 K and V rows into shared
// memory, dequantizing by the slot's step, then each warp runs the online
// softmax for its row with one key per lane (attn_common.cuh).  The
// TPU's sequential split axis becomes this loop; nothing is carried
// across blocks.  Lanes past W are masked by index and their V rows are
// staged as zeros, so the pool is read as stored, never padded.
// Storage type is a template parameter: int8, int16, or float (step 1).
#include "attn_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void flash_decode_kernel(const float* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const int* __restrict__ pos,
                                    const int* __restrict__ qpos,
                                    const float* __restrict__ steps,
                                    float* __restrict__ out, int W, int K,
                                    int G, int hd, float scale, int window,
                                    int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (hd + 1);
  float* qs = vs + kTile * hd;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const long qoff = ((long)b * K + kh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) qs[i] = q[qoff + i];
  const float kstep = steps[2 * b], vstep = steps[2 * b + 1];
  const int qp = qpos[b];
  const long row_stride = (long)K * hd;
  const T* kb = k + ((long)b * W * K + kh) * hd;
  const T* vb = v + ((long)b * W * K + kh) * hd;

  RowState<1> st;
  st.init();
  for (int w0 = 0; w0 < W; w0 += kTile) {
    __syncthreads();   // the previous tile is consumed
    stage_tile(kb + w0 * row_stride, vb + w0 * row_stride, row_stride,
               min(kTile, W - w0), kstep, vstep, hd, ks, vs);
    __syncthreads();
    const int w = w0 + lane;
    const int p = w < W ? pos[(long)b * W + w] : -1;
    const int dlt = qp - p;
    const bool valid[1] = {w < W && p >= 0 && (!causal || dlt >= 0) &&
                           (window <= 0 || dlt < window)};
    tile_update<1>(st, qs + warp * hd, ks, vs, hd, scale, valid, lane);
  }
  st.store(0, out + qoff + (long)warp * hd, hd, lane);
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* pos, const int* qpos, const float* steps,
                   float* out, int B, int W, int K, int G, int hd,
                   float scale, int window, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(hd, G) * sizeof(float);
  cudaError_t err = allow_smem(flash_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T><<<dim3(K, B), 32 * G, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), pos, qpos,
      steps, out, W, K, G, hd, scale, window, causal);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode_launch(const float* q, const void* k,
                                   const void* v, const int* pos,
                                   const int* qpos, const float* steps,
                                   float* out, int B, int W, int K, int G,
                                   int hd, int kv_dtype, float scale,
                                   int window, int causal, void* stream) {
  if (B < 1 || W < 1 || K < 1 || G < 1 || G > 32 || hd < 1 ||
      hd > 32 * kMaxDpl || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch<int8_t>(q, k, v, pos, qpos, steps, out, B, W, K, G,
                                 hd, scale, window, causal, s);
    case 1:
      return (int)launch<int16_t>(q, k, v, pos, qpos, steps, out, B, W, K,
                                  G, hd, scale, window, causal, s);
    case 2:
      return (int)launch<float>(q, k, v, pos, qpos, steps, out, B, W, K, G,
                                hd, scale, window, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
