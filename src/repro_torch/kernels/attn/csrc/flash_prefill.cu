// K4 — flash-prefill: a chunk of C queries attends the packed history,
// then its own f32 K/V causally, in one joint softmax.
//
// Replaces the Pallas kernel `flash_prefill_call`
// (src/repro/kernels/attn/prefill_kernel.py), which keeps (m, l, acc) for
// all C*G rows of a kv head in VMEM across a sequential grid of history
// splits plus one self step.
//
// What bounds it on an H100: f32 arithmetic.  One chunk (B=1, C=128,
// W=400 history + 128 self keys, K=8, G=4, hd=128) does
// 4*C*G*K*(W+C)*hd ~ 1.1 GFLOP but moves only ~5 MB, so the bound is
// ~16 us at the 67 TFLOP/s f32 rate outside the tensor cores.
//
// Design: the TPU version's accumulator for all C*G = 512 rows x 128 is
// 256 KB of f32, more than a block's 227 KB of shared memory, so the
// rows are tiled across blocks: grid (ceil(C*G / 32), K, B), 8 warps of
// 4 rows each, row r = c*G + g.  Each block walks the history in 32-key
// tiles (mask 0 <= pos < p0, causal on absolute positions, window,
// rows c >= n_valid, lanes past W), then the chunk's own K/V (mask
// j < n_valid, j <= c, window), and writes acc / l for its rows.  Tiles
// are staged to shared memory dequantized (attn_common.cuh); the
// accumulators of a warp's rows live in registers.  A chunk with p0 == 0
// skips the history, and causal self tiles past the block's last row
// are skipped (they are fully masked, so skipping them is exact).
#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kRpw = 4;                  // query rows per warp
constexpr int kWarps = 8;
constexpr int kRows = kRpw * kWarps;     // query rows per block

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
flash_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ kn,
                     const float* __restrict__ vn, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pos,
                     const int* __restrict__ p0s, const int* __restrict__ nvs,
                     const float* __restrict__ steps, float* __restrict__ out,
                     int C, int W, int K, int G, int hd, float scale,
                     int window, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (hd + 1);
  float* qs = vs + kTile * hd;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int rows = C * G;
  const int r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // query row r = c*G + g sits at q[((b*C + c)*K + kh)*G + g][0 .. hd)
  auto row_off = [&](int r) {
    const int c = r / G, g = r - c * G;
    return (((long)b * C + c) * K + kh) * G * hd + (long)g * hd;
  };
  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    const int rr = i / hd, d = i - rr * hd;
    const int r = r0 + rr;
    qs[i] = r < rows ? q[row_off(r) + d] : 0.f;
  }
  const int p0 = p0s[b], nv = nvs[b];
  const float kstep = steps[2 * b], vstep = steps[2 * b + 1];

  int cq[kRpw];
  bool row_ok[kRpw];
#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = r0 + warp * kRpw + i;
    cq[i] = r / G;
    row_ok[i] = r < rows && cq[i] < nv;
  }
  const float* qw = qs + warp * kRpw * hd;
  RowState<kRpw> st;
  st.init();

  // history: the pool's ring, entries 0 <= pos < p0
  const long row_stride = (long)K * hd;
  if (p0 > 0) {
    const T* kb = k + ((long)b * W * K + kh) * hd;
    const T* vb = v + ((long)b * W * K + kh) * hd;
    for (int w0 = 0; w0 < W; w0 += kTile) {
      __syncthreads();
      stage_tile(kb + w0 * row_stride, vb + w0 * row_stride, row_stride,
                 min(kTile, W - w0), kstep, vstep, hd, ks, vs);
      __syncthreads();
      const int w = w0 + lane;
      const int p = w < W ? pos[(long)b * W + w] : -1;
      const bool key_ok = w < W && p >= 0 && p < p0;
      bool valid[kRpw];
#pragma unroll
      for (int i = 0; i < kRpw; ++i) {
        const int dlt = p0 + cq[i] - p;
        valid[i] = row_ok[i] && key_ok && (!causal || dlt >= 0) &&
                   (window <= 0 || dlt < window);
      }
      tile_update<kRpw>(st, qw, ks, vs, hd, scale, valid, lane);
    }
  }

  // self block: the chunk's own f32 K/V, keys j < n_valid
  const int c_last = min(rows - 1, r0 + kRows - 1) / G;
  const int j_end = causal ? min(nv, c_last + 1) : nv;
  const float* knb = kn + ((long)b * C * K + kh) * hd;
  const float* vnb = vn + ((long)b * C * K + kh) * hd;
  for (int j0 = 0; j0 < j_end; j0 += kTile) {
    __syncthreads();
    stage_tile(knb + j0 * row_stride, vnb + j0 * row_stride, row_stride,
               min(kTile, C - j0), 1.f, 1.f, hd, ks, vs);
    __syncthreads();
    const int j = j0 + lane;
    bool valid[kRpw];
#pragma unroll
    for (int i = 0; i < kRpw; ++i) {
      const int dj = cq[i] - j;
      valid[i] = row_ok[i] && j < nv && (!causal || dj >= 0) &&
                 (window <= 0 || dj < window);
    }
    tile_update<kRpw>(st, qw, ks, vs, hd, scale, valid, lane);
  }

#pragma unroll
  for (int i = 0; i < kRpw; ++i) {
    const int r = r0 + warp * kRpw + i;
    if (r < rows) st.store(i, out + row_off(r), hd, lane);
  }
}

template <typename T>
cudaError_t launch(const float* q, const float* kn, const float* vn,
                   const void* k, const void* v, const int* pos,
                   const int* p0, const int* nv, const float* steps,
                   float* out, int B, int C, int W, int K, int G, int hd,
                   float scale, int window, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats(hd, kRows) * sizeof(float);
  cudaError_t err = allow_smem(flash_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C * G + kRows - 1) / kRows, K, B);
  flash_prefill_kernel<T><<<grid, 32 * kWarps, smem, stream>>>(
      q, kn, vn, static_cast<const T*>(k), static_cast<const T*>(v), pos, p0,
      nv, steps, out, C, W, K, G, hd, scale, window, causal);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_prefill_launch(const float* q, const float* kn,
                                    const float* vn, const void* k,
                                    const void* v, const int* pos,
                                    const int* p0, const int* nv,
                                    const float* steps, float* out, int B,
                                    int C, int W, int K, int G, int hd,
                                    int kv_dtype, float scale, int window,
                                    int causal, void* stream) {
  if (B < 1 || C < 1 || W < 1 || K < 1 || G < 1 || hd < 1 ||
      hd > 32 * kMaxDpl || B > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)launch<int8_t>(q, kn, vn, k, v, pos, p0, nv, steps, out, B,
                                 C, W, K, G, hd, scale, window, causal, s);
    case 1:
      return (int)launch<int16_t>(q, kn, vn, k, v, pos, p0, nv, steps, out,
                                  B, C, W, K, G, hd, scale, window, causal,
                                  s);
    case 2:
      return (int)launch<float>(q, kn, vn, k, v, pos, p0, nv, steps, out, B,
                                C, W, K, G, hd, scale, window, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
