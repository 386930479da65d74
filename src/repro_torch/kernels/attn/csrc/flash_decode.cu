// K3 — flash-decode: single-query GQA attention over a slot-major KV ring,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_decode_call`
// (src/repro/kernels/attn/attn_kernel.py:123), whose grid (B, K, split)
// walks the ring W in sequential splits with (m, l, acc) carried in VMEM
// scratch.
//
// What bounds it on an H100: bytes.  One call reads the B*W*K*hd*2 K/V
// mantissas once (3.3 MB for int8 at B=4, W=400, K=8, hd=128) and does
// 4*B*K*G*W*hd flops (26 MFLOP): ~1 us at 3.35 TB/s, far below the f32
// rate.  The first version took 0.24 ms there, bound by latency: one block
// per (kv head, slot), 32 blocks for 132 SMs, each walking all 13 of its
// tiles in turn, staging every element with one scalar load and a barrier
// per tile, tiles no lane sees included.
//
// Design: decode_common.cuh's split decode, shared with K5 (paged).  Here
// a split is a contiguous range of `tps` 32-entry tiles of the slot's
// ring (the wrapper's ring_splits picks S so that K * B * S blocks fill a
// wave of SMs: S = 5, 160 blocks at the serving shape); tile t holds ring
// entries [32 t, 32 t + 32) of slot b, rows past W read as zero and their
// lanes are masked, so the ring is read as stored, never padded; every
// tile of a slot carries the slot's steps.  Tile votes skip what the
// window or a short slot hides; cp.async keeps two tiles in flight; any
// hd <= 256 runs on the instance of the next multiple of 32;
// flash_decode_kernel_combine merges the splits in order.  Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): 0.012 ms at the serving shape, of
// which the merge is ~3 us (tools/attn_plan_sweep.py).
#include "decode_common.cuh"

namespace {

using namespace attn;

// The tiles of one split: ring tiles [t0, t0 + n_tiles) of slot b.
template <typename T>
struct RingSrc {
  const T* k;                       // row 0 of the slot's ring, this head
  const T* v;
  const int* pos_row;               // the slot's ring positions
  float ks, vs;
  int t0, W, n_tiles;
  long row_stride;

  __device__ int w0(int t) const { return (t0 + t) * kTile; }
  __device__ int pos(int t, int lane) const {
    const int w = w0(t) + lane;
    return w < W ? pos_row[w] : -1;
  }
  __device__ const T* kbase(int t) const { return k + w0(t) * row_stride; }
  __device__ const T* vbase(int t) const { return v + w0(t) * row_stride; }
  __device__ int rows(int t) const { return min(kTile, W - w0(t)); }
  __device__ float kstep(int) const { return ks; }
  __device__ float vstep(int) const { return vs; }
};

template <typename T, int DPL>
__global__ void __launch_bounds__(1024) flash_decode_kernel(
    const float* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos,
    const int* __restrict__ qpos, const float* __restrict__ steps,
    float* __restrict__ out, float* __restrict__ ws, int B, int W, int K,
    int G, int hd, float scale, int window, int causal, int tps, int copy) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int n_all = (W + kTile - 1) / kTile;
  RingSrc<T> src;
  src.row_stride = (long)K * hd;
  src.k = k + ((long)b * W * K + kh) * hd;
  src.v = v + ((long)b * W * K + kh) * hd;
  src.pos_row = pos + (long)b * W;
  src.ks = steps[2 * b];
  src.vs = steps[2 * b + 1];
  src.t0 = blockIdx.z * tps;
  src.W = W;
  src.n_tiles = max(min(tps, n_all - src.t0), 0);
  decode_split<T, DPL>(src, q, out, ws, B, K, G, hd, scale, window, causal,
                       qpos[b], copy);
}

__global__ void flash_decode_kernel_combine(const float* __restrict__ ws,
                                            float* __restrict__ out, int S,
                                            int rows, int hd) {
  combine_splits(ws, out, S, rows, hd);
}

template <typename T, int DPL>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* pos, const int* qpos, const float* steps,
                   float* out, float* ws, int B, int W, int K, int G, int hd,
                   float scale, int window, int causal, int splits, int tps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DPL>(G, tps);
  cudaError_t err = allow_smem(flash_decode_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T, DPL><<<dim3(K, B, splits), 32 * G, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), pos, qpos,
      steps, out, ws, B, W, K, G, hd, scale, window, causal, tps,
      copy_mode<T>(hd, k, v));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  flash_decode_kernel_combine<<<B * K * G, hd, 0, stream>>>(
      ws, out, splits, B * K * G, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const float* q, const void* k, const void* v,
                  const int* pos, const int* qpos, const float* steps,
                  float* out, float* ws, int B, int W, int K, int G,
                  float scale, int window, int causal, int splits, int tps,
                  cudaStream_t s) {
#define K3_HD(DPL)                                                          \
  case DPL:                                                                \
    return launch<T, DPL>(q, k, v, pos, qpos, steps, out, ws, B, W, K, G,  \
                          hd, scale, window, causal, splits, tps, s);
  switch (dpl_of(hd)) {
    K3_HD(1)
    K3_HD(2)
    K3_HD(3)
    K3_HD(4)
    K3_HD(5)
    K3_HD(6)
    K3_HD(7)
    K3_HD(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef K3_HD
}

}  // namespace

// kv_dtype: 0 int8, 1 int16, 2 float32.  window <= 0 means global.  The
// ring's ceil(W / 32) tiles are cut into `splits` ranges of `tps` tiles;
// with splits > 1, ws is an f32 workspace of splits * B * K * G * (hd + 2)
// floats.  Returns the cudaError_t of the first launch, else of the
// second (0 on success).
extern "C" int flash_decode_launch(const float* q, const void* k,
                                   const void* v, const int* pos,
                                   const int* qpos, const float* steps,
                                   float* out, float* ws, int B, int W,
                                   int K, int G, int hd, int kv_dtype,
                                   float scale, int window, int causal,
                                   int splits, int tps, void* stream) {
  const long n_tiles = (W + kTile - 1) / kTile;
  if (B < 1 || W < 1 || K < 1 || G < 1 || G > 32 || hd < 1 ||
      hd > 32 * kMaxDpl || B > 65535 || splits < 1 || splits > 65535 ||
      tps < 1 || (long)(splits - 1) * tps >= n_tiles ||
      (long)splits * tps < n_tiles || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0:
      return (int)by_hd<int8_t>(hd, q, k, v, pos, qpos, steps, out, ws, B, W,
                                K, G, scale, window, causal, splits, tps, s);
    case 1:
      return (int)by_hd<int16_t>(hd, q, k, v, pos, qpos, steps, out, ws, B,
                                 W, K, G, scale, window, causal, splits, tps,
                                 s);
    case 2:
      return (int)by_hd<float>(hd, q, k, v, pos, qpos, steps, out, ws, B, W,
                               K, G, scale, window, causal, splits, tps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
