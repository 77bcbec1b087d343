// Single-token decode attention over a slot KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/decode_attention.py
// (decode_attention :121, body _kernel :50, pallas_call at :178). It computes
// what that kernel computes: for every slot b and query head h, one query row
// q[b, 0, h] attends the cache rows 0 .. min(pos[b], S-1) of kv head
// h / (H/KV) (grouped-query attention), with an optional int8 cache
// dequantized in-kernel by per-token-per-head scales; out [B, 1, H, D]
// float32. The recurrence is the shared one of attn_primitives.cuh, so the
// plain PyTorch version (ops/kernels/decode_attention.py
// plain_decode_attention, built from ops/kernels/_primitives.py) is the same
// function.
//
// Bound. Memory: the kernel must read each live cache row once,
// bytes = sum_b live_b * KV * D * 2 (K and V) * bytes per element, plus the
// int8 scales (sum_b live_b * KV * 2 * 4), plus q and out, at 3.35 TB/s.
// The operations (4 * D per live row and query head) sit far below the
// card's rate.
//
// Design (the first, simple version).
// - Grid: one block per (kv head, slot), B * KV blocks. The TPU grid is
//   (b, h, k-blocks), and its index map hi // group re-reads each K/V block
//   once for every query head of the group. Here one block serves all
//   g = H / KV query heads of its kv head, so every live row leaves device
//   memory once.
// - Loop: the block walks the live key tiles (64 rows) in order
//   (attn_tile.cuh attend_history, shared with the paged kernel K4; here
//   history row r is cache row r of the slot). That loop replaces the TPU's
//   sequential "arbitrary" grid axis; the running (m, l, acc) of each query
//   head stays in registers across it. live_len is read from pos on the
//   device (no host sync); tiles at or past live_len are never loaded, and
//   the ragged last tile is masked as mask_dead_columns does, which covers
//   any S.
// - Later work, not here: split-K over S with a combine pass
//   (flash-decoding) to fill more than 64 of the 132 SMs, cp.async / TMA
//   double buffering of the tiles, and tensor-core mma for the g x D by
//   D x tile product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

using namespace nns_attn;

namespace {

template <typename QT, typename CT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q, const CT* __restrict__ ck,
                            const CT* __restrict__ cv, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            float* __restrict__ out, int S, int H, int KV, int D, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / KV;
  float* q_s = smem + 2 * kTile * (D + 1);  // [g][D], after attend_history's tiles
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the group's query rows: heads kh * g .. kh * g + g - 1 of slot b
  const size_t qrow = static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g;
  for (int i = tid; i < g * D; i += kThreads) q_s[i] = to_f(q[qrow * D + i]);

  // positions 0 .. pos are attendable; a wrapped ring passes absolute pos,
  // so clamp to the cache length
  const int p = pos[b];
  const int live = p < S ? p + 1 : S;
  const size_t slot_row = static_cast<size_t>(b) * S;
  HeadState st;
  st.init();
  attend_history<CT, kQuant>(
      ck, cv, ks, vs, [=](int r) { return (slot_row + r) * KV + kh; }, live, D, g, scale,
      smem, st);

#pragma unroll
  for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
    const int hh = warp + hi * kWarps;
    if (hh >= g) break;
    float* o = out + (qrow + hh) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = online_softmax_finalize(st.l[hi], st.acc[hi][i]);
    }
  }
}

template <typename QT, typename CT, bool kQuant>
int launch(const void* q, const void* ck, const void* cv, const float* ks, const float* vs,
           const int* pos, float* out, int B, int S, int H, int KV, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = history_smem_bytes(D, H / KV);
  auto kernel = decode_attention_kernel<QT, CT, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(ck), static_cast<const CT*>(cv), ks, vs,
      pos, out, S, H, KV, D, scale);
  return cudaGetLastError();
}

template <typename QT>
int launch_cache(int cache_dtype, const void* q, const void* ck, const void* cv,
                 const float* ks, const float* vs, const int* pos, float* out, int B, int S,
                 int H, int KV, int D, float scale, cudaStream_t stream) {
  switch (cache_dtype) {
    case kF32:
      return launch<QT, float, false>(q, ck, cv, ks, vs, pos, out, B, S, H, KV, D, scale, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16, false>(q, ck, cv, ks, vs, pos, out, B, S, H, KV, D, scale,
                                              stream);
    case kI8:
      return launch<QT, int8_t, true>(q, ck, cv, ks, vs, pos, out, B, S, H, KV, D, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). q: [B, 1, H, D] (q_dtype 0 = f32,
// 1 = bf16); ck, cv: [B, S, KV, D] contiguous (cache_dtype 0 = f32, 1 = bf16,
// 2 = int8 with ks, vs [B, S, KV] float32, else ks = vs = NULL); pos: [B]
// int32; out: [B, 1, H, D] float32. Needs H % KV == 0, H / KV <= 32,
// D % 4 == 0, D <= 256, 16-byte aligned cache rows for f32. Returns the
// cudaError_t of the launch; 0 means it was queued on `stream`.
extern "C" int nns_decode_attention(const void* q, int q_dtype, const void* ck, const void* cv,
                                    int cache_dtype, const float* ks, const float* vs,
                                    const int* pos, float* out, int B, int S, int H, int KV,
                                    int D, float scale, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || KV <= 0 || KV > 65535 || H % KV != 0 ||
      H / KV > kMaxGroup || D <= 0 || D > kMaxD || D % 4 != 0)
    return cudaErrorInvalidValue;
  if ((cache_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_cache<float>(cache_dtype, q, ck, cv, ks, vs, pos, out, B, S, H, KV, D, scale,
                                 s);
    case kBF16:
      return launch_cache<__nv_bfloat16>(cache_dtype, q, ck, cv, ks, vs, pos, out, B, S, H, KV, D,
                                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
