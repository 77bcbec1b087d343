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
// - Loop: the block walks the live key tiles (kTile rows) in order. That
//   loop replaces the TPU's sequential "arbitrary" grid axis; the running
//   (m, l, acc) of each query head stays in registers across it. live_len
//   is read from pos on the device (no host sync); tiles at or past live_len
//   are never loaded, and the ragged last tile is masked as
//   mask_dead_columns does (dead rows zero-filled in shared memory, their
//   scores NEG_INF), which covers any S.
// - Tiles: K and V rows are converted to float32 on load (bf16 widened, int8
//   times its row scale) and staged in shared memory with rows padded to
//   D + 1 floats, so the lanes of a warp, each on its own key row, read
//   distinct banks.
// - Work split: warp w owns query heads w, w + 8, ... (g <= 32). For a tile
//   its lanes compute the scores of the tile's rows (two rows a lane), the
//   warp reduces max and sum with shuffles, and each lane accumulates the
//   p-weighted V over its own dims (D / 32 of them).
// - Later work, not here: split-K over S with a combine pass
//   (flash-decoding) to fill more than 64 of the 132 SMs, cp.async / TMA
//   double buffering of the tiles, and tensor-core mma for the g x D by
//   D x tile product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "attn_primitives.cuh"

namespace {

constexpr int kTile = 64;                          // key rows per tile
constexpr int kThreads = 256;                      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kDimsPerLane = kMaxD / 32;           // acc registers per head
constexpr int kMaxGroup = 32;                      // query heads per kv head
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;  // 4
constexpr int kRowsPerLane = kTile / 32;           // 2

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements, widened to float32.
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float o[4]) {
  const char4 v = __ldg(reinterpret_cast<const char4*>(p));
  o[0] = static_cast<float>(v.x);
  o[1] = static_cast<float>(v.y);
  o[2] = static_cast<float>(v.z);
  o[3] = static_cast<float>(v.w);
}

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
  const int ld = D + 1;
  float* k_s = smem;                // [kTile][ld]
  float* v_s = k_s + kTile * ld;    // [kTile][ld]
  float* q_s = v_s + kTile * ld;    // [g][D]
  float* p_s = q_s + g * D;         // [kWarps][kTile]
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

  float m[kHeadsPerWarp], l[kHeadsPerWarp], acc[kHeadsPerWarp][kDimsPerLane];
#pragma unroll
  for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
    nns_attn::online_softmax_init(m[hi], l[hi]);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[hi][i] = 0.0f;
  }

  const int vecs = D / 4;
  float* pw = p_s + warp * kTile;
  for (int t0 = 0; t0 < live; t0 += kTile) {
    const int n = min(kTile, live - t0);
    __syncthreads();  // q_s written; the previous tile's readers are done
    for (int i = tid; i < kTile * vecs; i += kThreads) {
      const int j = i / vecs;
      const int c = (i - j * vecs) * 4;
      float kx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float vx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < n) {  // dead rows stay zero (mask_dead_columns)
        const size_t row = (static_cast<size_t>(b) * S + t0 + j) * KV + kh;
        load4(ck + row * D + c, kx);
        load4(cv + row * D + c, vx);
        if (kQuant) {
          const float sk = __ldg(ks + row);
          const float sv = __ldg(vs + row);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kx[e] = nns_attn::dequant(kx[e], sk);
            vx[e] = nns_attn::dequant(vx[e], sv);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k_s[j * ld + c + e] = kx[e];
        v_s[j * ld + c + e] = vx[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
      const int hh = warp + hi * kWarps;
      if (hh >= g) break;  // uniform across the warp
      const float* qh = q_s + hh * D;
      float s[kRowsPerLane];
      float tile_max = nns_attn::kNegInf;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int j = lane + 32 * r;
        const float* kr = k_s + j * ld;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qh[d], kr[d], dot);
        s[r] = nns_attn::mask_dead_score(nns_attn::scaled(dot, scale), t0 + j, live);
        tile_max = fmaxf(tile_max, s[r]);
      }
      tile_max = nns_attn::warp_max(tile_max);
      const float m_new = fmaxf(m[hi], tile_max);
      const float alpha = nns_attn::online_softmax_alpha(m[hi], m_new);
      float psum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const float pr = nns_attn::online_softmax_weight(s[r], m_new);
        pw[lane + 32 * r] = pr;
        psum += pr;
      }
      psum = nns_attn::warp_sum(psum);
      l[hi] = l[hi] * alpha + psum;
      m[hi] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[hi][i] *= alpha;
      for (int j = 0; j < n; ++j) {  // dead rows weigh 0 against zero V
        const float pj = pw[j];
        const float* vr = v_s + j * ld;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[hi][i] = fmaf(pj, vr[d], acc[hi][i]);
        }
      }
      __syncwarp();  // pw is rewritten for this warp's next head
    }
  }

#pragma unroll
  for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
    const int hh = warp + hi * kWarps;
    if (hh >= g) break;
    float* o = out + (qrow + hh) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = nns_attn::online_softmax_finalize(l[hi], acc[hi][i]);
    }
  }
}

template <typename QT, typename CT, bool kQuant>
int launch(const void* q, const void* ck, const void* cv, const float* ks, const float* vs,
           const int* pos, float* out, int B, int S, int H, int KV, int D, float scale,
           cudaStream_t stream) {
  const int g = H / KV;
  const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + g * D + kWarps * kTile);
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
