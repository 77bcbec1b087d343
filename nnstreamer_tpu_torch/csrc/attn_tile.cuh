// The history loop of the port's single-token decode attention kernels: one
// block per (kv head, slot) walks the live key rows in 64-row tiles staged
// in shared memory, for all query heads of its kv head.
//
// Shared by decode_attention.cu (K3, a contiguous cache row per position)
// and paged_attention.cu (K4, a row found through the slot's block table):
// the two differ only in where history row r lives, which the caller gives
// as a row-address functor. The recurrence is attn_primitives.cuh's.
//
// - Tiles: K and V rows are converted to float32 on load (bf16 widened, int8
//   times its row scale) and staged with rows padded to D + 1 floats, so the
//   lanes of a warp, each on its own row, read distinct banks. Rows at or
//   past `live` are never loaded: they are zero-filled and score NEG_INF
//   (mask_dead_columns), so NaN in stale or scratch rows never reaches the
//   output, and any row count works.
// - Work split: warp w owns query heads w, w + 8, ... (g <= 32). For a tile
//   its lanes score two rows each, the warp reduces max and sum with
//   shuffles, and each lane accumulates the p-weighted V over its own dims
//   (D / 32 of them). Each head's (m, l, acc) stays in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "attn_primitives.cuh"

namespace nns_attn {

constexpr int kTile = 64;                          // history rows per tile
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

// Bytes of dynamic shared memory attend_history needs (k_s, v_s, q_s, p_s).
__host__ __device__ __forceinline__ size_t history_smem_bytes(int D, int g) {
  return sizeof(float) * (2 * kTile * (D + 1) + g * D + kWarps * kTile);
}

// The per-head running state of one warp: (m, l) and the lane's acc dims.
struct HeadState {
  float m[kHeadsPerWarp];
  float l[kHeadsPerWarp];
  float acc[kHeadsPerWarp][kDimsPerLane];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
      online_softmax_init(m[hi], l[hi]);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[hi][i] = 0.0f;
    }
  }
};

// Attend history rows 0 .. live-1 of one kv head for the g query heads staged
// in q_s ([g][D] floats, written by the caller before the call). row_of(r)
// gives the row index of history row r: its K/V elements start at
// ck/cv + row * D and its int8 scales sit at ks/vs[row]. smem is the
// caller's dynamic shared memory (history_smem_bytes). On return the block
// is synchronized, so q_s and anything else the caller staged is visible.
template <typename CT, bool kQuant, typename RowOf>
__device__ __forceinline__ void attend_history(const CT* __restrict__ ck,
                                               const CT* __restrict__ cv,
                                               const float* __restrict__ ks,
                                               const float* __restrict__ vs, RowOf row_of,
                                               int live, int D, int g, float scale,
                                               float* smem, HeadState& st) {
  const int ld = D + 1;
  float* k_s = smem;              // [kTile][ld]
  float* v_s = k_s + kTile * ld;  // [kTile][ld]
  const float* q_s = v_s + kTile * ld;
  float* p_s = v_s + kTile * ld + g * D;  // [kWarps][kTile]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
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
        const size_t row = row_of(t0 + j);
        load4(ck + row * D + c, kx);
        load4(cv + row * D + c, vx);
        if (kQuant) {
          const float sk = __ldg(ks + row);
          const float sv = __ldg(vs + row);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kx[e] = dequant(kx[e], sk);
            vx[e] = dequant(vx[e], sv);
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
      float tile_max = kNegInf;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const int j = lane + 32 * r;
        const float* kr = k_s + j * ld;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qh[d], kr[d], dot);
        s[r] = mask_dead_score(scaled(dot, scale), t0 + j, live);
        tile_max = fmaxf(tile_max, s[r]);
      }
      tile_max = warp_max(tile_max);
      const float m_new = fmaxf(st.m[hi], tile_max);
      const float alpha = online_softmax_alpha(st.m[hi], m_new);
      float psum = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const float pr = online_softmax_weight(s[r], m_new);
        pw[lane + 32 * r] = pr;
        psum += pr;
      }
      psum = warp_sum(psum);
      st.l[hi] = st.l[hi] * alpha + psum;
      st.m[hi] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) st.acc[hi][i] *= alpha;
      for (int j = 0; j < n; ++j) {  // dead rows weigh 0 against zero V
        const float pj = pw[j];
        const float* vr = v_s + j * ld;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) st.acc[hi][i] = fmaf(pj, vr[d], st.acc[hi][i]);
        }
      }
      __syncwarp();  // pw is rewritten for this warp's next head
    }
  }
  __syncthreads();  // with no live row, q_s must still be visible
}

}  // namespace nns_attn
