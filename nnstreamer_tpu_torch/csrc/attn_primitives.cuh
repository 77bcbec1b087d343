// The online-softmax attention recurrence as device functions.
//
// The CUDA counterpart of nnstreamer_tpu/ops/pallas/_primitives.py, shared by
// the port's attention kernels (decode_attention.cu now; the paged decode and
// flash prefill kernels will include it too). Its plain PyTorch twin is
// nnstreamer_tpu_torch/ops/kernels/_primitives.py; each function below names
// the one it mirrors.
//
// The guards are the reference's, exactly:
//   - m_prev <= NEG_INF gives alpha = 0 (exp(NEG_INF - NEG_INF) would be 1);
//   - m_new <= NEG_INF gives p = 0;
//   - l == 0 gives an output of exactly 0;
//   - dead V rows are zero, so 0 * NaN from stale cache bytes never reaches
//     the output (the kernels zero-fill dead rows instead of loading them).
// Exponentials are expf (not __expf): the kernels are held to 2e-5 against
// the plain version.

#pragma once

#include <cuda_runtime.h>

namespace nns_attn {

constexpr float kNegInf = -1e30f;  // NEG_INF

// scaled_qk, one column: the float32 dot product times the scale.
__device__ __forceinline__ float scaled(float dot, float scale) { return dot * scale; }

// dequant_rows, one element: payload times its row's scale.
__device__ __forceinline__ float dequant(float x, float row_scale) { return x * row_scale; }

// mask_dead_columns, the score half: columns at or past live_len.
__device__ __forceinline__ float mask_dead_score(float s, int col, int live_len) {
  return col < live_len ? s : kNegInf;
}

// online_softmax_init: running max at NEG_INF, denominator at 0 (the caller
// zeroes its accumulator).
__device__ __forceinline__ void online_softmax_init(float& m, float& l) {
  m = kNegInf;
  l = 0.0f;
}

// online_softmax_update, the rescale of the running state.
__device__ __forceinline__ float online_softmax_alpha(float m_prev, float m_new) {
  return m_prev <= kNegInf ? 0.0f : expf(m_prev - m_new);
}

// online_softmax_update, one column's weight.
__device__ __forceinline__ float online_softmax_weight(float s, float m_new) {
  return m_new <= kNegInf ? 0.0f : expf(s - m_new);
}

// online_softmax_finalize, one output element.
__device__ __forceinline__ float online_softmax_finalize(float l, float acc) {
  return l > 0.0f ? acc / fmaxf(l, 1e-30f) : 0.0f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace nns_attn
