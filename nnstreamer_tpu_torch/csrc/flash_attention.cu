// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/flash_attention.py
// (flash_attention :121, body _kernel :47, blocking _blocking :108,
// pallas_call at :158). It computes what that kernel computes: q, k, v
// [B, T, H, D] (float32 or bfloat16, widened to float32 on load) → out
// [B, T, H, D] float32, causal or full, softmax((q · kᵀ) * scale) · v with
// the online-softmax recurrence of attn_primitives.cuh and its guards. The
// plain PyTorch version (ops/kernels/flash_attention.py
// plain_flash_attention, built from ops/kernels/_primitives.py) is the same
// function.
//
// Bound. Operations: 4 * D multiply-adds' worth of flops per live (query,
// key) pair, 4 * B * H * T^2 * D / 2 for causal attention (137.4 GFLOP at
// B 1, T 4096, H 32, D 128: 2.05 ms at the card's 67 TFLOP/s of float32
// outside the tensor cores; the reference's float32 products rule out
// TF32). Bytes: q, k, v read once and out written once (268 MB in float32
// at that shape, 0.080 ms at 3.35 TB/s). So the kernel is bound by
// operations, not bytes.
//
// Design (the first, simple version: CUDA cores, float32 throughout).
// - Grid: one block per (query tile of 64 rows, head, batch). The TPU grid's
//   sequential "arbitrary" key axis becomes a loop inside the block over the
//   key tiles in order, each query row's (m, l, acc) held in registers
//   across it. Query tiles are issued longest first, so the causal
//   triangle's long rows do not trail.
// - Layout: q, k, v are read in the [B, T, H, D] layout through their own
//   strides (a view sliced out of a fused projection is taken as it is) and
//   out is written [B, T, H, D] directly: no transpose, no padded copy.
//   Rows at or past T are zero-filled on load and never written.
// - Skipped tiles: key tiles entirely above the diagonal (causal) or past T
//   are never loaded, as the reference's `live` predicate skips them; the
//   diagonal and ragged tiles are masked per element to NEG_INF.
// - Work split: 256 threads as 16 x 16; thread (ty, tx) owns query rows
//   4ty .. 4ty+3. For S = Q Kᵀ it computes the 4 x 4 scores at key columns
//   4tx .. 4tx+3 from Qᵀ and Kᵀ staged in shared memory (one float4 of each
//   per d); the 16 threads of a row group reduce max and sum with shuffles;
//   P goes to shared memory transposed, and for O += P V each thread
//   accumulates D / 16 output columns of its 4 rows from V staged row-major.
//   K and V share one buffer (K first, then V), which keeps D = 128 at 85
//   KB of shared memory, two blocks an SM.
// - Later work, not here: tensor cores (wgmma on bf16, which the reference's
//   2e-5 tolerance does not allow for float32 inputs), TMA or cp.async
//   double buffering of the K and V tiles, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_primitives.cuh"
#include "attn_tile.cuh"  // load4, DType

using namespace nns_attn;

namespace {

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 64;          // key rows a tile
constexpr int kFlashThreads = 256;
constexpr int kRowsPerThread = kBQ / 16;  // 4
constexpr int kColsPerThread = kBK / 16;  // 4
constexpr int kLdT = kBQ + 4;    // row length of the transposed tiles (float4-aligned)
static_assert(kBQ == kBK, "the transposed Q and K tiles share one row length");

__host__ __device__ constexpr int kv_floats(int D) {
  return D * kLdT > kBK * (D + 4) ? D * kLdT : kBK * (D + 4);
}

__host__ __device__ constexpr size_t flash_smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(D) * kLdT + kv_floats(D) + kBK * kLdT);
}

// Rows r0 .. r0+63 of one head ([row][D] at `base`, rows `row_stride`
// elements apart) into dst[d][row] as float32; rows at or past T are zero.
// Neighbouring threads take neighbouring rows, so the shared-memory writes
// are conflict-free.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(const T* __restrict__ base, int64_t row_stride,
                                                 int r0, int T_len, float* dst) {
  for (int i = threadIdx.x; i < kBQ * (D / 4); i += kFlashThreads) {
    const int j = i % kBQ;
    const int c = (i / kBQ) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + j < T_len) load4(base + (r0 + j) * row_stride + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(c + e) * kLdT + j] = x[e];
  }
}

// The same rows into dst[row][d] (row length D + 4), for P V.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base, int64_t row_stride, int r0,
                                           int T_len, float* dst) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kBK * kVecs; i += kFlashThreads) {
    const int j = i / kVecs;
    const int c = (i - j * kVecs) * 4;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r0 + j < T_len) load4(base + (r0 + j) * row_stride + c, x);
    *reinterpret_cast<float4*>(dst + j * (D + 4) + c) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  int64_t b, t, h;  // elements between batches, tokens and heads (D is contiguous)
};

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads, D <= 128 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, float* __restrict__ out, int T_len, int H,
                           Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int kCpt = D / 16;                // output columns a thread
  constexpr int kVec = kCpt < 4 ? kCpt : 4;   // of them contiguous
  constexpr int kGroups = kCpt / kVec;
  constexpr int kLdV = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                // Qᵀ [D][kLdT]
  float* kv = q_t + D * kLdT;       // Kᵀ [D][kLdT], then V [kBK][kLdV]
  float* p_t = kv + kv_floats(D);   // Pᵀ [kBK][kLdT]

  const int n_q = (T_len + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qh = q + b * qs.b + h * qs.h;
  const T* kh = k + b * ks.b + h * ks.h;
  const T* vh = v + b * vs.b + h * vs.h;
  stage_transposed<T, D>(qh, qs.t, q0, T_len, q_t);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kCpt];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    online_softmax_init(m[i], l[i]);
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.0f;
  }

  // the live key tiles: up to the tile of the block's last valid row
  // (causal), or every tile below T
  const int last_row = min(q0 + kBQ, T_len) - 1;
  const int n_kt = causal ? last_row / kBK + 1 : (T_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Qᵀ staged; the previous tile's V and Pᵀ readers are done
    stage_transposed<T, D>(kh, ks.t, k0, T_len, kv);
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kLdT + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * kLdT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + ty * 4 + i;
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool dead = col >= T_len || (causal && col > row);
        s[i][j] = dead ? kNegInf : scaled(s[i][j], scale);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(tile_max));
      const float alpha = online_softmax_alpha(m[i], m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        s[i][j] = online_softmax_weight(s[i][j], m_new);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kLdT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // Kᵀ readers done, Pᵀ written
    stage_rows<T, D>(vh, vs.t, k0, T_len, kv);
    __syncthreads();

    const int n_cols = min(kBK, T_len - k0);  // rows past T are zero and weigh 0
#pragma unroll 4
    for (int c = 0; c < n_cols; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(p_t + c * kLdT + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float* vr = kv + c * kLdV + tx * kVec;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float x[kVec];
        if constexpr (kVec == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vr + g * 16 * kVec);
          x[0] = t4.x;
          x[1] = t4.y;
          x[2] = t4.z;
          x[3] = t4.w;
        } else if constexpr (kVec == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vr + g * 16 * kVec);
          x[0] = t2.x;
          x[1] = t2.y;
        } else {
          x[0] = vr[g * 16 * kVec];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][g * kVec + e] = fmaf(pv[i], x[e], acc[i][g * kVec + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
    float* o = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + tx * kVec;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        o[g * 16 * kVec + e] = online_softmax_finalize(l[i], acc[i][g * kVec + e]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, float* out, int B, int T_len, int H,
           Strides qs, Strides ks, Strides vs, float scale, int causal, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(D);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), out, T_len,
      H, qs, ks, vs, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, float* out, int B, int T_len, int H,
               int D, Strides qs, Strides ks, Strides vs, float scale, int causal,
               cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, T_len, H, qs, ks, vs, scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, out, B, T_len, H, qs, ks, vs, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, T_len, H, qs, ks, vs, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, T_len, H, qs, ks, vs, scale, causal, s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, T_len, H, qs, ks, vs, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v: [B, T, H, D] of dtype
// 0 = float32 or 1 = bfloat16, D contiguous, the other axes at the given
// element strides (each a multiple of 4, the pointers aligned to four
// elements); out: [B, T, H, D] float32, contiguous. D is 16, 32, 64, 128 or
// 256. Returns the cudaError_t of the launch; 0 means it was queued on
// `stream`.
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v, int dtype,
                                   float* out, int B, int T, int H, int D,
                                   const long long* strides, float scale, int causal,
                                   void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dim<float>(q, k, v, out, B, T, H, D, qs, ks, vs, scale, causal, s);
    case kBF16:
      return launch_dim<__nv_bfloat16>(q, k, v, out, B, T, H, D, qs, ks, vs, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
