// Single-token decode attention through block tables over a shared KV
// arena (the paged layout), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/paged_attention.py
// (paged_decode_attention :136, body _kernel :64, pallas_call at :202). It
// computes what that kernel computes: for every slot b and query head h, one
// query row q[b, 0, h] attends the history rows 0 .. hist-1 of kv head
// h / (H/KV), hist = min(pos[b], nb * bs), where history row r lives at row
// r % bs of arena block tables[b, r / bs]; then the pending token's own
// fresh_k / fresh_v (position pos, always live) is folded in last, so the
// reduction runs in position order. An int8 arena is dequantized in-kernel
// by per-token-per-head float32 scales. Out [B, 1, H, D] float32. The
// recurrence is the shared one of attn_primitives.cuh, so the plain PyTorch
// version (ops/kernels/paged_attention.py plain_paged_attention, built from
// ops/kernels/_primitives.py) is the same function.
//
// Bound. Memory: the kernel must read each live arena row once,
// bytes = sum_b hist_b * KV * D * 2 (K and V) * bytes per element, plus the
// int8 scales (sum_b hist_b * KV * 2 * 4), plus the table entries it uses
// (sum_b ceil(hist_b / bs) * 4), plus q, fresh_k/v and out, at 3.35 TB/s.
// The operations (4 * D per live row and query head) sit far below the
// card's rate.
//
// Design (the first, simple version).
// - Grid: one block per (kv head, slot), B * KV blocks. The TPU grid is
//   (b, h, arena block) and its index map hi // group re-reads each arena
//   block once for every query head of the group. Here one block serves all
//   g = H / KV query heads of its kv head, so every live row leaves device
//   memory once.
// - Indices: the block reads its own table row (the TPU prefetched it as a
//   scalar operand). hist is read from pos on the device (no host sync);
//   table entries at or past ceil(hist / bs) are never read, nor are their
//   arena blocks (they point at scratch block 0).
// - Tiles of rows, not of arena blocks: the block walks the history in
//   64-row tiles whatever bs is (attn_tile.cuh attend_history, the loop the
//   slot kernel K3 runs too), each row addressed through the table. At bs 16
//   a tile spans four arena blocks; any bs works. A loop of one iteration
//   per 16-row arena block would pay the per-tile round trip (~8.6 us in
//   K3) four times as often. The ragged last tile is masked as
//   mask_dead_columns does, so NaN in scratch or stale rows never reaches
//   the output.
// - The pending token: after the last tile its fresh_k / fresh_v go through
//   the same online-softmax update, then the l == 0 guard of the finalize.
// - Later work, not here: split-K over long histories with a combine pass,
//   cp.async / TMA double buffering, tensor-core mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

using namespace nns_attn;

namespace {

// One element of the pending token's K or V (float32 or bfloat16).
__device__ __forceinline__ float fresh_at(const void* p, int fresh_bf16, size_t i) {
  return fresh_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}

template <typename QT, typename CT, bool kQuant>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const QT* __restrict__ q, const CT* __restrict__ ak,
                           const CT* __restrict__ av, const float* __restrict__ ks,
                           const float* __restrict__ vs, const int* __restrict__ tables,
                           const int* __restrict__ pos, const void* __restrict__ fk,
                           const void* __restrict__ fv, int fresh_bf16,
                           float* __restrict__ out, int nb, int bs, int H, int KV, int D,
                           float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / KV;
  float* q_s = smem + 2 * kTile * (D + 1);           // [g][D], after the tiles
  float* fk_s = smem + history_smem_bytes(D, g) / sizeof(float);  // [D]
  float* fv_s = fk_s + D;                                           // [D]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the group's query rows: heads kh * g .. kh * g + g - 1 of slot b
  const size_t qrow = static_cast<size_t>(b) * H + static_cast<size_t>(kh) * g;
  for (int i = tid; i < g * D; i += kThreads) q_s[i] = to_f(q[qrow * D + i]);
  const size_t frow = (static_cast<size_t>(b) * KV + kh) * D;
  for (int i = tid; i < D; i += kThreads) {
    fk_s[i] = fresh_at(fk, fresh_bf16, frow + i);
    fv_s[i] = fresh_at(fv, fresh_bf16, frow + i);
  }

  // history rows 0 .. hist-1 live in arena blocks, clamped to the table's
  // reach so a stale lane never walks past it
  const int p = pos[b];
  const int hist = p <= 0 ? 0 : min(p, nb * bs);
  const int* tab = tables + static_cast<size_t>(b) * nb;
  HeadState st;
  st.init();
  attend_history<CT, kQuant>(
      ak, av, ks, vs,
      [=](int r) {
        const int lb = r / bs;
        return (static_cast<size_t>(__ldg(tab + lb)) * bs + (r - lb * bs)) * KV + kh;
      },
      hist, D, g, scale, smem, st);

  // the pending token's column (position pos, always live), folded last,
  // then the l == 0 guard of the finalize
#pragma unroll
  for (int hi = 0; hi < kHeadsPerWarp; ++hi) {
    const int hh = warp + hi * kWarps;
    if (hh >= g) break;
    const float* qh = q_s + hh * D;
    float dot = 0.0f;
    for (int d = lane; d < D; d += 32) dot = fmaf(qh[d], fk_s[d], dot);
    const float s1 = scaled(warp_sum(dot), scale);
    const float m_new = fmaxf(st.m[hi], s1);
    const float alpha = online_softmax_alpha(st.m[hi], m_new);
    const float p1 = online_softmax_weight(s1, m_new);
    const float lf = st.l[hi] * alpha + p1;
    float* o = out + (qrow + hh) * D;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        o[d] = online_softmax_finalize(lf, fmaf(p1, fv_s[d], st.acc[hi][i] * alpha));
      }
    }
  }
}

template <typename QT, typename CT, bool kQuant>
int launch(const void* q, const void* ak, const void* av, const float* ks, const float* vs,
           const int* tables, const int* pos, const void* fk, const void* fv, int fresh_bf16,
           float* out, int B, int nb, int bs, int H, int KV, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = history_smem_bytes(D, H / KV) + sizeof(float) * 2 * D;
  auto kernel = paged_attention_kernel<QT, CT, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(ak), static_cast<const CT*>(av), ks, vs,
      tables, pos, fk, fv, fresh_bf16, out, nb, bs, H, KV, D, scale);
  return cudaGetLastError();
}

template <typename QT>
int launch_arena(int arena_dtype, const void* q, const void* ak, const void* av,
                 const float* ks, const float* vs, const int* tables, const int* pos,
                 const void* fk, const void* fv, int fresh_bf16, float* out, int B, int nb,
                 int bs, int H, int KV, int D, float scale, cudaStream_t stream) {
  switch (arena_dtype) {
    case kF32:
      return launch<QT, float, false>(q, ak, av, ks, vs, tables, pos, fk, fv, fresh_bf16, out,
                                      B, nb, bs, H, KV, D, scale, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16, false>(q, ak, av, ks, vs, tables, pos, fk, fv,
                                              fresh_bf16, out, B, nb, bs, H, KV, D, scale,
                                              stream);
    case kI8:
      return launch<QT, int8_t, true>(q, ak, av, ks, vs, tables, pos, fk, fv, fresh_bf16, out,
                                      B, nb, bs, H, KV, D, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). q: [B, 1, H, D] (q_dtype 0 = f32,
// 1 = bf16); ak, av: one layer's arena [N, bs, KV, D] contiguous
// (arena_dtype 0 = f32, 1 = bf16, 2 = int8 with ks, vs [N, bs, KV] float32,
// else ks = vs = NULL); tables: [B, nb] int32 block ids, every entry below
// ceil(min(pos[b], nb * bs) / bs) in 0 .. N-1 (the caller's contract, not
// checked here); pos: [B] int32 history lengths; fk, fv: [B, 1, KV, D] the
// pending token's K/V (fresh_dtype 0 = f32, 1 = bf16); out: [B, 1, H, D]
// float32. Needs H % KV == 0, H / KV <= 32, D % 4 == 0, D <= 256, 16-byte
// aligned arena rows for f32. Returns the cudaError_t of the launch; 0 means
// it was queued on `stream`.
extern "C" int nns_paged_attention(const void* q, int q_dtype, const void* ak, const void* av,
                                   int arena_dtype, const float* ks, const float* vs,
                                   const int* tables, const int* pos, const void* fk,
                                   const void* fv, int fresh_dtype, float* out, int B, int nb,
                                   int bs, int H, int KV, int D, float scale, void* stream) {
  if (B <= 0 || B > 65535 || nb <= 0 || bs <= 0 || KV <= 0 || KV > 65535 || H % KV != 0 ||
      H / KV > kMaxGroup || D <= 0 || D > kMaxD || D % 4 != 0)
    return cudaErrorInvalidValue;
  if (nb > (1 << 30) / bs) return cudaErrorInvalidValue;  // nb * bs must fit an int
  if ((arena_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (fresh_dtype != kF32 && fresh_dtype != kBF16) return cudaErrorInvalidValue;
  const int fresh_bf16 = fresh_dtype == kBF16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_arena<float>(arena_dtype, q, ak, av, ks, vs, tables, pos, fk, fv,
                                 fresh_bf16, out, B, nb, bs, H, KV, D, scale, s);
    case kBF16:
      return launch_arena<__nv_bfloat16>(arena_dtype, q, ak, av, ks, vs, tables, pos, fk, fv,
                                         fresh_bf16, out, B, nb, bs, H, KV, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
