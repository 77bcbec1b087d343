// The history loop of the port's single-token decode attention kernels,
// split across blocks (flash-decoding): one block attends one chunk of one
// slot's history rows for the query heads of one kv head, and leaves its
// partial online-softmax state (m, l, acc) in a float32 workspace; a
// combine kernel merges a slot's chunks and finalizes.
//
// Shared by decode_attention.cu (K3, a contiguous cache row per position)
// and paged_attention.cu (K4, a row found through the slot's block table):
// the two differ only in where history row r lives, which the caller gives
// as a row-address functor. The recurrence is attn_primitives.cuh's.
//
// - Chunks: the caller's chunk (a multiple of every tile height below) of
//   history rows; the split count comes from the cache's row count, known
//   on the host, and the live length is read from pos on the device, so a
//   block whose chunk starts at or past it returns at once and writes
//   nothing, and the combine reads only the chunks below the live length.
// - Ring: each chunk is walked in tiles of kTileRows rows, copied by
//   cp.async into a ring of kStages stages in their stored type (bf16 and
//   int8 widen at use, so a bf16 stage is half the bytes; int8 row scales
//   ride with their rows). Three tiles are in flight while one is
//   computed, and one block-wide barrier a tile frees its stage. Rows at or
//   past `live` are never read: cp.async zero-fills them (and the padded
//   columns past D), and they score NEG_INF (mask_dead_columns), so NaN in
//   stale or scratch rows never reaches the output.
// - Warps: a lane group of kTX lanes (16, or 32 at DP 256) takes one row at
//   a time, and the 32 / kTX groups of each warp take different rows, so
//   every warp works whatever g is. Within a group each of the GH query
//   heads has kTX / GH lanes, each holding DP / (kTX / GH) of its head's
//   dims of q and acc: the lanes of different heads read the same K and V
//   addresses (shared-memory broadcasts), a score is a sum over the head's
//   lanes only (log2(kTX / GH) shuffles), and each lane runs the softmax of
//   one head, with no work repeated across heads. A group scores
//   kRowsPerGroup rows a tile and runs one online-softmax update over them
//   (the rescale of acc skipped when no lane's max moved); at the end of
//   the chunk the groups' states are merged through shared memory
//   (online_softmax_merge) into the block's partial.
// - Instances: one per padded head dim DP (64, 128, 256; columns past D are
//   zero) and per heads a block GH (1, 2, 4, 8; a group of more than 8
//   query heads is split over several blocks, each reading its kv head's
//   rows again).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "attn_primitives.cuh"

namespace nns_attn {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;        // ring depth: kStages - 1 tiles in flight
constexpr int kRowsPerGroup = 2;  // rows a lane group takes from each tile
constexpr int kMaxD = 256;
constexpr int kMaxGroup = 32;     // query heads per kv head
constexpr int kMaxChunk = 1024;   // history rows a block, at most
constexpr int kChunkAlign = 32;   // a chunk is a multiple of every tile height
constexpr int kCombineThreads = 128;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Rows: a lane group of kTX lanes a row; kTileRows rows a tile.
template <int DP>
struct Geometry {
  static constexpr int kTX = DP == 256 ? 32 : 16;
  static constexpr int kGroupsPerWarp = 32 / kTX;                // 2, 1
  static constexpr int kGroups = kWarps * kGroupsPerWarp;        // 8, 4
  static constexpr int kTileRows = kGroups * kRowsPerGroup;      // 16, 8
  static_assert(kChunkAlign % kTileRows == 0, "a chunk must hold whole tiles");
};

// Heads: GH heads of kLH lanes a group, kE of a head's dims a lane, read
// from shared memory kVL elements (at most 16 bytes) at a time: lane lh of
// a head holds dims kVL * (lh + j * kLH) + v, j < kE / kVL, v < kVL.
template <typename CT, int DP, int GH>
struct Lanes {
  static constexpr int kLH = Geometry<DP>::kTX / GH;
  static constexpr int kE = DP / kLH;
  static constexpr int kMaxVL = 16 / static_cast<int>(sizeof(CT));
  static constexpr int kVL = kE < kMaxVL ? kE : kMaxVL;
  static constexpr int kNL = kE / kVL;
  static_assert(kLH >= 2 && kE % kVL == 0, "a head has lanes and whole loads");
};

template <typename CT, bool kQuant, int DP>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * Geometry<DP>::kTileRows * (DP * sizeof(CT) + (kQuant ? sizeof(float) : 0));
}

// Dynamic shared memory of attend_chunk: the ring, reused after the loop
// for the groups' states (m and l, acc) and their merge weights.
template <typename CT, bool kQuant, int DP, int GH>
__host__ __device__ constexpr size_t chunk_smem_bytes() {
  constexpr size_t ring = kStages * stage_bytes<CT, kQuant, DP>();
  constexpr size_t merge = sizeof(float) * Geometry<DP>::kGroups * GH * (DP + 3);
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes (16, 8 or 4) global → shared, or as many zero bytes where !valid.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    static_assert(kBytes == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 2 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  static_assert(kStages == 4, "the wait count below is kStages - 2");
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kVL consecutive elements of a staged row, widened to float32 (one
// shared-memory read of kVL * sizeof(CT) bytes).
template <int kVL>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[kVL]) {
  static_assert(kVL == 4, "float32 is read 16 bytes at a time");
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

template <int kVL>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[kVL]) {
  uint32_t w[kVL / 2];
  if constexpr (kVL == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  } else {
    static_assert(kVL == 4, "bfloat16 is read 8 or 16 bytes at a time");
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  }
#pragma unroll
  for (int i = 0; i < kVL / 2; ++i) {
    __nv_bfloat162 h2;
    memcpy(&h2, &w[i], sizeof(h2));
    const float2 f = __bfloat1622float2(h2);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Four int8 values packed in w, widened to float32 exactly with integer
// and add operations: the biased byte x + 128 goes into the low mantissa
// bits of 2^23, and 2^23 + 128 comes off. (The int-to-float conversion
// instruction runs at a quarter of the rate, and with every head's lanes
// widening the same row it bounded the int8 kernels.)
__device__ __forceinline__ void widen_int8x4(int w, float* x) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388736.0f;
}

template <int kVL>
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[kVL]) {
  if constexpr (kVL == 16) {
    const int4 r = *reinterpret_cast<const int4*>(p);
    widen_int8x4(r.x, x);
    widen_int8x4(r.y, x + 4);
    widen_int8x4(r.z, x + 8);
    widen_int8x4(r.w, x + 12);
  } else if constexpr (kVL == 8) {
    const int2 r = *reinterpret_cast<const int2*>(p);
    widen_int8x4(r.x, x);
    widen_int8x4(r.y, x + 4);
  } else {
    static_assert(kVL == 4, "int8 is read 4, 8 or 16 bytes at a time");
    widen_int8x4(*reinterpret_cast<const int*>(p), x);
  }
}

// Element i of a float32 or bfloat16 vector.
__device__ __forceinline__ float f32_or_bf16(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Queue the copies of history rows r0 .. r0 + kTileRows - 1 into a stage
// ([rows][DP] K, then V, in the stored type; then the int8 rows' K and V
// scales). Rows at or past `live` and columns past D are zero-filled and
// row_of is not called for them. `wide`: D * sizeof(CT) % 16 == 0, so rows
// are copied in 16-byte pieces; else in pieces of 4 elements.
template <typename CT, bool kQuant, int DP, typename RowOf>
__device__ __forceinline__ void issue_tile(unsigned char* stage, const CT* __restrict__ ck,
                                           const CT* __restrict__ cv,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, RowOf row_of, int r0,
                                           int live, int D, bool wide) {
  constexpr int TR = Geometry<DP>::kTileRows;
  CT* k_s = reinterpret_cast<CT*>(stage);
  CT* v_s = k_s + TR * DP;
  if (sizeof(CT) == 4 || wide) {
    constexpr int kVec = 16 / sizeof(CT);
    constexpr int kPerRow = DP / kVec;
    constexpr int kCopies = TR * kPerRow;
#pragma unroll
    for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + static_cast<int>(threadIdx.x);
      if (kCopies % kThreads != 0 && i >= kCopies) break;
      const int j = i / kPerRow;
      const int c = (i % kPerRow) * kVec;
      const bool valid = r0 + j < live && c < D;
      const size_t off = valid ? row_of(r0 + j) * D + c : 0;
      cp_async<16>(k_s + j * DP + c, ck + off, valid);
      cp_async<16>(v_s + j * DP + c, cv + off, valid);
    }
  } else {
    constexpr int kPerRow = DP / 4;
    constexpr int kCopies = TR * kPerRow;
#pragma unroll
    for (int it = 0; it < (kCopies + kThreads - 1) / kThreads; ++it) {
      const int i = it * kThreads + static_cast<int>(threadIdx.x);
      if (kCopies % kThreads != 0 && i >= kCopies) break;
      const int j = i / kPerRow;
      const int c = (i % kPerRow) * 4;
      const bool valid = r0 + j < live && c < D;
      const size_t off = valid ? row_of(r0 + j) * D + c : 0;
      cp_async<static_cast<int>(4 * sizeof(CT))>(k_s + j * DP + c, ck + off, valid);
      cp_async<static_cast<int>(4 * sizeof(CT))>(v_s + j * DP + c, cv + off, valid);
    }
  }
  if constexpr (kQuant) {
    float* ks_s = reinterpret_cast<float*>(v_s + TR * DP);
    float* vs_s = ks_s + TR;
    for (int j = threadIdx.x; j < TR; j += kThreads) {
      const bool valid = r0 + j < live;
      const size_t row = valid ? row_of(r0 + j) : 0;
      cp_async<4>(ks_s + j, ks + row, valid);
      cp_async<4>(vs_s + j, vs + row, valid);
    }
  }
}

// Attend history rows c0 .. min(c0 + chunk, live) - 1 (c0 < live) of one kv
// head for its query heads h0 .. h0 + n_heads - 1 (n_heads <= GH; q rows
// q_row0 .., float32 or bfloat16), and write the block's partial state of
// head h to ws[(ws_row0 + h * splits) * (D + 2)]: acc at 0 .. D-1, m at D,
// l at D + 1. row_of(r) gives the row index of history row r: its K/V
// elements start at ck/cv + row * D and its int8 scales sit at ks/vs[row].
// smem: chunk_smem_bytes<CT, kQuant, DP, GH>() bytes, 16-byte aligned.
template <typename CT, bool kQuant, int DP, int GH, typename RowOf>
__device__ __forceinline__ void attend_chunk(const void* __restrict__ q, int q_bf16,
                                             size_t q_row0, int n_heads,
                                             const CT* __restrict__ ck,
                                             const CT* __restrict__ cv,
                                             const float* __restrict__ ks,
                                             const float* __restrict__ vs, RowOf row_of, int c0,
                                             int chunk, int live, int D, float scale,
                                             float* __restrict__ ws, size_t ws_row0, int splits,
                                             unsigned char* smem) {
  using G = Geometry<DP>;
  using L = Lanes<CT, DP, GH>;
  constexpr int NG = G::kGroups;
  constexpr int TR = G::kTileRows;
  constexpr int LH = L::kLH;
  constexpr int E = L::kE;
  constexpr int VL = L::kVL;
  constexpr int NL = L::kNL;
  constexpr size_t kStageB = stage_bytes<CT, kQuant, DP>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gi = (tid >> 5) * G::kGroupsPerWarp + lane / G::kTX;  // this lane's row group
  const int hh = lane % G::kTX / LH;                              // its head in the block
  const int lh = lane % LH;                                       // its place in the head
  const bool wide = (D * sizeof(CT)) % 16 == 0;
  const int n_tiles = (min(chunk, live - c0) + TR - 1) / TR;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      issue_tile<CT, kQuant, DP>(smem + s * kStageB, ck, cv, ks, vs, row_of, c0 + s * TR, live,
                                 D, wide);
    cp_async_commit();
  }

  // this lane's dims of its head's query row, float32 (zero past D and for
  // a head past n_heads, which is computed and never written)
  float qr[E];
#pragma unroll
  for (int j = 0; j < NL; ++j)
#pragma unroll
    for (int v = 0; v < VL; ++v) {
      const int d = VL * (lh + j * LH) + v;
      qr[j * VL + v] =
          hh < n_heads && d < D ? f32_or_bf16(q, q_bf16, (q_row0 + hh) * D + d) : 0.0f;
    }

  float m, l, acc[E];
  online_softmax_init(m, l);
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;

  for (int ti = 0; ti < n_tiles; ++ti) {
    cp_async_wait_ring();
    __syncthreads();  // tile ti has landed for every thread; its stage's last readers are done
    {
      const int nt = ti + kStages - 1;
      if (nt < n_tiles)
        issue_tile<CT, kQuant, DP>(smem + (nt % kStages) * kStageB, ck, cv, ks, vs, row_of,
                                   c0 + nt * TR, live, D, wide);
      cp_async_commit();  // possibly empty: one group an iteration
    }
    const unsigned char* st = smem + (ti % kStages) * kStageB;
    const CT* k_s = reinterpret_cast<const CT*>(st);
    const CT* v_s = k_s + TR * DP;
    const float* ks_s = reinterpret_cast<const float*>(v_s + TR * DP);
    const float* vs_s = ks_s + TR;
    const int r0 = c0 + ti * TR;

    float s[kRowsPerGroup];
#pragma unroll
    for (int jr = 0; jr < kRowsPerGroup; ++jr) {
      const int row = gi + NG * jr;
      const CT* kr = k_s + row * DP;
      float dot[2] = {0.0f, 0.0f};  // two chains
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        float kx[VL];
        load_vec<VL>(kr + VL * (lh + j * LH), kx);
#pragma unroll
        for (int v = 0; v < VL; ++v) dot[j & 1] = fmaf(qr[j * VL + v], kx[v], dot[j & 1]);
      }
      float sc = dot[0] + dot[1];
      if constexpr (kQuant) sc = dequant(sc, ks_s[row]);  // q · (k * s) = (q · k) * s
#pragma unroll
      for (int off = LH / 2; off > 0; off >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, off);
      s[jr] = mask_dead_score(scaled(sc, scale), r0 + row, live);
    }
    float tile_max = s[0];
#pragma unroll
    for (int jr = 1; jr < kRowsPerGroup; ++jr) tile_max = fmaxf(tile_max, s[jr]);
    const float m_new = fmaxf(m, tile_max);
    const float alpha = online_softmax_alpha(m, m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jr = 0; jr < kRowsPerGroup; ++jr) {
      s[jr] = online_softmax_weight(s[jr], m_new);
      psum += s[jr];
    }
    l = l * alpha + psum;
    m = m_new;
    if (!__all_sync(0xffffffffu, alpha == 1.0f)) {  // a max moved (alpha 1 is exact otherwise)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
    }
#pragma unroll
    for (int jr = 0; jr < kRowsPerGroup; ++jr) {  // dead rows weigh 0 against zero V
      const int row = gi + NG * jr;
      const CT* vr = v_s + row * DP;
      const float p = kQuant ? s[jr] * vs_s[row] : s[jr];  // p · (v * s) = (p * s) · v
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        float vx[VL];
        load_vec<VL>(vr + VL * (lh + j * LH), vx);
#pragma unroll
        for (int v = 0; v < VL; ++v) acc[j * VL + v] = fmaf(p, vx[v], acc[j * VL + v]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: reuse it for the groups' states

  float* ml_s = reinterpret_cast<float*>(smem);  // [NG][GH] (m, l)
  float* w_s = ml_s + NG * GH * 2;               // [GH][NG] merge weights
  float* acc_s = w_s + NG * GH;                  // [NG][GH][DP]
  if (lh == 0) {
    ml_s[(gi * GH + hh) * 2] = m;
    ml_s[(gi * GH + hh) * 2 + 1] = l;
  }
#pragma unroll
  for (int j = 0; j < NL; ++j)
#pragma unroll
    for (int v = 0; v < VL; ++v)
      acc_s[(gi * GH + hh) * DP + VL * (lh + j * LH) + v] = acc[j * VL + v];
  __syncthreads();
  for (int i = tid; i < GH * NG; i += kThreads) {
    const int h = i / NG;
    float mx = kNegInf;
#pragma unroll
    for (int g2 = 0; g2 < NG; ++g2) mx = fmaxf(mx, ml_s[(g2 * GH + h) * 2]);
    w_s[i] = online_softmax_merge_weight(ml_s[(i % NG * GH + h) * 2], mx);
  }
  __syncthreads();
  for (int i = tid; i < GH * DP; i += kThreads) {
    const int h = i / DP;
    const int d = i % DP;
    if (h >= n_heads || d >= D) continue;
    float a = 0.0f;
#pragma unroll
    for (int g2 = 0; g2 < NG; ++g2) a = fmaf(w_s[h * NG + g2], acc_s[(g2 * GH + h) * DP + d], a);
    float* w = ws + (ws_row0 + static_cast<size_t>(h) * splits) * (D + 2);
    w[d] = a;
    if (d == 0) {
      float mx = kNegInf, sum = 0.0f;
#pragma unroll
      for (int g2 = 0; g2 < NG; ++g2) {
        mx = fmaxf(mx, ml_s[(g2 * GH + h) * 2]);
        sum = fmaf(w_s[h * NG + g2], ml_s[(g2 * GH + h) * 2 + 1], sum);
      }
      w[D] = mx;
      w[D + 1] = sum;
    }
  }
}

// The merged state of one query head's first n_live chunk partials (rows
// of D + 2 floats from w, as attend_chunk writes them), for this thread's
// dims threadIdx.x + k * kCombineThreads (acc[k], when below D): the
// chunks are read kBatch at a time, all loads of a batch in flight
// together, and each batch is merged into the running state.
__device__ __forceinline__ void combine_chunks(const float* __restrict__ w, int n_live, int D,
                                               float& m, float& l,
                                               float (&acc)[kMaxD / kCombineThreads]) {
  constexpr int kBatch = 16;
  constexpr int K = kMaxD / kCombineThreads;
  const size_t row = D + 2;
  online_softmax_init(m, l);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int s0 = 0; s0 < n_live; s0 += kBatch) {
    float bm[kBatch], bl[kBatch], ba[kBatch][K];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = s0 + i < n_live;
      const float* p = w + (ok ? s0 + i : s0) * row;
      bm[i] = ok ? p[D] : kNegInf;  // a missing chunk is the empty state
      bl[i] = ok ? p[D + 1] : 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = threadIdx.x + k * kCombineThreads;
        ba[i][k] = ok && d < D ? p[d] : 0.0f;
      }
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) mx = fmaxf(mx, bm[i]);
    const float a = online_softmax_merge_weight(m, mx);
    l *= a;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] *= a;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const float wi = online_softmax_merge_weight(bm[i], mx);
      l = fmaf(wi, bl[i], l);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(wi, ba[i][k], acc[k]);
    }
    m = mx;
  }
}

// Query heads a block for a group of g: 1, 2, 4 or 8.
__host__ __device__ __forceinline__ int heads_per_block(int g) {
  return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
}

}  // namespace nns_attn
