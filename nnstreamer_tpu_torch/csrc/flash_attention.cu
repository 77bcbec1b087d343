// Flash prefill attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/flash_attention.py
// (flash_attention :121, body _kernel :47, blocking _blocking :108,
// pallas_call at :158). It computes what that kernel computes: q, k, v
// [B, T, H, D] (float32, bfloat16 or float16, the three alike) → out
// [B, T, H, D] float32, causal or full, softmax((q · kᵀ) * scale) · v with
// the online-softmax recurrence of attn_primitives.cuh and its guards
// (m <= NEG_INF gives alpha 0 and p 0, l == 0 gives 0, dead V rows are
// zero-filled, expf). The plain PyTorch version
// (ops/kernels/flash_attention.py plain_flash_attention) is the same
// function; the kernel is held to 2e-5 against it, the reference's own
// tolerance.
//
// Bound, at B 1, T 4096, H 32, D 128, causal. Bytes: q, k, v read once and
// out written once, 268 MB in float32 (0.080 ms at 3.35 TB/s) and 168 MB
// with 16-bit inputs (0.050 ms). Operations: 4 * D flops per live (query,
// key) pair, 137.5 GFLOP. By route: float32 runs three TF32 products a
// pair (0.834 ms at 495 TFLOP/s), the 16-bit route one product for Q·Kᵀ
// and two for P·V (1.5 x, 0.208 ms at 989 TFLOP/s; a single product a
// pair would be 0.139 ms). Every route is bound by operations.
//
// Precision. The reference holds float32 and bfloat16 inputs alike to 2e-5
// against float32 attention, which one bf16 or TF32 product cannot keep.
// So every product is split until it does:
// - 16-bit route (bf16, fp16): S = Q·Kᵀ is one wgmma of the inputs as
//   stored (a product of two 16-bit values is exact in float32, the sum is
//   float32). P is float32 in registers; it is scaled by 2^12 (exact; it
//   keeps fp16's P_lo out of the subnormals) and split as
//   P_hi = rn16(P), P_lo = rn16(P - P_hi), and O += P_hi·V + P_lo·V by two
//   wgmmas against the same V tile: P is carried to 2^-18 (bf16) or 2^-22
//   (fp16) relative.
// - float32 route: 3xTF32 with mma.sync.m16n8k8 (warp-level; wgmma's TF32
//   form takes only K-major operands, so V would have to be transposed
//   into shared memory, and a two-stage ring of pre-split hi/lo tiles does
//   not fit): each operand is split in registers as it is loaded,
//   a = a_hi + a_lo in TF32, and a_lo·b_hi + a_hi·b_lo + a_hi·b_hi keeps
//   about 2^-21 relative a product.
//
// Design.
// - Grid: one block per (64-row query tile, head, batch), 128 threads: one
//   warpgroup (16-bit route) or four warps of 16 rows (float32). The TPU
//   grid's sequential key axis becomes a loop over the key tiles in order,
//   each row's (m, l, acc) in registers. Query tiles are issued longest
//   first. Key tiles entirely above the diagonal or past T are never
//   loaded; the diagonal and ragged tiles are masked per element.
// - Head dims: any D with D % 8 == 0 up to 256, on a kernel built for the
//   padded width DP in {64, 128, 256}. Columns D .. DP of Q, K and V are
//   zero-filled in shared memory (they add nothing to Q·Kᵀ or to the
//   first D columns of P·V), the products run over all DP columns (no
//   branch in the tile loop), and only the first D output columns are
//   written.
// - Loads: cp.async (16 bytes a thread, zero-fill for rows past T and
//   columns past D) into a ring of two K/V stages: tile kt+1 is in flight
//   while tile kt is computed. cp.async rather than TMA: it reads any
//   strided [B, T, H, D] view (the transformer hands K5 V as a view of the
//   fused projection) with 16-byte alignment alone, its zero-fill gives
//   both paddings, and it needs no tensor map built on the host each call.
// - 16-bit tiles are stored in wgmma's 128-byte swizzle: D in atoms of 64
//   columns, each [rows][128 B] with 16-byte chunk c of row r at
//   c ^ (r % 8). Q and K are K-major operands as stored ([row][d]); V is
//   the MN-major B operand of P·V as stored ([key][d], transposed by
//   wgmma). P·V is issued as one m64n64k16 per 64 output columns. The S
//   accumulator's fragment is the A fragment of P·V (as FlashAttention-3
//   uses it), so P never goes through shared memory.
// - float32 tiles are stored [rows][DP + 4] floats, which makes every
//   fragment load of Q, K and V conflict-free. Both products relabel their
//   k index within each 8-wide step (k t ↔ 2t, k t+4 ↔ 2t+1): for Q·Kᵀ so
//   that a fragment pair is one 8-byte load, for P·V so that S's
//   accumulator fragment is P's A fragment here too.
// - Every product runs on the tensor cores, and nothing in the tile loop
//   branches per element: the guards of attn_primitives.cuh are branch-free
//   and the mask is one block-uniform branch, so a tile's exponentials,
//   loads and products pipeline.
// Resources a block of 128 threads (registers and spills a thread from
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xptxas -v, CUDA 12.8;
// shared memory from smem16_bytes / smem32_bytes; blocks an SM from these
// against the H100's 65,536 registers and 228 KB an SM):
//   DP 64:  bf16/fp16 161 registers, 41,984 B, 3 blocks an SM;
//           float32 137 registers, 52,224 B, 3 blocks; no spills.
//   DP 128: bf16 225, fp16 223 registers, 82,944 B, 2 blocks;
//           float32 216 registers, 101,376 B, 2 blocks; no spills.
//   DP 256: 255 registers, 164,864 B (16-bit) or 199,680 B (float32),
//           1 block; 304 B (16-bit) and 360 B (float32) of spills.
// What is left between this design and its route bound (3.3x at the main
// shape in 16-bit, 3.5x in float32, on an H100): the two products and the
// softmax of a tile run one after the other in each warpgroup, between two
// block-wide barriers; a producer warp on TMA with mbarriers, and two
// warpgroups that take turns (FlashAttention-3's schedule), would overlap
// them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_primitives.cuh"
#include "launch_info.cuh"

using namespace nns_attn;

namespace {

enum FlashDType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kBQ = 64;           // query rows a block
constexpr int kThreads = 128;     // one warpgroup
constexpr int kBK16 = 64;         // key rows a tile, 16-bit route
constexpr int kBK32 = 32;         // key rows a tile, float32 route
constexpr float kPScale = 4096.0f;  // 2^12: P_lo of fp16 stays normal

struct Strides {
  int64_t b, t, h;  // elements between batches, tokens and heads (D is contiguous)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, or 16 zero bytes where !valid (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The live key tiles of a query tile starting at q0: up to the tile of its
// last valid row (causal), or every tile below T.
__device__ __forceinline__ int live_key_tiles(int q0, int T_len, int causal, int bk) {
  const int last_row = min(q0 + kBQ, T_len) - 1;
  return causal ? last_row / bk + 1 : (T_len + bk - 1) / bk;
}

// One thread's two rows (a: lane / 4, b: lane / 4 + 8 of its warp's 16) of
// the online softmax over its N scores of a tile: s[r] belongs to row
// (r & 2 ? b : a). Masks, scales and exponentiates s in place, updates
// (m, l) and returns each row's alpha. The four threads of a quad share
// the rows; col(r) gives the key of s[r].
template <int N, typename ColFn>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row_a, int T_len,
                                             int causal, bool masked, float scale,
                                             ColFn col) {
#pragma unroll
  for (int r = 0; r < N; ++r) s[r] = scaled(s[r], scale);
  if (masked) {  // block-uniform: one branch around the whole mask
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int c = col(r);
      const int row = row_a + ((r & 2) ? 8 : 0);
      s[r] = (c >= T_len || (causal && c > row)) ? kNegInf : s[r];
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int r = 0; r < N; ++r) mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], s[r]);
  float m_new[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = online_softmax_alpha(m[i], m_new[i]);
    m[i] = m_new[i];
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    s[r] = online_softmax_weight(s[r], m_new[(r >> 1) & 1]);
    ps[(r >> 1) & 1] += s[r];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(ps[i]);
}

// ---------------------------------------------------------------------------
// The 16-bit route: wgmma
// ---------------------------------------------------------------------------

// A [64][DP] 16-bit tile in 128-byte swizzle atoms of 64 columns.
template <int DP>
__host__ __device__ constexpr uint32_t tile16_bytes() {
  return kBQ * DP * 2;
}

template <int DP>
__host__ __device__ constexpr size_t smem16_bytes() {
  return 1024 + 5 * static_cast<size_t>(tile16_bytes<DP>());  // Q, 2 x (K, V), alignment
}

// Rows r0 .. r0+63 of one head into a swizzled tile at dst: rows at or past
// T and columns at or past D are zero.
template <int DP>
__device__ __forceinline__ void load_tile16(uint32_t dst, const uint16_t* __restrict__ base,
                                            int64_t row_stride, int r0, int T_len, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kBQ * kChunks / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x);
    const int row = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r0 + row < T_len && c * 8 < D;
    const uint16_t* src = valid ? base + (r0 + row) * row_stride + c * 8 : base;
    const uint32_t off = (c / 8) * (kBQ * 128) + row * 128 + (((c % 8) ^ (row % 8)) << 4);
    cp_async16(dst + off, src, valid);
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at addr:
// 8-row groups 1024 bytes apart (the stride byte offset; for the MN-major
// V operand, whose 64-column extent is one atom, the same 1024 also stands
// in the leading byte offset).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define NNS_ACC32_STR                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define NNS_ACC32_OPS(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] += A[64 x 16] · B[16 x 64], both from shared memory, both
// K-major (Q and K as stored). scale-d is a predicate, set from a register.
#define NNS_WGMMA_SS(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " NNS_ACC32_STR \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
               : NNS_ACC32_OPS(d)                                                      \
               : "l"(da), "l"(db), "r"(1))

template <bool kHalf>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (kHalf) {
    NNS_WGMMA_SS("f16");
  } else {
    NNS_WGMMA_SS("bf16");
  }
}

// d[64 x 64] += A[64 x 16] · B[16 x 64], A from registers (four packed
// pairs a thread), B from shared memory MN-major (V as stored, transposed
// by the instruction: imm-trans-b 1).
#define NNS_WGMMA_RS(TY)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " NNS_ACC32_STR \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
               : NNS_ACC32_OPS(d)                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kHalf) {
    NNS_WGMMA_RS("f16");
  } else {
    NNS_WGMMA_RS("bf16");
  }
}

// (x, y) → packed 16-bit hi pair and the lo pair of the residuals.
template <bool kHalf>
__device__ __forceinline__ void split16(float x, float y, uint32_t& hi, uint32_t& lo) {
  if constexpr (kHalf) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    const __half2 r = __floats2half2_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
}

template <bool kHalf, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    flash_attention16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                             const uint16_t* __restrict__ v, float* __restrict__ out, int T_len,
                             int H, int D, Strides qs, Strides ks, Strides vs, float scale,
                             int causal) {
  constexpr uint32_t kTileB = tile16_bytes<DP>();
  constexpr int kChunksN = DP / 64;  // P·V products of 64 output columns
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms 1024-aligned

  const int n_q = (T_len + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const uint16_t* qh = q + b * qs.b + h * qs.h;
  const uint16_t* kh = k + b * ks.b + h * ks.h;
  const uint16_t* vh = v + b * vs.b + h * vs.h;
  const int n_kt = live_key_tiles(q0, T_len, causal, kBK16);

  // group 0: Q and key tile 0; group 1: key tile 1 (or nothing)
  load_tile16<DP>(sq, qh, qs.t, q0, T_len, D);
  load_tile16<DP>(sq + kTileB, kh, ks.t, 0, T_len, D);
  load_tile16<DP>(sq + 2 * kTileB, vh, vs.t, 0, T_len, D);
  cp_async_commit();
  if (n_kt > 1) {
    load_tile16<DP>(sq + 3 * kTileB, kh, ks.t, kBK16, T_len, D);
    load_tile16<DP>(sq + 4 * kTileB, vh, vs.t, kBK16, T_len, D);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_a = q0 + warp * 16 + lane / 4;
  float m[2], l[2];
  online_softmax_init(m[0], l[0]);
  online_softmax_init(m[1], l[1]);
  float o[kChunksN][32];
#pragma unroll
  for (int j = 0; j < kChunksN; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[j][r] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t sk = sq + (1 + 2 * (kt & 1)) * kTileB;
    const uint32_t sv = sk + kTileB;
    cp_async_wait1();  // this thread's copies of tile kt have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();

    float s[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks16 = 0; ks16 < DP / 16; ++ks16) {
      const uint32_t off = (ks16 / 4) * (kBQ * 128) + (ks16 % 4) * 32;
      wgmma_ss<kHalf>(s, sw128_desc(sq + off), sw128_desc(sk + off));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    const int k0 = kt * kBK16;
    const bool masked = k0 + kBK16 > T_len || (causal && k0 + kBK16 - 1 > q0);
    float alpha[2];
    softmax_tile<32>(s, m, l, alpha, row_a, T_len, causal, masked, scale,
                     [&](int r) { return k0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1); });

    uint32_t p_hi[4][4], p_lo[4][4];  // A fragments of the four k16 steps over the keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split16<kHalf>(s[8 * kk + 2 * i] * kPScale, s[8 * kk + 2 * i + 1] * kPScale,
                       p_hi[kk][i], p_lo[kk][i]);
#pragma unroll
    for (int j = 0; j < kChunksN; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) o[j][r] *= alpha[(r >> 1) & 1];

#pragma unroll
    for (int j = 0; j < kChunksN; ++j) fence_regs(o[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kChunksN; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(sv + j * (kBK16 * 128) + kk * 2048);
        wgmma_rs<kHalf>(o[j], p_hi[kk], dv);
        wgmma_rs<kHalf>(o[j], p_lo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < kChunksN; ++j) fence_regs(o[j]);

    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < n_kt) {
      load_tile16<DP>(sk, kh, ks.t, (kt + 2) * kBK16, T_len, D);
      load_tile16<DP>(sv, vh, vs.t, (kt + 2) * kBK16, T_len, D);
    }
    cp_async_commit();  // possibly empty: one group an iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= T_len) continue;
    float* orow = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kChunksN; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 64 * j + 8 * n + 2 * (lane & 3);
        if (col < D) {
          const float x = online_softmax_finalize(l[i], o[j][4 * n + 2 * i] * (1.0f / kPScale));
          const float y =
              online_softmax_finalize(l[i], o[j][4 * n + 2 * i + 1] * (1.0f / kPScale));
          *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// The float32 route: 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

template <int DP>
__host__ __device__ constexpr size_t smem32_bytes() {
  return sizeof(float) * (DP + 4) * (kBQ + 4 * kBK32);  // Q, 2 x (K, V)
}

// Rows r0 .. r0+rows-1 of one head into dst [rows][DP + 4] floats.
template <int DP, int kRows>
__device__ __forceinline__ void load_tile32(float* dst, const float* __restrict__ base,
                                            int64_t row_stride, int r0, int T_len, int D) {
  constexpr int kChunks = DP / 4;
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = it * kThreads + static_cast<int>(threadIdx.x);
    const int row = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r0 + row < T_len && c * 4 < D;
    const float* src = valid ? base + (r0 + row) * row_stride + c * 4 : base;
    cp_async16(smem_u32(dst + row * (DP + 4) + c * 4), src, valid);
  }
}

// x = hi + lo: hi is x rounded to TF32's 10 mantissa bits (half up, in
// integer arithmetic: cheaper than cvt.rna.tf32, and finite inputs only),
// lo = x - hi exactly, whose low 13 bits the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a · b in 3xTF32: the two cross terms first, then hi · hi.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(c, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma_tf32(c, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    flash_attention32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ out, int T_len,
                             int H, int D, Strides qs, Strides ks, Strides vs, float scale,
                             int causal) {
  constexpr int kLd = DP + 4;
  constexpr int kNB = kBK32 / 8;  // 8-key slices a tile
  constexpr int kND = DP / 8;     // 8-column slices of the output
  extern __shared__ __align__(16) float smem32[];
  float* sq = smem32;                  // [kBQ][kLd]
  float* skv = sq + kBQ * kLd;         // stage s: K at skv + 2s * kBK32 * kLd, then V

  const int n_q = (T_len + kBQ - 1) / kBQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  const int n_kt = live_key_tiles(q0, T_len, causal, kBK32);

  load_tile32<DP, kBQ>(sq, qh, qs.t, q0, T_len, D);
  load_tile32<DP, kBK32>(skv, kh, ks.t, 0, T_len, D);
  load_tile32<DP, kBK32>(skv + kBK32 * kLd, vh, vs.t, 0, T_len, D);
  cp_async_commit();
  if (n_kt > 1) {
    load_tile32<DP, kBK32>(skv + 2 * kBK32 * kLd, kh, ks.t, kBK32, T_len, D);
    load_tile32<DP, kBK32>(skv + 3 * kBK32 * kLd, vh, vs.t, kBK32, T_len, D);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_a = q0 + warp * 16 + g;
  const float* qa = sq + (warp * 16 + g) * kLd + 2 * t;  // this thread's Q fragment base
  float m[2], l[2];
  online_softmax_init(m[0], l[0]);
  online_softmax_init(m[1], l[1]);
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    float* sk = skv + 2 * (kt & 1) * kBK32 * kLd;
    float* sv = sk + kBK32 * kLd;
    cp_async_wait1();
    __syncthreads();

    // S = Q · Kᵀ: s[4nb .. 4nb+3] is the C fragment of keys 8nb .. 8nb+7.
    // Within each 8-column step, k t ↔ d 2t and k t+4 ↔ d 2t+1 (a sum over
    // d in any order), so each fragment pair is one 8-byte load.
    float s[4 * kNB];
#pragma unroll
    for (int r = 0; r < 4 * kNB; ++r) s[r] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < DP / 8; ++kd) {
      uint32_t ah[4], al[4];
      const float2 qg = *reinterpret_cast<const float2*>(qa + 8 * kd);
      const float2 qg8 = *reinterpret_cast<const float2*>(qa + 8 * kd + 8 * kLd);
      split_tf32(qg.x, ah[0], al[0]);
      split_tf32(qg8.x, ah[1], al[1]);
      split_tf32(qg.y, ah[2], al[2]);
      split_tf32(qg8.y, ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float2 kb =
            *reinterpret_cast<const float2*>(sk + (8 * nb + g) * kLd + 8 * kd + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kb.x, bh0, bl0);
        split_tf32(kb.y, bh1, bl1);
        mma_3xtf32(&s[4 * nb], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    const int k0 = kt * kBK32;
    const bool masked = k0 + kBK32 > T_len || (causal && k0 + kBK32 - 1 > q0);
    float alpha[2];
    softmax_tile<4 * kNB>(s, m, l, alpha, row_a, T_len, causal, masked, scale,
                          [&](int r) { return k0 + 8 * (r >> 2) + 2 * t + (r & 1); });
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[n][r] *= alpha[(r >> 1) & 1];

    // O += P · V over each 8-key slice, keys relabelled 2t → t, 2t+1 → t+4:
    // the A fragment (rows g, g+8; k t, t+4) is then (c0, c2, c1, c3)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      uint32_t ah[4], al[4];
      split_tf32(s[4 * nb], ah[0], al[0]);
      split_tf32(s[4 * nb + 2], ah[1], al[1]);
      split_tf32(s[4 * nb + 1], ah[2], al[2]);
      split_tf32(s[4 * nb + 3], ah[3], al[3]);
      const float* vb = sv + (8 * nb + 2 * t) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < kND; ++nd) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vb[8 * nd], bh0, bl0);
        split_tf32(vb[8 * nd + kLd], bh1, bl1);
        mma_3xtf32(o[nd], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (kt + 2 < n_kt) {
      load_tile32<DP, kBK32>(sk, kh, ks.t, (kt + 2) * kBK32, T_len, D);
      load_tile32<DP, kBK32>(sv, vh, vs.t, (kt + 2) * kBK32, T_len, D);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= T_len) continue;
    float* orow = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(online_softmax_finalize(l[i], o[nd][2 * i]),
                        online_softmax_finalize(l[i], o[nd][2 * i + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

struct Instance {
  const void* fn;  // the __global__ function
  size_t smem;
};

template <int DP>
Instance instance_dp(int dtype) {
  switch (dtype) {
    case kF32:
      return {reinterpret_cast<const void*>(flash_attention32_kernel<DP>), smem32_bytes<DP>()};
    case kBF16:
      return {reinterpret_cast<const void*>(flash_attention16_kernel<false, DP>),
              smem16_bytes<DP>()};
    case kF16:
      return {reinterpret_cast<const void*>(flash_attention16_kernel<true, DP>),
              smem16_bytes<DP>()};
    default:
      return {nullptr, 0};
  }
}

// A block a (64 query rows, head, batch row).
dim3 flash_grid(int B, int T, int H) { return dim3((T + kBQ - 1) / kBQ, H, B); }

// The kernel for (dtype, D): D % 8 == 0 and 8 <= D <= 256, on the padded
// width 64, 128 or 256; {nullptr, 0} otherwise.
Instance instance(int dtype, int D) {
  if (D < 8 || D > 256 || D % 8) return {nullptr, 0};
  if (D <= 64) return instance_dp<64>(dtype);
  if (D <= 128) return instance_dp<128>(dtype);
  return instance_dp<256>(dtype);
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v: [B, T, H, D] of dtype
// 0 = float32, 1 = bfloat16 or 2 = float16, D contiguous, the other axes at
// the given element strides (each a multiple of 16 bytes, the pointers
// 16-byte aligned: cp.async's rule); out: [B, T, H, D] float32, contiguous.
// D % 8 == 0, 8 <= D <= 256. Returns the cudaError_t of the launch; 0 means
// it was queued on `stream`.
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v, int dtype,
                                   float* out, int B, int T, int H, int D,
                                   const long long* strides, float scale, int causal,
                                   void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  const Instance in = instance(dtype, D);
  if (in.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(in.smem));
  if (err != cudaSuccess) return err;
  Strides qs{strides[0], strides[1], strides[2]};
  Strides ks{strides[3], strides[4], strides[5]};
  Strides vs{strides[6], strides[7], strides[8]};
  int causal_i = causal;
  void* args[] = {&q, &k, &v, &out, &T, &H, &D, &qs, &ks, &vs, &scale, &causal_i};
  err = cudaLaunchKernel(in.fn, flash_grid(B, T, H), dim3(kThreads), args, in.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch nns_flash_attention makes for (dtype, B, T, H, D), described
// into info[0 .. nns_launch::kFields) (launch_info.cuh); nothing launches.
extern "C" int nns_flash_attention_launch_info(int dtype, int B, int T, int H, int D,
                                               long long* info) {
  if (B <= 0 || B > 65535 || T <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  const Instance in = instance(dtype, D);
  if (in.fn == nullptr) return cudaErrorInvalidValue;
  return nns_launch::describe(in.fn, flash_grid(B, T, H), dim3(kThreads), in.smem, in.smem,
                              info);
}
