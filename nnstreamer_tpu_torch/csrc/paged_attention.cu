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
// card's rate, so the tensor cores are not used: the memory is the limit.
// The chunks' partial states (H * (D + 2) floats a live chunk, written and
// read once) are the design's overhead, outside the bound.
//
// Design (redesigned for Hopper, as the slot kernel K3 is; the history loop
// is attn_tile.cuh's and its note gives the details).
// - Split: grid (KV * head groups, B, splits), one block a chunk of
//   `chunk` (128) history rows, splits = ceil(nb * bs / chunk) from the
//   table's shape (split_plan in ops/kernels/decode_attention.py); hist is
//   read from pos on the device (no host sync) and a block whose chunk
//   starts at or past it returns at once. The partial (m, l, acc) of each
//   live chunk goes to a float32 workspace [B, H, splits, D + 2].
// - Indices: a block reads the table entries of its chunk's live rows
//   once, into shared memory (the TPU prefetched the table as a scalar
//   operand), and addresses each row through them: history row r is row
//   r % bs of arena block tables[b, r / bs], rows of one arena block
//   contiguous at stride KV * D. Entries at or past ceil(hist / bs) are
//   never read, nor are their arena blocks (they point at scratch block 0).
//   Tiles are of rows, not of arena blocks, so any bs works.
// - Heads: one block serves all g = H / KV query heads of its kv head (up
//   to 8; larger groups take several blocks), so every live row leaves
//   device memory once.
// - Combine and the pending token: paged_attention_combine_kernel, one
//   block a (query head, slot), merges the live chunks' partials
//   (online_softmax_merge), then folds the pending token's fresh_k /
//   fresh_v (position pos, always live) through the same online-softmax
//   update, after every history position, then the l == 0 guard of the
//   finalize. With no history (pos 0) it is the fresh column alone.
// - Resources a block of 128 threads at the main shape (D 128, g 4; the
//   same nvcc -Xptxas -v report as K3's; shared memory from
//   chunk_smem_bytes plus the chunk's table entries): float32 124
//   registers, 66,064 B, 3 blocks an SM; bf16 106, 33,296 B, 4 blocks;
//   int8 127, 17,424 B, 4 blocks. No instance spills; the combine uses 96.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attn_tile.cuh"
#include "launch_info.cuh"

using namespace nns_attn;

namespace {

struct Args {
  const void* q;
  int q_bf16;
  const void* ak;
  const void* av;
  const float* ks;
  const float* vs;
  const int* tables;
  const int* pos;
  const void* fk;
  const void* fv;
  int fresh_bf16;
  float* ws;
  float* out;
  int B, nb, bs, H, KV, D, chunk, splits;
  float scale;
};

// History rows 0 .. hist-1 live in arena blocks, clamped to the table's
// reach so a stale lane never walks past it.
__device__ __forceinline__ int history_rows(int p, int nb, int bs) {
  return p <= 0 ? 0 : min(p, nb * bs);
}

// Bytes past the chunk's shared memory for its table entries: at most
// chunk / bs + 2 of them, so chunk + 2 covers every bs.
__host__ __device__ constexpr size_t table_bytes(int chunk) {
  return sizeof(int) * (static_cast<size_t>(chunk) + 4);
}

// One block: chunk blockIdx.z of slot blockIdx.y's history, for the query
// heads of head group blockIdx.x % n_groups of kv head blockIdx.x / n_groups.
template <typename CT, bool kQuant, int DP, int GH>
__global__ void __launch_bounds__(kThreads) paged_attention_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = a.H / a.KV;
  const int n_groups = (g + GH - 1) / GH;
  const int kh = blockIdx.x / n_groups;
  const int hg = blockIdx.x % n_groups;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int hist = history_rows(a.pos[b], a.nb, a.bs);
  const int c0 = sp * a.chunk;
  if (c0 >= hist) return;  // an empty chunk: the combine reads chunks below hist only

  // the table entries of this chunk's live rows, read once; entries past
  // the history are never read
  const int bs = a.bs;
  const int e0 = c0 / bs;
  const int n_entries = (min(c0 + a.chunk, hist) - 1) / bs - e0 + 1;
  int* tab_s = reinterpret_cast<int*>(smem + chunk_smem_bytes<CT, kQuant, DP, GH>());
  const int* tab = a.tables + static_cast<size_t>(b) * a.nb + e0;
  for (int i = threadIdx.x; i < n_entries; i += kThreads) tab_s[i] = __ldg(tab + i);
  __syncthreads();

  const int h0 = kh * g + hg * GH;
  const int KV = a.KV;
  attend_chunk<CT, kQuant, DP, GH>(
      a.q, a.q_bf16, static_cast<size_t>(b) * a.H + h0, min(GH, g - hg * GH),
      static_cast<const CT*>(a.ak), static_cast<const CT*>(a.av), a.ks, a.vs,
      [=](int r) {
        const int lb = r / bs;
        return (static_cast<size_t>(tab_s[lb - e0]) * bs + (r - lb * bs)) * KV + kh;
      },
      c0, a.chunk, hist, a.D, a.scale, a.ws,
      (static_cast<size_t>(b) * a.H + h0) * a.splits + sp, a.splits, smem);
}

// One block a (query head blockIdx.x, slot blockIdx.y): merge the live
// chunks' partials, fold the pending token's column (position pos, always
// live) after them, then the l == 0 guard of the finalize.
__global__ void __launch_bounds__(kCombineThreads) paged_attention_combine_kernel(const Args a) {
  __shared__ float warp_dots[kCombineThreads / 32];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kh = h / (a.H / a.KV);
  const int n_live = (history_rows(a.pos[b], a.nb, a.bs) + a.chunk - 1) / a.chunk;
  const size_t row = static_cast<size_t>(b) * a.H + h;
  const size_t frow = (static_cast<size_t>(b) * a.KV + kh) * a.D;

  float dot = 0.0f;
  for (int d = threadIdx.x; d < a.D; d += kCombineThreads)
    dot = fmaf(f32_or_bf16(a.q, a.q_bf16, row * a.D + d),
               f32_or_bf16(a.fk, a.fresh_bf16, frow + d), dot);
  dot = warp_sum(dot);
  if ((threadIdx.x & 31) == 0) warp_dots[threadIdx.x >> 5] = dot;
  __syncthreads();
  dot = 0.0f;
#pragma unroll
  for (int w = 0; w < kCombineThreads / 32; ++w) dot += warp_dots[w];
  const float s1 = scaled(dot, a.scale);

  float m, l, acc[kMaxD / kCombineThreads];
  combine_chunks(a.ws + row * a.splits * (a.D + 2), n_live, a.D, m, l, acc);
  const float m_new = fmaxf(m, s1);
  const float alpha = online_softmax_alpha(m, m_new);
  const float p1 = online_softmax_weight(s1, m_new);
#pragma unroll
  for (int k = 0; k < kMaxD / kCombineThreads; ++k) {
    const int d = threadIdx.x + k * kCombineThreads;
    if (d < a.D)
      a.out[row * a.D + d] = online_softmax_finalize(
          l * alpha + p1, fmaf(p1, f32_or_bf16(a.fv, a.fresh_bf16, frow + d), acc[k] * alpha));
  }
}

// With a non-null `info`: describe the split kernel's and the combine's
// launches (launch_info.cuh) and launch nothing.
template <typename CT, bool kQuant, int DP, int GH>
int launch(const Args& a, cudaStream_t stream, long long* info) {
  auto kernel = paged_attention_split_kernel<CT, kQuant, DP, GH>;
  constexpr size_t smem_max = chunk_smem_bytes<CT, kQuant, DP, GH>() + table_bytes(kMaxChunk);
  // the attribute is per device: set once for each
  static std::atomic<unsigned> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_max));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const size_t smem = chunk_smem_bytes<CT, kQuant, DP, GH>() + table_bytes(a.chunk);
  const int g = a.H / a.KV;
  const dim3 grid(a.KV * ((g + GH - 1) / GH), a.B, a.splits);
  if (info != nullptr) {
    err = nns_launch::describe(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), smem,
                               smem_max, info);
    if (err != cudaSuccess) return err;
    return nns_launch::describe(reinterpret_cast<const void*>(paged_attention_combine_kernel),
                                dim3(a.H, a.B), dim3(kCombineThreads), 0, 0,
                                info + nns_launch::kFields);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_combine_kernel<<<dim3(a.H, a.B), kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename CT, bool kQuant, int DP>
int launch_group(const Args& a, cudaStream_t stream, long long* info) {
  switch (heads_per_block(a.H / a.KV)) {
    case 1:
      return launch<CT, kQuant, DP, 1>(a, stream, info);
    case 2:
      return launch<CT, kQuant, DP, 2>(a, stream, info);
    case 4:
      return launch<CT, kQuant, DP, 4>(a, stream, info);
    default:
      return launch<CT, kQuant, DP, 8>(a, stream, info);
  }
}

template <typename CT, bool kQuant>
int launch_dim(const Args& a, cudaStream_t stream, long long* info) {
  if (a.D <= 64) return launch_group<CT, kQuant, 64>(a, stream, info);
  if (a.D <= 128) return launch_group<CT, kQuant, 128>(a, stream, info);
  return launch_group<CT, kQuant, 256>(a, stream, info);
}

}  // namespace

// The instantiation for the arena dtype, padded D and heads a block,
// launched, or with `info` described (launch_info.cuh).
static int paged_dispatch(const Args& a, int arena_dtype, cudaStream_t s, long long* info) {
  switch (arena_dtype) {
    case kF32:
      return launch_dim<float, false>(a, s, info);
    case kBF16:
      return launch_dim<__nv_bfloat16, false>(a, s, info);
    case kI8:
      return launch_dim<int8_t, true>(a, s, info);
    default:
      return cudaErrorInvalidValue;
  }
}

static bool shape_ok(int B, int nb, int bs, int H, int KV, int D, int chunk, int splits) {
  if (B <= 0 || B > 65535 || nb <= 0 || bs <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || H > 65535 || D <= 0 || D > kMaxD || D % 4 != 0)
    return false;
  if (nb > (1 << 30) / bs) return false;  // nb * bs must fit an int
  return !(chunk <= 0 || chunk > kMaxChunk || chunk % kChunkAlign != 0 || splits <= 0 ||
           splits > 65535 ||
           static_cast<long long>(splits) * chunk < static_cast<long long>(nb) * bs);
}

// Plain C entry point (bound with ctypes). q: [B, 1, H, D] (q_dtype 0 = f32,
// 1 = bf16); ak, av: one layer's arena [N, bs, KV, D] contiguous
// (arena_dtype 0 = f32, 1 = bf16, 2 = int8 with ks, vs [N, bs, KV] float32,
// else ks = vs = NULL); tables: [B, nb] int32 block ids, every entry below
// ceil(min(pos[b], nb * bs) / bs) in 0 .. N-1 (the caller's contract, not
// checked here); pos: [B] int32 history lengths; fk, fv: [B, 1, KV, D] the
// pending token's K/V (fresh_dtype 0 = f32, 1 = bf16); ws: float32
// workspace [B, H, splits, D + 2]; out: [B, 1, H, D] float32. History rows
// are split in chunks of `chunk` rows (a multiple of 32, at most 1024),
// splits * chunk >= nb * bs. Needs H % KV == 0, H / KV <= 32, D % 4 == 0,
// D <= 256, 16-byte aligned arenas. Queues the split kernel and its
// combine on `stream`; returns the first cudaError_t, 0 when both are
// queued.
extern "C" int nns_paged_attention(const void* q, int q_dtype, const void* ak, const void* av,
                                   int arena_dtype, const float* ks, const float* vs,
                                   const int* tables, const int* pos, const void* fk,
                                   const void* fv, int fresh_dtype, float* out, float* ws, int B,
                                   int nb, int bs, int H, int KV, int D, int chunk, int splits,
                                   float scale, void* stream) {
  if (!shape_ok(B, nb, bs, H, KV, D, chunk, splits) || ws == nullptr)
    return cudaErrorInvalidValue;
  if ((arena_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  if (fresh_dtype != kF32 && fresh_dtype != kBF16) return cudaErrorInvalidValue;
  const Args a{q, q_dtype == kBF16, ak, av, ks, vs, tables, pos, fk, fv, fresh_dtype == kBF16,
               ws, out, B, nb, bs, H, KV, D, chunk, splits, scale};
  return paged_dispatch(a, arena_dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// The two launches nns_paged_attention makes for these dtypes and shapes,
// described into info[0 .. 2 * nns_launch::kFields): the split kernel, then
// the combine. Nothing launches.
extern "C" int nns_paged_attention_launch_info(int q_dtype, int arena_dtype, int B, int nb, int bs,
                                               int H, int KV, int D, int chunk, int splits,
                                               long long* info) {
  if (!shape_ok(B, nb, bs, H, KV, D, chunk, splits)) return cudaErrorInvalidValue;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  const Args a{nullptr, q_dtype == kBF16, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 0, nullptr, nullptr, B, nb, bs, H, KV, D, chunk, splits, 1.0f};
  return paged_dispatch(a, arena_dtype, nullptr, info);
}
