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
// The operations (4 * D per live row and query head, two per byte in
// float32 at g = 4) sit far below the card's rate, so the tensor cores are
// not used: the memory is the limit. The partial states the split leaves
// (H * (D + 2) floats a live chunk, written once and read once by the
// combine: 3.2 % of a full 128-row chunk's float32 bytes at g 4, D 128)
// are the design's overhead, outside the bound.
//
// Design (redesigned for Hopper; the history loop is attn_tile.cuh's,
// shared with the paged kernel K4, and its note gives the details).
// - Split: grid (KV * head groups, B, splits), one block a chunk of
//   `chunk` (128) history rows of one (kv head, slot), so pos 600 at B 8,
//   KV 8 runs 320 blocks on the 132 SMs, and a slot at pos 4095 is 32
//   blocks, not one serial walk. The split count, ceil(S / chunk), comes
//   from the cache's shape (split_plan in ops/kernels/decode_attention.py);
//   live = min(pos + 1, S) is read on the device (no host sync), and a
//   block whose chunk starts at or past it returns at once. The TPU grid
//   (b, h, k-blocks) carried the running state along its sequential key
//   axis; here the chunks' partial (m, l, acc) go to a float32 workspace
//   the wrapper allocates, [B, H, splits, D + 2].
// - Heads: one block serves all g = H / KV query heads of its kv head (up
//   to 8; larger groups take several blocks), so every live row leaves
//   device memory once, where the TPU's index map hi // group re-read each
//   K/V block once a query head.
// - Combine: decode_attention_combine_kernel, one block a (query head,
//   slot), merges the ceil(live / chunk) live partials (online_softmax_merge
//   of attn_primitives.cuh: every chunk rescaled to the largest max), then
//   the l == 0 guard of the finalize. Both kernels are queued by one C call
//   on the caller's stream.
// - Resources a block of 128 threads at the main shape (D 128, g 4;
//   registers and spills from nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -Xptxas -v, CUDA 12.8; shared memory from chunk_smem_bytes; blocks
//   an SM from both against 65,536 registers and 228 KB): float32 130
//   registers, 65,536 B (a 4-stage ring of 16-row tiles), 3 blocks; bf16
//   128, 32,768 B, 4 blocks; int8 127, 16,896 B, 4 blocks. No instance
//   spills (the largest, 8 heads a block, uses 222-254 registers); the
//   combine uses 95.

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
  const void* ck;
  const void* cv;
  const float* ks;
  const float* vs;
  const int* pos;
  float* ws;
  float* out;
  int B, S, H, KV, D, chunk, splits;
  float scale;
};

// Positions 0 .. pos are attendable; a wrapped ring passes absolute pos, so
// clamp to the cache length.
__device__ __forceinline__ int live_rows(int p, int S) { return p < 0 ? 0 : (p < S ? p + 1 : S); }

// One block: chunk blockIdx.z of slot blockIdx.y's history, for the query
// heads of head group blockIdx.x % n_groups of kv head blockIdx.x / n_groups.
template <typename CT, bool kQuant, int DP, int GH>
__global__ void __launch_bounds__(kThreads) decode_attention_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = a.H / a.KV;
  const int n_groups = (g + GH - 1) / GH;
  const int kh = blockIdx.x / n_groups;
  const int hg = blockIdx.x % n_groups;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int live = live_rows(a.pos[b], a.S);
  const int c0 = sp * a.chunk;
  if (c0 >= live) return;  // an empty chunk: the combine reads chunks below live only
  const int h0 = kh * g + hg * GH;
  const size_t slot_row = static_cast<size_t>(b) * a.S;
  const int KV = a.KV;
  attend_chunk<CT, kQuant, DP, GH>(
      a.q, a.q_bf16, static_cast<size_t>(b) * a.H + h0, min(GH, g - hg * GH),
      static_cast<const CT*>(a.ck), static_cast<const CT*>(a.cv), a.ks, a.vs,
      [=](int r) { return (slot_row + r) * KV + kh; }, c0, a.chunk, live, a.D, a.scale, a.ws,
      (static_cast<size_t>(b) * a.H + h0) * a.splits + sp, a.splits, smem);
}

// One block a (query head blockIdx.x, slot blockIdx.y): merge the live
// chunks' partials, then the l == 0 guard of the finalize.
__global__ void __launch_bounds__(kCombineThreads) decode_attention_combine_kernel(const Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_live = (live_rows(a.pos[b], a.S) + a.chunk - 1) / a.chunk;
  const size_t row = static_cast<size_t>(b) * a.H + h;
  float m, l, acc[kMaxD / kCombineThreads];
  combine_chunks(a.ws + row * a.splits * (a.D + 2), n_live, a.D, m, l, acc);
#pragma unroll
  for (int k = 0; k < kMaxD / kCombineThreads; ++k) {
    const int d = threadIdx.x + k * kCombineThreads;
    if (d < a.D) a.out[row * a.D + d] = online_softmax_finalize(l, acc[k]);
  }
}

// With a non-null `info`: describe the split kernel's and the combine's
// launches (launch_info.cuh) and launch nothing.
template <typename CT, bool kQuant, int DP, int GH>
int launch(const Args& a, cudaStream_t stream, long long* info) {
  auto kernel = decode_attention_split_kernel<CT, kQuant, DP, GH>;
  constexpr size_t smem = chunk_smem_bytes<CT, kQuant, DP, GH>();
  // the attribute is per device: set once for each
  static std::atomic<unsigned> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const int g = a.H / a.KV;
  const dim3 grid(a.KV * ((g + GH - 1) / GH), a.B, a.splits);
  if (info != nullptr) {
    err = nns_launch::describe(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), smem,
                               smem, info);
    if (err != cudaSuccess) return err;
    return nns_launch::describe(reinterpret_cast<const void*>(decode_attention_combine_kernel),
                                dim3(a.H, a.B), dim3(kCombineThreads), 0, 0,
                                info + nns_launch::kFields);
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_combine_kernel<<<dim3(a.H, a.B), kCombineThreads, 0, stream>>>(a);
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

// The instantiation for the cache dtype, padded D and heads a block,
// launched, or with `info` described (launch_info.cuh).
static int decode_dispatch(const Args& a, int cache_dtype, cudaStream_t s, long long* info) {
  switch (cache_dtype) {
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

static bool shape_ok(int B, int S, int H, int KV, int D, int chunk, int splits) {
  return !(B <= 0 || B > 65535 || S <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup ||
           H > 65535 || D <= 0 || D > kMaxD || D % 4 != 0 || chunk <= 0 || chunk > kMaxChunk ||
           chunk % kChunkAlign != 0 || splits <= 0 || splits > 65535 ||
           static_cast<long long>(splits) * chunk < S);
}

// Plain C entry point (bound with ctypes). q: [B, 1, H, D] (q_dtype 0 = f32,
// 1 = bf16); ck, cv: [B, S, KV, D] contiguous (cache_dtype 0 = f32, 1 = bf16,
// 2 = int8 with ks, vs [B, S, KV] float32, else ks = vs = NULL); pos: [B]
// int32; ws: float32 workspace [B, H, splits, D + 2]; out: [B, 1, H, D]
// float32. History rows are split in chunks of `chunk` rows (a multiple of
// 32, at most 1024), splits * chunk >= S. Needs H % KV == 0, H / KV <= 32,
// D % 4 == 0, D <= 256, 16-byte aligned caches. Queues the split kernel and
// its combine on `stream`; returns the first cudaError_t, 0 when both are
// queued.
extern "C" int nns_decode_attention(const void* q, int q_dtype, const void* ck, const void* cv,
                                    int cache_dtype, const float* ks, const float* vs,
                                    const int* pos, float* out, float* ws, int B, int S, int H,
                                    int KV, int D, int chunk, int splits, float scale,
                                    void* stream) {
  if (!shape_ok(B, S, H, KV, D, chunk, splits) || ws == nullptr) return cudaErrorInvalidValue;
  if ((cache_dtype == kI8) != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  const Args a{q, q_dtype == kBF16, ck, cv, ks, vs, pos, ws, out, B, S, H, KV, D, chunk, splits,
               scale};
  return decode_dispatch(a, cache_dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// The two launches nns_decode_attention makes for these dtypes and shapes,
// described into info[0 .. 2 * nns_launch::kFields): the split kernel, then
// the combine. Nothing launches.
extern "C" int nns_decode_attention_launch_info(int q_dtype, int cache_dtype, int B, int S, int H,
                                                int KV, int D, int chunk, int splits,
                                                long long* info) {
  if (!shape_ok(B, S, H, KV, D, chunk, splits)) return cudaErrorInvalidValue;
  if (q_dtype != kF32 && q_dtype != kBF16) return cudaErrorInvalidValue;
  const Args a{nullptr, q_dtype == kBF16, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, B, S, H, KV, D, chunk, splits, 1.0f};
  return decode_dispatch(a, cache_dtype, nullptr, info);
}
