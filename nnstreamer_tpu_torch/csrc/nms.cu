// Greedy class-agnostic non-maximum suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/nms.py (nms, body
// _nms_kernel, pallas_call at :119). Like it, this code computes only the
// suppression recurrence: the caller ranks the boxes by score beforehand and
// packs the top-k survivors afterwards (ops/detection.py nms). The ranked
// boxes [n, 4] (x1, y1, x2, y2) and scores [n] go in; the alive mask [n]
// (float 0/1) that _nms_kernel writes comes out, with m, the live prefix.
//
// Design: two kernels, a parallel IoU bitmask and a one-block scan over it.
// Both take a batch of R independent rows of n candidates (R = 1 for one
// frame; a window of B frames under torch.func.vmap is R = B, the op's vmap
// rule in ops/kernels/nms.py, as the reference vmaps its pallas_call): the
// mask kernel's grid is (tiles, R), the scan's (R), one block a row, and a
// row's arithmetic is the single-row launch's, so its alive mask is too.
//
// 1. nms_kernel_mask. The grid is the upper triangle of 64 x 64 tiles (row
//    block r, column block c >= r), ceil(n/64) * (ceil(n/64) + 1) / 2 blocks,
//    taken from n alone (no host read). A block stages its 64 column boxes
//    in shared memory and writes one 64-bit word a row: bit j of words[i][c]
//    is set iff j > i and IoU(i, 64c + j) > thr. Up to 1056 tiles (one wave
//    of 256-thread blocks, n <= 2880) four threads share a row, 16 columns
//    each, and OR their parts with two shuffles, which cuts a thread's chain
//    of dependent IoUs to 16; past that, one thread takes a row, the least
//    work for a grid of many waves. A row whose score is not > 0 writes
//    nothing (the scan never reads it), and a tile whose 64 rows are all
//    dead returns at once. A pair that does not overlap skips the division
//    (below). Tiles go out row by row, so the words of a row are written by
//    neighbouring blocks and fill whole sectors in L2.
// 2. nms_kernel_scan, one block of 512 threads. The "removed" bits of up to
//    kMaxN candidates live in shared memory (512 words, 4 KB), started from
//    score > 0; m is one past the last live candidate. For each word block
//    c < ceil(m/64), warp 0 resolves the block's 64 candidates serially in
//    registers from the diagonal words words[64c + t][c] (a candidate is
//    kept iff it is not removed; keeping it ORs its diagonal word in). Its
//    lane k then ORs word c+1+k of the kept rows into "removed", for the
//    first kPrefetch = 32 word blocks right of the diagonal, from shared
//    memory: while warp 0 works, warp 1 copies the next block's diagonal
//    words and warps 2..15 the first 32 words right of the diagonal of the
//    next block's live rows into the other of two stages with cp.async
//    (16.5 KB a stage). One barrier ends the word block. While m <= 2112 (33
//    word blocks) that is all; past it, a second barrier hands the kept bits
//    to every thread, and the words beyond the 32 come from device memory:
//    the kept rows are split in up to 8 row groups, one thread a (group,
//    word), eight loads in flight, the groups meeting in 32-bit shared
//    atomics. The greedy's m
//    dependent steps become ceil(m/64) rounds: 30 at n = 1917, 354 at
//    25 200 (m = 22 617 there).
//
// Workspace: words [R, n, ceil(n/64)] of 64-bit words, allocated by the wrapper
// (torch.empty, never cleared): 0.46 MB at n = 1917, 79.4 MB at 25 200, 134
// MB at kMaxN = 32768. The scan reads only words that the mask kernel wrote
// in the same call: the diagonal words of live rows and the words right of
// the diagonal of kept rows.
//
// Numerics. The IoU is the reference's, in its order and argument order:
// area = max(x2-x1, 0) * max(y2-y1, 0), iw, ih, inter = iw * ih,
// union = area + barea - inter, iou = union > 0 ? inter / union : 0, each
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn), so nvcc
// neither contracts union into an FMA nor approximates the division. A pair
// with inter == 0 (most pairs of a large frame) skips union and the
// division: its IoU is +-0 either way. thr is a float32, as the TPU kernel
// compares against float32 rows. The greedy over
// the bits keeps exactly the candidates the row-by-row recurrence keeps, so
// the mask equals the plain PyTorch version's (ops/kernels/nms.py
// plain_nms_mask) bit for bit; plain_nms_bitmask there is this design's
// plain twin, words included.
//
// Bound. Bytes: n * 20 in (boxes and scores) + n * 4 out. Operations: about
// 12 per IoU column over the columns that the greedy recurrence visits on
// these inputs. At n = 1917 both give under a microsecond. The bitmask does
// more IoUs than that (every live row against every later column, n^2 / 2 at
// most), in parallel over the SMs. What bounds this design on the card is
// the scan's chain of ceil(m/64) rounds on one SM: a resolve of 64 dependent
// steps, the ORs, a barrier; past m = 2112 also a round of loads of the
// kept rows' far words (from L2, or from device memory once the workspace
// passes L2's 50 MB, as at 25 200). PERF.md gives the times per round.
//
// Compiled for sm_90a, nvcc -Xptxas -v on the H100 reports: the scan 53
// registers and 46 084 bytes of static shared memory, the mask kernel 25
// (one thread a row) or 28 registers (four) and 1 280 bytes; no spills.
//
// No PyTorch call computes greedy NMS (torchvision's nms is a separate
// package), so there is no library time to compare with.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_info.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kMaxN = 32768;
constexpr int kMaxWords = kMaxN / 64;  // 512
constexpr int kTile = 64;              // candidates a word, rows and columns a tile
constexpr int kMaskWave = 132 * 8;     // tiles of four threads a row that one wave holds
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kInFlight = 8;           // word loads a thread has in flight
constexpr int kPrefetch = 32;          // words right of the diagonal a live row stages

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU(column box c of area ca, row box b of area ba) > thr. Boxes that do
// not overlap (inter == +-0) have IoU +-0 whatever the union, so their
// answer is `zero_hit` (0 > thr) and they skip the union and the division.
__device__ __forceinline__ bool suppresses(float4 c, float ca, float4 b, float ba, float thr,
                                           bool zero_hit) {
  float iw = fmaxf(__fsub_rn(fminf(c.z, b.z), fmaxf(c.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(c.w, b.w), fmaxf(c.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return zero_hit;
  float uni = __fsub_rn(__fadd_rn(ca, ba), inter);
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thr;
}

template <int kParts>
__global__ void __launch_bounds__(kParts* kTile)
    nms_kernel_mask(const float4* __restrict__ boxes, const float* __restrict__ scores,
                    u64* __restrict__ words, int n, int nw, float thr) {
  // blockIdx.y -> the row of the batch: its boxes, scores and words
  boxes += static_cast<size_t>(blockIdx.y) * n;
  scores += static_cast<size_t>(blockIdx.y) * n;
  words += static_cast<size_t>(blockIdx.y) * n * nw;
  // blockIdx.x -> tile (r, c), c >= r, row by row: counted from the end, the
  // rows hold 1, 2, ..., nw tiles, so row u from the bottom starts at u(u+1)/2
  const int k = nw * (nw + 1) / 2 - 1 - static_cast<int>(blockIdx.x);
  int u = static_cast<int>((sqrtf(8.0f * k + 1.0f) - 1.0f) * 0.5f);
  while ((u + 1) * (u + 2) / 2 <= k) ++u;
  while (u * (u + 1) / 2 > k) --u;
  const int r = nw - 1 - u;
  const int c = nw - 1 - (k - u * (u + 1) / 2);

  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  // thread (row t, part q): columns q * kCols .. q * kCols + kCols - 1 of row i
  constexpr int kCols = kTile / kParts;
  const int t = threadIdx.x / kParts;
  const int q = threadIdx.x % kParts;
  const int i = r * kTile + t;
  const int j0 = c * kTile;
  const int jn = min(kTile, n - j0);
  const bool live = i < n && scores[i] > 0.0f;
  const float4 b = boxes[min(i, n - 1)];
  if (threadIdx.x < jn) {
    const float4 cb = boxes[j0 + threadIdx.x];
    cbox[threadIdx.x] = cb;
    carea[threadIdx.x] = box_area(cb);
  }
  if (!__syncthreads_or(live)) return;  // no live row: the scan reads none of these words

  const float ba = box_area(b);
  const int first = c == r ? t + 1 : 0;  // bit j only for j > i
  const bool zero_hit = 0.0f > thr;
  u64 part = 0;  // bits q * kCols .. q * kCols + kCols - 1 of the row's word
#pragma unroll
  for (int jj = 0; jj < kCols; ++jj) {
    const int j = kCols * q + jj;
    if (live && j >= first && j < jn && suppresses(cbox[j], carea[j], b, ba, thr, zero_hit))
      part |= 1ull << jj;
  }
  u64 word = part << (kCols * q);
  // the parts of a row are neighbouring lanes
#pragma unroll
  for (int lanes = 1; lanes < kParts; lanes *= 2) word |= __shfl_xor_sync(~0u, word, lanes);
  if (live && q == 0) words[static_cast<size_t>(i) * nw + c] = word;  // dead rows write nothing
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
               "n"(kBytes), "r"(valid ? kBytes : 0));
}

struct ScanStage {
  unsigned lo[kTile], hi[kTile];  // the diagonal words, low and high halves
  u64 rows[kTile][kPrefetch];     // words c+1 .. c+kPrefetch of each live row
};

// Warp 1 copies word block c's diagonal words (zero for dead rows, whose words
// were never written); warps 2.. copy the first kPrefetch words right of the
// diagonal of its live rows, lane k taking word c+1+k. Warp 0, which resolves,
// copies nothing.
__device__ __forceinline__ void stage_block(ScanStage& st, const u64* words, u64 live, int c,
                                            int nb, int nw, int warp, int lane) {
  const u64* row0 = words + static_cast<size_t>(64 * c) * nw;
  if (warp == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      const bool v = (live >> t) & 1ull;
      const unsigned* src =
          reinterpret_cast<const unsigned*>(v ? row0 + static_cast<size_t>(t) * nw + c : words);
      cp_async<4>(st.lo + t, src, v);
      cp_async<4>(st.hi + t, src + 1, v);
    }
  } else if (warp > 1 && lane < min(kPrefetch, nb - c - 1)) {
    for (int t = warp - 2; t < kTile; t += kScanWarps - 2)
      if ((live >> t) & 1ull)
        cp_async<8>(&st.rows[t][lane], row0 + static_cast<size_t>(t) * nw + c + 1 + lane, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The greedy over one word block: candidate t is kept iff its bit in
// `removed` is clear when its turn comes; keeping it ORs its diagonal word in.
// Rows 0..31 decide on the low half (their words also carry bits 32..63);
// rows 32..63 have bits only in the high half. The words are in registers
// before the chain of decisions starts. Returns the kept bits.
__device__ __forceinline__ u64 resolve(u64 removed, const ScanStage& st) {
  unsigned lo = static_cast<unsigned>(removed);
  unsigned hi = static_cast<unsigned>(removed >> 32);
  unsigned a[32], b[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 x = reinterpret_cast<const uint4*>(st.lo)[q];
    const uint4 y = reinterpret_cast<const uint4*>(st.hi)[q];
    a[4 * q] = x.x; a[4 * q + 1] = x.y; a[4 * q + 2] = x.z; a[4 * q + 3] = x.w;
    b[4 * q] = y.x; b[4 * q + 1] = y.y; b[4 * q + 2] = y.z; b[4 * q + 3] = y.w;
  }
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (!((lo >> t) & 1u)) {
      lo |= a[t];
      hi |= b[t];
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 y = reinterpret_cast<const uint4*>(st.hi)[8 + q];
    b[4 * q] = y.x; b[4 * q + 1] = y.y; b[4 * q + 2] = y.z; b[4 * q + 3] = y.w;
  }
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    if (!((hi >> t) & 1u)) hi |= b[t];
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

__global__ void __launch_bounds__(kScanThreads, 1)
    nms_kernel_scan(const u64* __restrict__ words, const float* __restrict__ scores,
                    float* __restrict__ alive_out, int* __restrict__ live_out, int n, int nw) {
  // blockIdx.x -> the row of the batch
  words += static_cast<size_t>(blockIdx.x) * n * nw;
  scores += static_cast<size_t>(blockIdx.x) * n;
  alive_out += static_cast<size_t>(blockIdx.x) * n;
  live_out += blockIdx.x;
  __shared__ u64 live_w[kMaxWords];
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 kept_w[kMaxWords];
  __shared__ __align__(16) ScanStage stage[2];
  __shared__ int s_live;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_live = 0;
  __syncthreads();

  // live words (score > 0, as the TPU kernel starts) and m = one past the
  // last live candidate
  int last = 0;
  for (int w = warp; w < nw; w += kScanWarps) {
    const int j = 64 * w + lane;
    const bool a0 = j < n && scores[j] > 0.0f;
    const bool a1 = j + 32 < n && scores[j + 32] > 0.0f;
    const u64 live = static_cast<u64>(__ballot_sync(~0u, a0)) |
                     (static_cast<u64>(__ballot_sync(~0u, a1)) << 32);
    if (lane == 0) {
      live_w[w] = live;
      removed[w] = ~live;
    }
    if (live) last = 64 * w + 64 - __clzll(live);
  }
  if (lane == 0 && last > 0) atomicMax(&s_live, last);
  __syncthreads();
  const int m = s_live;
  const int nb = (m + 63) / 64;

  if (nb > 0) stage_block(stage[0], words, live_w[0], 0, nb, nw, warp, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int c = 0; c < nb; ++c) {
    const ScanStage& st = stage[c & 1];
    if (c + 1 < nb) stage_block(stage[(c + 1) & 1], words, live_w[c + 1], c + 1, nb, nw, warp, lane);
    const int rest = nb - c - 1;
    const int pre = min(kPrefetch, rest);
    const int far = rest - pre;
    if (warp == 0) {
      const u64 kept = resolve(removed[c], st);
      if (lane == 0) kept_w[c] = kept;
      // lane k ORs word c+1+k of the kept rows, staged in shared memory
      if (lane < pre) {
        u64 acc = 0;
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          if ((kept >> t) & 1ull) acc |= st.rows[t][lane];
        removed[c + 1 + lane] |= acc;
      }
    }
    if (far > 0) {
      // past the staged words, from device memory: item (g, k) ORs word
      // c+1+pre+k of the kept rows among rows [64g/groups, 64(g+1)/groups),
      // eight loads in flight; the groups meet in shared atomics
      __syncthreads();  // kept_w[c] from warp 0
      const u64 kept = kept_w[c];
      const int groups = max(1, min(kScanThreads / far, 8));
      for (int e = tid; e < groups * far; e += kScanThreads) {
        const int g = e / far;
        const int k = e - g * far;
        const int t0 = kTile * g / groups, t1 = kTile * (g + 1) / groups;
        u64 bits = kept & (((t1 == kTile ? 0ull : 1ull << t1)) - (1ull << t0));
        const u64* col = words + static_cast<size_t>(64 * c) * nw + c + 1 + pre + k;
        u64 acc = 0;
        while (bits) {
          u64 w[kInFlight];
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) {
            w[q] = 0;
            if (bits) {
              w[q] = col[static_cast<size_t>(__ffsll(bits) - 1) * nw];
              bits &= bits - 1;
            }
          }
#pragma unroll
          for (int q = 0; q < kInFlight; ++q) acc |= w[q];
        }
        unsigned* dst = reinterpret_cast<unsigned*>(&removed[c + 1 + pre + k]);
        if (static_cast<unsigned>(acc)) atomicOr(dst, static_cast<unsigned>(acc));
        if (acc >> 32) atomicOr(dst + 1, static_cast<unsigned>(acc >> 32));
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  for (int j = tid; j < n; j += kScanThreads) {
    const int c = j >> 6;
    alive_out[j] = c < nb && ((kept_w[c] >> (j & 63)) & 1ull) ? 1.0f : 0.0f;
  }
  if (tid == 0) *live_out = m;
}

}  // namespace

// The mask kernel's instantiation and block for n candidates (the tiles of
// the upper triangle are its blocks, a grid row for each of the R rows),
// then the scan, one block a row; launched, or with `info` described
// (launch_info.cuh) and nothing launched. R is the grid's y extent, so it
// stays within 65 535.
static int nms_launch(const void* boxes, const float* scores, void* words, float* alive,
                      int* live, int rows, int n, float thr, cudaStream_t s, long long* info) {
  if (n <= 0 || n > kMaxN || rows <= 0 || rows > 65535) return cudaErrorInvalidValue;
  const int nw = (n + kTile - 1) / kTile;
  const int tiles = nw * (nw + 1) / 2;
  // few tiles: four threads a row shorten each thread's chain of IoUs; many:
  // one thread a row does the least work
  const bool four = tiles <= kMaskWave;
  if (info != nullptr) {
    const void* mask = four ? reinterpret_cast<const void*>(nms_kernel_mask<4>)
                            : reinterpret_cast<const void*>(nms_kernel_mask<1>);
    cudaError_t err =
        nns_launch::describe(mask, dim3(tiles, rows), dim3(four ? 4 * kTile : kTile), 0, 0, info);
    if (err != cudaSuccess) return err;
    return nns_launch::describe(reinterpret_cast<const void*>(nms_kernel_scan), dim3(rows),
                                dim3(kScanThreads), 0, 0, info + nns_launch::kFields);
  }
  const dim3 grid(tiles, rows);
  if (four)
    nms_kernel_mask<4><<<grid, 4 * kTile, 0, s>>>(static_cast<const float4*>(boxes), scores,
                                                   static_cast<u64*>(words), n, nw, thr);
  else
    nms_kernel_mask<1><<<grid, kTile, 0, s>>>(static_cast<const float4*>(boxes), scores,
                                               static_cast<u64*>(words), n, nw, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_kernel_scan<<<rows, kScanThreads, 0, s>>>(static_cast<const u64*>(words), scores, alive,
                                                live, n, nw);
  return cudaGetLastError();
}

// Plain C entry point (bound with ctypes). boxes: [rows, n, 4] float32, each
// row ranked by score, 16-byte aligned; scores: [rows, n] float32 in the same
// order; words: the [rows, n, ceil(n/64)] 64-bit workspace; alive: [rows, n]
// float32 out (1 = kept); live: [rows] int32 out (each row's m). Launches the
// mask kernel, then the scan, on `stream`. Returns the first cudaError_t; 0
// means both were queued.
extern "C" int nns_nms_mask(const void* boxes, const float* scores, void* words, float* alive,
                            int* live, int rows, int n, float thr, void* stream) {
  return nms_launch(boxes, scores, words, alive, live, rows, n, thr,
                    static_cast<cudaStream_t>(stream), nullptr);
}

// The two launches nns_nms_mask makes for rows x n candidates, described into
// info[0 .. 2 * nns_launch::kFields): the mask kernel, then the scan.
extern "C" int nns_nms_launch_info(int rows, int n, long long* info) {
  return nms_launch(nullptr, nullptr, nullptr, nullptr, nullptr, rows, n, 0.0f, nullptr, info);
}
