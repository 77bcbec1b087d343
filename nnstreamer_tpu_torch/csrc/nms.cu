// Greedy class-agnostic non-maximum suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/nms.py (nms, body
// _nms_kernel, pallas_call at :119). Like it, this kernel computes only the
// suppression recurrence: the caller ranks the boxes by score beforehand and
// packs the top-k survivors afterwards (ops/detection.py nms), and the kernel
// turns the ranked boxes [n, 4] (x1, y1, x2, y2) and scores [n] into the alive
// mask [n] (float 0/1) that _nms_kernel writes.
//
// Design. One thread block of up to 1024 threads per call. The candidates
// initially alive (score > 0) are a prefix of the ranking of length m; the
// kernel finds m and walks i = 0 .. m-1. A step whose candidate i is already
// suppressed is skipped by every thread alike, with no barrier. A live step
// computes one masked IoU row: each thread takes the columns j > i (j < m) of
// its stride, and clears alive[j] where IoU(i, j) > thr. One __syncthreads()
// follows each live step, so the next step reads final flags. No n x n matrix
// exists anywhere, as in the TPU kernel.
//
// Layout. The alive flags are bytes in shared memory (a static array of kMaxN).
// The ranked boxes are read from device memory as 16-byte loads through the
// read-only cache: neighbouring columns coalesce, and the list stays in L1 or
// L2 across the steps. A copy of the boxes in shared memory was slower on the
// H100 at n = 1917 and 6300 (PERF.md), so there is none. n is taken up to
// kMaxN = 32768, which covers the 25,200 candidates of a YOLOv5 head at
// 640x640; the wrapper raises beyond.
//
// Numerics. The float operations are the reference's, in its order:
// area = max(x2-x1, 0) * max(y2-y1, 0), iw, ih, inter = iw * ih,
// union = area + barea - inter, iou = union > 0 ? inter / union : 0, each
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn), so nvcc
// neither contracts union into an FMA nor approximates the division. thr is a
// float32, as the TPU kernel compares against float32 rows. The mask equals
// the plain PyTorch version's (ops/kernels/nms.py plain_nms_mask) bit for bit.
//
// Bound. Bytes: n * 20 in (boxes and scores) + n * 4 out. Operations: about 12
// per IoU column, over the columns the live steps of these inputs visit (at
// most m * n). At n = 1917 both give under a microsecond on an H100. The
// kernel is instead bound by latency: m dependent steps, each a round of flag
// and cached box reads and a block-wide barrier, so its time per greedy step
// (kernel time / m) is the number to watch. Spreading the IoU rows over SMs
// (a bitmask pass, then a one-warp scan) is the known way past that.
//
// No PyTorch call computes greedy NMS (torchvision's nms is a separate
// package), so there is no library time to compare with.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxN = 32768;  // one flag byte each: 32 KB of static shared memory

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// IoU of column box c (area ca) with the step's box b (area ba).
__device__ __forceinline__ float iou(float4 c, float ca, float4 b, float ba) {
  float iw = fmaxf(__fsub_rn(fminf(c.z, b.z), fmaxf(c.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(c.w, b.w), fmaxf(c.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(ca, ba), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kMaxThreads)
    nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
               float* __restrict__ alive_out, int* __restrict__ live_out, int n, float thr) {
  __shared__ unsigned char alive[kMaxN];
  __shared__ int s_live;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) s_live = 0;
  __syncthreads();

  // initial flags (score > 0) and m = one past the last live candidate
  int last = 0;
  for (int j = tid; j < n; j += nt) {
    unsigned char a = scores[j] > 0.0f;
    alive[j] = a;
    if (a) last = j + 1;
  }
  if (last > 0) atomicMax(&s_live, last);
  __syncthreads();
  const int m = s_live;

  for (int i = 0; i < m; ++i) {
    if (!alive[i]) continue;  // final since the last live step's barrier
    float4 b = __ldg(boxes + i);
    float ba = box_area(b);
    for (int j = i + 1 + tid; j < m; j += nt) {
      if (!alive[j]) continue;
      float4 c = __ldg(boxes + j);
      if (iou(c, box_area(c), b, ba) > thr) alive[j] = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt) alive_out[j] = alive[j] ? 1.0f : 0.0f;
  if (tid == 0) *live_out = m;
}

}  // namespace

// Plain C entry point (bound with ctypes). boxes: [n, 4] float32, ranked by
// score, 16-byte aligned; scores: [n] float32 in the same order; alive: [n]
// float32 out (1 = kept); live: [1] int32 out (m, the greedy steps walked).
// Returns the cudaError_t of the launch; 0 means it was queued on `stream`.
extern "C" int nns_nms_mask(const void* boxes, const float* scores, float* alive, int* live,
                            int n, float thr, void* stream) {
  if (n <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nms_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), scores, alive, live, n, thr);
  return cudaGetLastError();
}
