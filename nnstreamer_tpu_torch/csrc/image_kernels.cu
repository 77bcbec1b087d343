// Bilinear crop / resize / normalize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/image_kernels.py
// (_launch_crop, body _crop_kernel), which serves both resize_bilinear and
// crop_and_resize. One kernel body serves both entry points here too: the
// boxes pointer (nullptr = the full image) and the image batch stride (0 =
// every box samples the same image, H*W*C = one image per box) are the only
// difference.
//
// Design. The TPU kernel builds dense interpolation matrices Wy [out_h, H]
// and Wx [out_w, W] and runs two MXU contractions. On the H100 those
// matrices would spend bandwidth and operations on zeros, so each thread
// computes one output pixel (n, oy, ox), reads the two taps on each axis
// directly and loops over the C channels.
//
// Numerics follow the floor-and-clip formulation of the reference's plain
// version (nnstreamer_tpu/ops/image.py crop_and_resize) in float32, with
// every operation rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn, no
// fused multiply-add), in the same order as the port's plain PyTorch version
// (ops/kernels/image_kernels.py plain_crop_resize), so the two agree bit for
// bit. Integer outputs round half to even (rintf, as jnp.round) and clip to
// the dtype's range.
//
// Bound. The kernel reads the source rows its samples touch and writes the
// output once; it does a few float operations per byte, far below the
// card's balance point, so it is bound by bytes over 3.35 TB/s. For a uint8
// 1280x720 frame resized to 224x224 that is 1.87 MB (448 source rows and the
// output), 0.56 us, under the card's floor for a launch: a one-element
// fill_ reads 1.0 us of device time on the H100 (chip_smoke.py --ab), and
// this kernel about 3.0 us. It needs no workspace. nvcc -Xptxas -v (sm_90a)
// reports 39 to 44 registers an instance, no shared memory, no spills.
//
// A row-staged design was tried and measured, and this body stays: one block
// a few output rows, the source rows' spans staged in shared memory with
// 16-byte cp.async, taps once per column and row, 4-byte stores. It took
// 2.3 times this body's time at 720p -> 224 in the same call (PERF.md). Its
// threads walk a block's rows one after another behind a barrier and a trip
// through shared memory, where this body gives every pixel its own thread
// and 12 independent loads; at this size the floor and one round of loads
// from device memory are most of the time either way.
// torch.nn.functional.interpolate(mode="bilinear", align_corners=False,
// antialias=False) on float NCHW computes the same full-image resize; the
// port never calls it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "launch_info.cuh"

namespace {

enum DTypeCode { kU8 = 0, kF32 = 1, kBF16 = 2 };

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<uint8_t>(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void store_f32(T* p, float v);
template <> __device__ __forceinline__ void store_f32<uint8_t>(uint8_t* p, float v) {
  v = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  *p = static_cast<uint8_t>(v);
}
template <> __device__ __forceinline__ void store_f32<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void store_f32<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One axis: sample centre lo + (hi - lo) * (i + 0.5) / out - 0.5, its floor
// (clipped to [0, n-1] with its neighbour) and the fractional weight.
__device__ __forceinline__ void axis_taps(float lo, float hi, int i, int out, int n,
                                          int* i0, int* i1, float* frac) {
  float t = __fdiv_rn(__fmul_rn(__fsub_rn(hi, lo), __fadd_rn(static_cast<float>(i), 0.5f)),
                      static_cast<float>(out));
  float s = __fsub_rn(__fadd_rn(lo, t), 0.5f);
  float f = floorf(s);
  *frac = __fsub_rn(s, f);
  float a = fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1));
  float b = fminf(fmaxf(__fadd_rn(f, 1.0f), 0.0f), static_cast<float>(n - 1));
  *i0 = static_cast<int>(a);
  *i1 = static_cast<int>(b);
}

template <typename Tin, typename Tout>
__global__ void crop_resize_kernel(const Tin* __restrict__ img, const float* __restrict__ boxes,
                                   Tout* __restrict__ out, int n, int h, int w, int c,
                                   int out_h, int out_w, long long batch_stride,
                                   int has_scale, float scale, int has_offset, float offset) {
  long long pix = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long total = static_cast<long long>(n) * out_h * out_w;
  if (pix >= total) return;
  int ox = static_cast<int>(pix % out_w);
  int oy = static_cast<int>((pix / out_w) % out_h);
  int b = static_cast<int>(pix / (static_cast<long long>(out_w) * out_h));

  float x1 = 0.0f, y1 = 0.0f, x2 = static_cast<float>(w), y2 = static_cast<float>(h);
  if (boxes != nullptr) {
    x1 = boxes[4 * b + 0];
    y1 = boxes[4 * b + 1];
    x2 = boxes[4 * b + 2];
    y2 = boxes[4 * b + 3];
  }
  int y0i, y1i, x0i, x1i;
  float wy, wx;
  axis_taps(y1, y2, oy, out_h, h, &y0i, &y1i, &wy);
  axis_taps(x1, x2, ox, out_w, w, &x0i, &x1i, &wx);
  float omwy = __fsub_rn(1.0f, wy);
  float omwx = __fsub_rn(1.0f, wx);

  const Tin* base = img + batch_stride * b;
  const Tin* r0 = base + static_cast<long long>(y0i) * w * c;
  const Tin* r1 = base + static_cast<long long>(y1i) * w * c;
  Tout* o = out + pix * c;
  for (int ch = 0; ch < c; ++ch) {
    float p00 = load_f32(r0 + x0i * c + ch);
    float p01 = load_f32(r0 + x1i * c + ch);
    float p10 = load_f32(r1 + x0i * c + ch);
    float p11 = load_f32(r1 + x1i * c + ch);
    float top = __fadd_rn(__fmul_rn(p00, omwx), __fmul_rn(p01, wx));
    float bot = __fadd_rn(__fmul_rn(p10, omwx), __fmul_rn(p11, wx));
    float v = __fadd_rn(__fmul_rn(top, omwy), __fmul_rn(bot, wy));
    if (has_scale) v = __fmul_rn(v, scale);
    if (has_offset) v = __fadd_rn(v, offset);
    store_f32(o + ch, v);
  }
}

// With a non-null `info`: describe the launch (launch_info.cuh), launch nothing.
template <typename Tin, typename Tout>
cudaError_t launch(const void* img, const float* boxes, void* out, int n, int h, int w, int c,
                   int out_h, int out_w, long long batch_stride, int has_scale, float scale,
                   int has_offset, float offset, cudaStream_t stream, long long* info) {
  long long total = static_cast<long long>(n) * out_h * out_w;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (info != nullptr)
    return nns_launch::describe(reinterpret_cast<const void*>(crop_resize_kernel<Tin, Tout>),
                                dim3(static_cast<unsigned>(blocks)), dim3(threads), 0, 0, info);
  crop_resize_kernel<Tin, Tout><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const Tin*>(img), boxes, static_cast<Tout*>(out), n, h, w, c, out_h, out_w,
      batch_stride, has_scale, scale, has_offset, offset);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t dispatch_out(int out_dtype, const void* img, const float* boxes, void* out, int n,
                         int h, int w, int c, int out_h, int out_w, long long batch_stride,
                         int has_scale, float scale, int has_offset, float offset,
                         cudaStream_t stream, long long* info) {
  switch (out_dtype) {
    case kU8:
      return launch<Tin, uint8_t>(img, boxes, out, n, h, w, c, out_h, out_w, batch_stride,
                                  has_scale, scale, has_offset, offset, stream, info);
    case kF32:
      return launch<Tin, float>(img, boxes, out, n, h, w, c, out_h, out_w, batch_stride,
                                has_scale, scale, has_offset, offset, stream, info);
    case kBF16:
      return launch<Tin, __nv_bfloat16>(img, boxes, out, n, h, w, c, out_h, out_w, batch_stride,
                                        has_scale, scale, has_offset, offset, stream, info);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The instantiation for (in_dtype, out_dtype), launched, or with `info`
// described.
static int crop_resize_dispatch(const void* img, int in_dtype, const float* boxes, void* out,
                                int out_dtype, int n, int h, int w, int c, int out_h, int out_w,
                                long long batch_stride, int has_scale, float scale,
                                int has_offset, float offset, void* stream, long long* info) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kU8:
      return dispatch_out<uint8_t>(out_dtype, img, boxes, out, n, h, w, c, out_h, out_w,
                                   batch_stride, has_scale, scale, has_offset, offset, s, info);
    case kF32:
      return dispatch_out<float>(out_dtype, img, boxes, out, n, h, w, c, out_h, out_w,
                                 batch_stride, has_scale, scale, has_offset, offset, s, info);
    case kBF16:
      return dispatch_out<__nv_bfloat16>(out_dtype, img, boxes, out, n, h, w, c, out_h, out_w,
                                         batch_stride, has_scale, scale, has_offset, offset, s,
                                         info);
    default:
      return cudaErrorInvalidValue;
  }
}

// Plain C entry point (bound with ctypes). Returns the cudaError_t of the
// launch; 0 means it was queued on `stream`. Inputs are contiguous NHWC /
// HWC tensors on the device; boxes is [n, 4] float32 (x1, y1, x2, y2) in
// pixels, or nullptr for the full image.
extern "C" int nns_crop_resize(const void* img, int in_dtype, const float* boxes, void* out,
                               int out_dtype, int n, int h, int w, int c, int out_h, int out_w,
                               long long batch_stride, int has_scale, float scale,
                               int has_offset, float offset, void* stream) {
  return crop_resize_dispatch(img, in_dtype, boxes, out, out_dtype, n, h, w, c, out_h, out_w,
                              batch_stride, has_scale, scale, has_offset, offset, stream,
                              nullptr);
}

// The launch nns_crop_resize would make for these dtypes and sizes, described
// into info[0 .. nns_launch::kFields) (launch_info.cuh); nothing launches.
extern "C" int nns_crop_resize_launch_info(int in_dtype, int out_dtype, int n, int h, int w,
                                           int c, int out_h, int out_w, long long* info) {
  return crop_resize_dispatch(nullptr, in_dtype, nullptr, nullptr, out_dtype, n, h, w, c, out_h,
                              out_w, 0, 0, 0.0f, 0, 0.0f, nullptr, info);
}
