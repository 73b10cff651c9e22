// K2: depthwise k x k, stride-s int8 convolution + requantize + ReLU for
// Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qdwconv_pallas (via
// _windowed_call, body _qdwconv_kernel): per channel, k*k shifted int32
// multiply-accumulates of (x - zp_in) * w over a zp_in-padded input.
//
// One thread per output element (lane, oy, ox, c), channels on the fast
// axis so that NHWC loads and stores of a warp coalesce; each thread loops
// over the k*k taps.  Padding is never materialised: a tap whose input
// coordinate falls outside [0, H) x [0, W) after the (hpad, wpad) origin
// shift contributes 0, which is what padding with zp_in and subtracting
// zp_in gives.
//
// What bounds it on the H100: at MobileNet-v1 1.0@192's depthwise shapes a
// call moves at most ~0.6 MB and does at most ~5 M int8 operations; the
// roofline bound is well under a microsecond, so a launch is bound by
// launch latency.  What the design does about that: nothing yet (no tap
// reuse through shared memory, no fusion with the following pointwise
// conv, no CUDA-graph capture; later work).
//
// Interface: x and out are arena views, each lane contiguous, lanes x_bs /
// o_bs bytes apart (the batch stride is passed; no copy).  w is a
// contiguous [k, k, C] int8 array.
#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qdwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int8_t* __restrict__ out, int H, int W, int C, int OW,
               long long total, int k, int stride, int pad_top,
               int pad_left, long long x_bs, long long o_bs, float mult,
               int zp_in, int zp_out) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long p = idx / C;
  const int ox = (int)(p % OW), oy = (int)(p / OW);
  const int8_t* xb = x + (long long)blockIdx.y * x_bs;
  int acc = 0;
  for (int dy = 0; dy < k; ++dy) {
    const int iy = oy * stride - pad_top + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < k; ++dx) {
      const int ix = ox * stride - pad_left + dx;
      if (ix < 0 || ix >= W) continue;
      acc += ((int)xb[((long long)iy * W + ix) * C + c] - zp_in)
             * (int)w[(dy * k + dx) * C + c];
    }
  }
  out[(long long)blockIdx.y * o_bs + idx] = requant_relu(acc, mult, zp_out);
}

}  // namespace

extern "C" int qdwconv_launch(const void* x, const void* w, void* out,
                              int B, int H, int W, int C, int OH, int OW,
                              int k, int stride, int pad_top, int pad_left,
                              long long x_bs, long long o_bs, float mult,
                              int zp_in, int zp_out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)OH * OW * C;
  dim3 grid((unsigned)((total + THREADS - 1) / THREADS), B);
  qdwconv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int8_t*)out, H, W, C, OW, total,
      k, stride, pad_top, pad_left, x_bs, o_bs, mult, zp_in, zp_out);
  return (int)cudaGetLastError();
}
