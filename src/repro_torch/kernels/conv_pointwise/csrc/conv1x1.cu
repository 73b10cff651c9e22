// K6: float32 1x1 convolution + bias + ReLU for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_pointwise/kernel.py:conv1x1_pallas (body
// _conv1x1_kernel): per lane, out[m, n] = relu(sum_k x[m, k] * w[k, n]
// + b[n]) over the (H*W, Cin) x (Cin, Cout) float32 product.
//
// Numerics: float32 products accumulated with fmaf in Cin order, then the
// bias (__fadd_rn) and the ReLU.  No tensor cores and no TF32: the
// contract is the reference's float tolerance (its kernel's accumulation
// order already differs from lax.conv), not bit identity.
//
// What bounds it on the H100: at MobileNet-v1 1.0@192's pointwise shapes a
// call moves at most ~4.7 MB (96x96x64 -> 128, whole) and does at most
// ~150 M float32 operations, so the roofline bound (bytes / 3.35 TB/s,
// operations / 67 TFLOP/s) is a few microseconds or less, and the Pex and
// cascade slices are far smaller: a batch-1 launch is bound by launch
// latency.  What the design does about that: nothing yet.  It is a plain
// shared-memory tiled SGEMM on the CUDA cores (64 x 64 output tile per
// block of 256 threads, 4 x 4 float accumulators per thread, Cin staged in
// steps of 16).  At 6x6x1024 -> 1024 it fills only 16 blocks; split-K,
// tensor cores at full float32 accuracy (3xTF32) and CUDA-graph capture
// are later work.
//
// Interface: x and out are arena views; each lane's [H*W, C] block is
// contiguous and lanes lie x_bs / o_bs ELEMENTS apart (the batch stride is
// passed, so no copy is made).  Loads are scalar: an f32 lane pitch is a
// multiple of 4 bytes, not of 16.  w is a contiguous [Cin, Cout] float32
// array, b a [Cout] float32 array or null.  Any M, Cin, Cout >= 1 are
// taken: tile edges are masked.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
conv1x1_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out, int M,
               int Cin, int Cout, long long x_bs, long long o_bs, int relu) {
  __shared__ float As[BK][BM + 1];  // +1: transposed stores conflict-free
  __shared__ float Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* xb = x + (long long)blockIdx.z * x_bs;
  float* ob = out + (long long)blockIdx.z * o_bs;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < Cin) ? xb[(long long)m * Cin + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < Cin && n < Cout) ? w[(long long)k * Cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) {
        float y = acc[i][j];
        if (b != nullptr) y = __fadd_rn(y, b[n]);
        if (relu) y = fmaxf(y, 0.0f);
        ob[(long long)m * Cout + n] = y;
      }
    }
  }
}

}  // namespace

extern "C" int conv1x1_launch(const void* x, const void* w, const void* b,
                              void* out, int B, int M, int Cin, int Cout,
                              long long x_bs, long long o_bs, int relu,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  conv1x1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, M, Cin,
      Cout, x_bs, o_bs, relu);
  return (int)cudaGetLastError();
}
