// K1: int8 1x1 convolution + requantize + ReLU for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv1x1_pallas (body
// _qconv1x1_kernel): per lane, out[m, n] = requant(sum_k (x[m, k] - zp_in)
// * w[k, n]) over the (H*W, Cin) x (Cin, Cout) int32 product.
//
// What bounds it on the H100: at MobileNet-v1 1.0@192's pointwise shapes a
// call moves at most ~0.6 MB and does at most ~75 M int8 operations, so the
// roofline bound (bytes / 3.35 TB/s, operations / 1979 TOP/s) is well under
// a microsecond and a batch-1 launch is bound by launch latency.
// What the design does about that: nothing yet.  It is a plain
// shared-memory tiled GEMM on the CUDA cores (64 x 64 output tile per
// block of 256 threads, 4 x 4 int32 accumulators per thread, Cin staged in
// steps of 32 with the zero point already subtracted).  Fusing ops,
// batching lanes and capturing the arena program as a CUDA graph are for
// later work.
//
// Interface: x and out are arena views; each lane's [H*W, C] block is
// contiguous and lanes lie x_bs / o_bs bytes apart (the batch stride is
// passed, so no copy is made).  w is a contiguous [Cin, Cout] int8 array.
// Any Cin and Cout >= 1 are taken: tile edges are masked.
#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qconv1x1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int8_t* __restrict__ out, int M, int Cin, int Cout,
                long long x_bs, long long o_bs, float mult, int zp_in,
                int zp_out) {
  __shared__ int As[BK][BM + 1];   // +1: the transposed store is conflict-free
  __shared__ int Bs[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int8_t* xb = x + (long long)blockIdx.z * x_bs;
  int8_t* ob = out + (long long)blockIdx.z * o_bs;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < Cin)
                     ? (int)xb[(long long)m * Cin + k] - zp_in : 0;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < Cin && n < Cout) ? (int)w[(long long)k * Cout + n] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
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
      if (n < Cout)
        ob[(long long)m * Cout + n] = requant_relu(acc[i][j], mult, zp_out);
    }
  }
}

}  // namespace

extern "C" int qconv1x1_launch(const void* x, const void* w, void* out,
                               int B, int M, int Cin, int Cout,
                               long long x_bs, long long o_bs, float mult,
                               int zp_in, int zp_out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  qconv1x1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int8_t*)out, M, Cin, Cout, x_bs,
      o_bs, mult, zp_in, zp_out);
  return (int)cudaGetLastError();
}
