// The body of K3 (qconv.cu) and K5 (qconv_add.cu): a general k x k,
// stride-s int8 convolution as one implicit GEMM per lane, with the
// epilogue (requantize, or requantize then add) a template parameter.
// Rows are output pixels (OH*OW), the reduction runs over the k*k*Cin
// taps in the weight's own (dy, dx, ci) order, columns are Cout.
//
// Padding is never materialised: an input coordinate that falls outside
// [0, H) x [0, W) after the (hpad, wpad) origin shift contributes 0, which
// is what padding with zp_in and then subtracting zp_in gives.  Explicit
// asymmetric pads (Pex slices, 2-D tile clones) only move the origin and
// the output extent, which the caller passes.
//
// What bounds it on the H100: on MobileNet-v1 1.0@192 the path's k x k conv
// is the 3x3 stride-2 stem (192x192x3 -> 96x96x32, ~16 M int8 operations,
// ~0.4 MB moved) and its slices; the roofline bound is well under a
// microsecond, so a launch is bound by launch latency.
// What the design does about that: nothing yet.  The tiling is K1's
// (64 x 64 output tile, 256 threads, 4 x 4 int32 accumulators each, taps
// staged in steps of 32 with the zero point subtracted); the gather of a
// tap recomputes its input address instead of reading an im2col buffer.
//
// Interface: x and out are arena views, each lane contiguous, lanes x_bs /
// o_bs bytes apart (the batch stride is passed; no copy).  w is a
// contiguous [k, k, Cin, Cout] int8 array.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 256;

template <class Epilogue>
__global__ void __launch_bounds__(THREADS)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             int8_t* __restrict__ out, int H, int W, int Cin, int Cout,
             int OW, int M, int k, int stride, int pad_top, int pad_left,
             long long x_bs, long long o_bs, int zp_in, Epilogue ep) {
  __shared__ int As[BK][BM + 1];
  __shared__ int Bs[BK][BN];
  const int K = k * k * Cin;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int8_t* xb = x + (long long)blockIdx.z * x_bs;
  int8_t* ob = out + (long long)blockIdx.z * o_bs;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, t = k0 + c;
      int v = 0;
      if (m < M && t < K) {
        const int oy = m / OW, ox = m % OW;
        const int ci = t % Cin, tap = t / Cin;
        const int dy = tap / k, dx = tap % k;
        const int iy = oy * stride - pad_top + dy;
        const int ix = ox * stride - pad_left + dx;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v = (int)xb[((long long)iy * W + ix) * Cin + ci] - zp_in;
      }
      As[c][r] = v;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int t = k0 + r, n = n0 + c;
      Bs[r][c] = (t < K && n < Cout) ? (int)w[(long long)t * Cout + n] : 0;
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
      if (n < Cout) {
        const long long idx = (long long)m * Cout + n;
        ob[idx] = ep(acc[i][j], blockIdx.z, idx);
      }
    }
  }
}

template <class Epilogue>
int qconv_run(const void* x, const void* w, void* out, int B, int H, int W,
              int Cin, int Cout, int OH, int OW, int k, int stride,
              int pad_top, int pad_left, long long x_bs, long long o_bs,
              int zp_in, Epilogue ep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int M = OH * OW;
  dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, B);
  qconv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int8_t*)out, H, W, Cin, Cout, OW,
      M, k, stride, pad_top, pad_left, x_bs, o_bs, zp_in, ep);
  return (int)cudaGetLastError();
}

}  // namespace
