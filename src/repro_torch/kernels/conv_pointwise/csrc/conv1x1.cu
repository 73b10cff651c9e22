// K6: float32 1x1 convolution + bias + ReLU for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_pointwise/kernel.py:conv1x1_pallas (body
// _conv1x1_kernel): per lane, out[m, n] = relu(sum_k x[m, k] * w[k, n]
// + b[n]) over the (H*W, Cin) x (Cin, Cout) float32 product.
//
// Numerics: float32 products accumulated with fmaf in Cin order within a
// chunk of Cin, the chunks' partials added in chunk order, then the bias
// (__fadd_rn) and the ReLU.  No tensor cores and no TF32: the contract is
// the float32 dot-product error bound, which holds for any summation order.
//
// What bounds it on the H100: at MobileNet-v1 1.0@192's pointwise shapes a
// call moves at most ~4.7 MB (96x96x64 -> 128, whole) and does at most
// ~150 M float32 operations, so the roofline bound (bytes / 3.35 TB/s,
// operations / 67 TFLOP/s) is a few microseconds or less; at the small
// spatial sizes (12x12, 6x6) the bound is the weights' bytes (4 MB at
// 1024 -> 1024, 1.25 us) and the latency of a block's serial Cin loop.
// What is missing there is blocks and bytes in flight, not FMA rate.
//
// What the design does about it:
// - Two tile shapes, BM x 64 outputs with BM = 64 (256 threads) or BM = 16
//   (64 threads); each thread holds 4 rows x 4 columns.  The 16-row tile
//   wastes at most 15 rows at small M (M = 36: 48 rows, not 64) and gives
//   four times the blocks.  The host planner (ops.plan_split_k) picks it.
// - Split-K over a thread-block cluster: where the output tiles leave the
//   card's warp schedulers idle and Cin spans enough 16-channel K-steps,
//   Cin is cut into `split` <= 8 chunks of `chunk` channels.  The `split`
//   blocks of one output tile form one cluster (dims 1 x split x 1); each
//   keeps its partial tile in its own shared memory, and after a cluster
//   barrier every block sums a slice of the tile over all `split` blocks'
//   shared memory (distributed shared memory) in chunk order, then adds
//   the bias and applies the ReLU.  No workspace, no atomics, nothing
//   allocated; the sum is in a fixed order, so runs are deterministic.
// - Loads in flight: a cp.async ring of x and w tiles, 16 channels a
//   stage, six stages deep for the 16-row tile and three for the 64-row
//   one (~32 KB each; the K loop of a short chunk is a chain of load
//   latencies, so the depth sets its time).  w is staged with 16-byte
//   cp.async where Cout % 4 == 0 and w is 16-byte aligned (a torch
//   allocation is), else 4 bytes; x with 4-byte cp.async, written
//   transposed ([k][m]) so that the product reads both operands as float4
//   from shared memory (two 16-byte reads per 16 FMAs).  x and out are
//   arena views whose base and lane pitch need not be 16-byte aligned,
//   so x is never read 16 bytes at a time.
//
// Interface: x and out are arena views; each lane's [H*W, C] block is
// contiguous and lanes lie x_bs / o_bs ELEMENTS apart (the batch stride is
// passed, so no copy is made).  w is a contiguous [Cin, Cout] float32
// array, b a [Cout] float32 array or null.  Any M, Cin, Cout >= 1 are
// taken: tile edges are masked (zero-filled copies).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64, BK = 16, MAX_SPLIT = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; with in == false the destination is zeroed
// and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM>
struct Tile {
  static constexpr int THREADS = 4 * BM;       // 16 x (BM / 4) threads
  static constexpr int LDA = BM + 4;           // x tile pitch: 16-byte rows
  static constexpr int A = BK * LDA, B = BK * BN;   // floats per stage
  // ring depth: ~32 KB of static shared memory (6 stages of the 16-row
  // tile, 3 of the 64-row one)
  static constexpr int STAGES = BM == 16 ? 6 : 3;
  static constexpr int RING = STAGES * (A + B);
  static constexpr int FLOATS = RING > BM * BN ? RING : BM * BN;
};

__device__ __forceinline__ float epilogue(float y, const float* b, int n,
                                          int relu) {
  if (b != nullptr) y = __fadd_rn(y, b[n]);
  return relu ? fmaxf(y, 0.0f) : y;
}

template <int BM>
__global__ void __launch_bounds__(Tile<BM>::THREADS)
conv1x1_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out, int M,
               int Cin, int Cout, long long x_bs, long long o_bs, int relu,
               int chunk, int w_vec) {
  using TL = Tile<BM>;
  constexpr int THREADS = TL::THREADS, LDA = TL::LDA, STAGES = TL::STAGES;
  // the ring of x/w tiles; after the K loop, this block's partial tile
  __shared__ __align__(16) float smem[TL::FLOATS];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int split = gridDim.y, part = blockIdx.y;
  const int k_begin = part * chunk, k_end = min(Cin, k_begin + chunk);
  const int steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const float* xb = x + (long long)blockIdx.z * x_bs;
  float* ob = out + (long long)blockIdx.z * o_bs;

  // stage `step` of the K loop into ring slot step % STAGES; always
  // commits a group (empty past the end), so the waits count evenly
  auto load = [&](int step) {
    if (step < steps) {
      const int k0 = k_begin + step * BK;
      float* as = smem + (step % STAGES) * (TL::A + TL::B);
      float* bs = as + TL::A;
#pragma unroll
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int e = tid + THREADS * i, r = e / BK, c = e % BK;
        const int m = m0 + r, k = k0 + c;
        const bool in = m < M && k < k_end;
        cp_async4(as + c * LDA + r, in ? xb + (long long)m * Cin + k : xb,
                  in);
      }
      if (w_vec) {
#pragma unroll
        for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
          const int e = tid + THREADS * i, r = e / (BN / 4);
          const int c = 4 * (e % (BN / 4)), k = k0 + r, n = n0 + c;
          const bool in = k < k_end && n < Cout;   // Cout % 4 == 0
          cp_async16(bs + r * BN + c, in ? w + (long long)k * Cout + n : w,
                     in);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK * BN / THREADS; ++i) {
          const int e = tid + THREADS * i, r = e / BN, c = e % BN;
          const int k = k0 + r, n = n0 + c;
          const bool in = k < k_end && n < Cout;
          cp_async4(bs + r * BN + c, in ? w + (long long)k * Cout + n : w,
                    in);
        }
      }
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();   // stage `step` has landed
    __syncthreads();               // ... for every thread; slot step-1 free
    load(step + STAGES - 1);
    const float* as = smem + (step % STAGES) * (TL::A + TL::B);
    const float* bs = as + TL::A;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * LDA +
                                                         4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * BN +
                                                         4 * tx);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n < Cout)
          ob[(long long)m * Cout + n] = epilogue(acc[i][j], b, n, relu);
      }
    }
    return;
  }

  // split-K: the partial tile goes to this block's shared memory (the
  // ring's bytes); after the cluster barrier block `part` sums float4
  // slices part, part + split, ... of the valid rows over all blocks of
  // the cluster, in chunk order
  __syncthreads();                 // every thread is done with the ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(smem + (4 * ty + i) * BN + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int n4 = min(BM, M - m0) * (BN / 4);
  for (int e = part * THREADS + tid; e < n4; e += split * THREADS) {
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split)
        v[q] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(smem, (unsigned)q))[e];
    float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) {
        sum[0] = __fadd_rn(sum[0], v[q].x);
        sum[1] = __fadd_rn(sum[1], v[q].y);
        sum[2] = __fadd_rn(sum[2], v[q].z);
        sum[3] = __fadd_rn(sum[3], v[q].w);
      }
    const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
    const long long row = (long long)(m0 + r) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + c + j;
      if (n < Cout) ob[row + n] = epilogue(sum[j], b, n, relu);
    }
  }
  cluster.sync();   // no block leaves while another reads its partial
}

template <int BM>
int run(const float* x, const float* w, const float* b, float* out, int B,
        int M, int Cin, int Cout, long long x_bs, long long o_bs, int relu,
        int split, int chunk, int w_vec, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + BM - 1) / BM) * ((Cout + BN - 1) / BN), split, B);
  cfg.blockDim = dim3(Tile<BM>::THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv1x1_kernel<BM>, x, w, b, out,
                                       M, Cin, Cout, x_bs, o_bs, relu, chunk,
                                       w_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// bm is the tile's row count (16 or 64); chunk is a multiple of 16 with
// (split - 1) * chunk < Cin <= split * chunk, 1 <= split <= 8 (the plan
// of ops.plan_split_k).  Returns a cudaError_t.
extern "C" int conv1x1_launch(const void* x, const void* w, const void* b,
                              void* out, int B, int M, int Cin, int Cout,
                              long long x_bs, long long o_bs, int relu,
                              int bm, int split, int chunk, int device,
                              void* stream) {
  if ((bm != 16 && bm != 64) || split < 1 || split > MAX_SPLIT ||
      chunk < BK || chunk % BK ||
      (long long)(split - 1) * chunk >= (Cin > 0 ? Cin : 1) ||
      (long long)split * chunk < Cin)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int w_vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && Cout % 4 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bm == 64)
    return run<64>(xf, wf, bf, of, B, M, Cin, Cout, x_bs, o_bs, relu, split,
                   chunk, w_vec, s);
  return run<16>(xf, wf, bf, of, B, M, Cin, Cout, x_bs, o_bs, relu, split,
                 chunk, w_vec, s);
}
