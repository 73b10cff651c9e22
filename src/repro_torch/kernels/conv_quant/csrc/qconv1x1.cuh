// The body of K1 (qconv1x1.cu) and K4 (qconv1x1_add.cu): an int8 1x1
// convolution as one (H*W, Cin) x (Cin, Cout) int32 product per lane,
// with the epilogue (requantize, or requantize then add) a template
// parameter.
//
// What bounds it on the H100: at MobileNet-v1 1.0@192's pointwise shapes a
// call moves at most ~0.6 MB and does at most ~75 M int8 operations, so the
// roofline bound (bytes / 3.35 TB/s, operations / 1979 TOP/s) is well under
// a microsecond and a batch-1 call is bound by latency: how many SMs work
// and how long each one's serial chain is.
//
// What the design does about it:
// - int8 tensor cores: mma.sync.m16n8k32 (s8 x s8 -> s32), operands read
//   from shared memory with ldmatrix.  Both operands must be K-major.  x's
//   lanes are row-major [M, Cin], K-major already; w is [Cin, Cout] row-
//   major, so each thread transposes 4x4 byte blocks of its tile while
//   staging it (__byte_perm), and the interface stays w [Cin, Cout].
// - The zero point stays outside the product:
//     sum_k (x - zp_in) * w = sum_k x * w - zp_in * sum_k w[k, n]
//   Every term is exact in int32 (|sum| <= Cin * 255 * 128 < 2^31 for Cin
//   <= 65 536), so the accumulator, and every output, is bit-identical to
//   the plain version.  The column sums come from the staged, transposed
//   w words (__dp4a against ones).
// - Split-K over a thread-block cluster: where lanes x M/64 x Cout/64
//   output tiles are fewer than the card's SMs and Cin spans enough
//   K-steps, Cin is cut into `split` chunks of `chunk` channels (the host
//   planner ops.plan_split_k picks both, split <= 8, a portable cluster).
//   The `split` blocks of one output tile form one cluster (cluster dims
//   1 x split x 1).  Each keeps its int32 partial (zero point already
//   subtracted) in its own shared memory; after a cluster barrier every
//   block reads a slice of the tile from all `split` blocks' shared
//   memory (distributed shared memory), adds the partials in chunk order
//   and runs the epilogue for that slice; a second barrier keeps each
//   block's shared memory alive until the others have read it.  No
//   workspace, no atomics, no counters: the kernel and the wrapper
//   allocate nothing, and the sum is in a fixed order.  (A global
//   workspace of partials, summed by the last block to arrive on a tile,
//   cost more device time than the split saved on short Cin loops.)  At
//   6x6x1024->1024 that is 16 tiles x 8 chunks = 128 blocks instead of
//   16.  With split 1 the epilogue runs from the registers.
// - Loads: 16 bytes a thread for x (one 16-byte load where the address is
//   aligned; otherwise 4-byte loads joined with __byte_perm, since arena
//   lanes lie at any byte offset), 4-byte words for w; the next K-step's
//   tile is loaded into registers while the tensor cores work on the
//   current one.  Ragged edges (M, Cin, Cout not multiples of 64, Cout not
//   a multiple of 4) fall back to byte loads with zero fill.
// Tiles: 64 x 64 outputs, K-steps of 64, 4 warps of 32 x 32; 27 KB of
// static shared memory.
//
// Interface: x and out are arena views; each lane's [H*W, C] block is
// contiguous and lanes lie x_bs / o_bs bytes apart (the batch stride is
// passed, so no copy is made).  w is a contiguous [Cin, Cout] int8 array.
// Any Cin and Cout >= 1 are taken.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128, MAX_SPLIT = 8;
constexpr int LDS = BK + 16;   // shared row stride in bytes: the 8 rows of
                               // an ldmatrix hit 8 different bank groups

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a . b for one 16x8x32 int8 tile (PTX ISA, mma.m16n8k32): lane 4g+t
// holds rows g and g+8, columns 2t and 2t+1 of c.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first n (0..16) bytes at p, zero beyond; any alignment.
__device__ __forceinline__ uint4 load16(const int8_t* p, int n) {
  if (n >= 16) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    const uint32_t sh = a & 3;
    const uint32_t w0 = __ldg(wp), w1 = __ldg(wp + 1), w2 = __ldg(wp + 2),
                   w3 = __ldg(wp + 3), w4 = sh ? __ldg(wp + 4) : 0u;
    // bytes sh..sh+3 of the 8-byte pair (lo, hi)
    const uint32_t sel = sh | (sh + 1) << 4 | (sh + 2) << 8 | (sh + 3) << 12;
    return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                      __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
  }
  uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) r[i / 4] |= (uint32_t)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(r[0], r[1], r[2], r[3]);
}

template <class Epilogue>
__global__ void __launch_bounds__(THREADS)
qconv1x1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int8_t* __restrict__ out, int M, int Cin, int Cout,
                long long x_bs, long long o_bs, int zp_in, Epilogue ep,
                int chunk, int w_words) {
  __shared__ __align__(16) int8_t As[BM * LDS];   // x tile [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];   // w tile, transposed [n][k]
  __shared__ __align__(16) int part_sum[BM * BN]; // split-K: this partial
  __shared__ int colsum[BN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int split = gridDim.y, part = blockIdx.y;
  const long long lane_i = blockIdx.z;
  const int k_begin = part * chunk, k_end = min(Cin, k_begin + chunk);
  const int8_t* xb = x + lane_i * x_bs;
  int8_t* ob = out + lane_i * o_bs;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;   // warp's 32 x 32

  // staging roles: x chunks e = tid, tid + 128 (row e / 4, 16 bytes at
  // 16 * (e % 4)); w blocks of 4 k x 4 n at n-group tid % 16, k-groups
  // tid / 16 and tid / 16 + 8
  const int ng = tid % 16;
  uint4 xr[2];
  uint32_t wr[2][4];
  int csum[4] = {0, 0, 0, 0};

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + THREADS * i, r = e / 4, k = k0 + 16 * (e % 4);
      const int n = m0 + r < M ? max(0, min(16, k_end - k)) : 0;
      xr[i] = load16(xb + (long long)(m0 + r) * Cin + k, n);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kb = k0 + 4 * (tid / 16 + 8 * i), nb = n0 + 4 * ng;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb + j;
        const int8_t* p = w + (long long)k * Cout + nb;
        uint32_t word = 0u;
        if (k < k_end) {
          if (w_words && nb + 3 < Cout) {
            word = __ldg(reinterpret_cast<const uint32_t*>(p));
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (nb + c < Cout) word |= (uint32_t)(uint8_t)p[c] << (8 * c);
          }
        }
        wr[i][j] = word;
      }
    }
  };

  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + THREADS * i;
      *reinterpret_cast<uint4*>(As + (e / 4) * LDS + 16 * (e % 4)) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // rows k..k+3 of 4 columns -> 4 columns of k..k+3
      const uint32_t* r = wr[i];
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t c[4] = {__byte_perm(lo01, lo23, 0x5410),
                             __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410),
                             __byte_perm(hi01, hi23, 0x7632)};
      const int kl = 4 * (tid / 16 + 8 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<uint32_t*>(Bs + (4 * ng + j) * LDS + kl) = c[j];
        csum[j] = __dp4a((int)c[j], 0x01010101, csum[j]);
      }
    }
  };

  if (tid < BN) colsum[tid] = 0;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] =
        acc[i][j][3] = 0;

  fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < k_end) fetch(k0 + BK);   // in flight during the products
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], smem_addr(As + (wm + 16 * i + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LDS +
                                ks + (lane >> 4) * 16));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, smem_addr(Bs + (wn + 8 * j + (lane & 7) +
                                   (lane >> 4) * 8) * LDS +
                             ks + ((lane >> 3) & 1) * 16));
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();
  }

  // - zp_in * sum_k w[k, n] over this block's chunk of Cin
#pragma unroll
  for (int j = 0; j < 4; ++j) atomicAdd(&colsum[4 * ng + j], csum[j]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][j][e] -= zp_in * colsum[wn + 8 * j + 2 * t + (e & 1)];

  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm + 16 * i + g + (e >> 1) * 8;
          const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
          if (m < M && n < Cout) {
            const long long idx = (long long)m * Cout + n;
            ob[idx] = ep(acc[i][j][e], lane_i, idx);
          }
        }
    return;
  }

  // split-K: the partial goes to shared memory; after the cluster barrier
  // block `part` of the cluster sums int4 slices part, part + split, ... of
  // the valid rows over all blocks, in chunk order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(part_sum + (wm + 16 * i + g + 8 * h) * BN +
                                 wn + 8 * j + 2 * t) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int n4 = min(BM, M - m0) * (BN / 4);
  for (int e = part * THREADS + tid; e < n4; e += split * THREADS) {
    int4 v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split)
        v[q] = reinterpret_cast<const int4*>(
            cluster.map_shared_rank(part_sum, (unsigned)q))[e];
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < split) {
        sum[0] += v[q].x;
        sum[1] += v[q].y;
        sum[2] += v[q].z;
        sum[3] += v[q].w;
      }
    const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
    const long long row = (long long)(m0 + r) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < Cout) ob[row + n0 + c + j] = ep(sum[j], lane_i,
                                                       row + n0 + c + j);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// chunk is a multiple of 64 and (split - 1) * chunk < Cin <= split * chunk,
// 1 <= split <= MAX_SPLIT; split > 1 launches clusters of `split` blocks.
template <class Epilogue>
int qconv1x1_run(const void* x, const void* w, void* out, int B, int M,
                 int Cin, int Cout, long long x_bs, long long o_bs,
                 int zp_in, Epilogue ep, int split, int chunk, int device,
                 void* stream) {
  if (split < 1 || split > MAX_SPLIT || chunk < BK || chunk % BK ||
      (long long)(split - 1) * chunk >= (Cin > 0 ? Cin : 1) ||
      (long long)split * chunk < Cin)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int w_words = reinterpret_cast<uintptr_t>(w) % 4 == 0 && Cout % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + BM - 1) / BM) * ((Cout + BN - 1) / BN), split, B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, qconv1x1_kernel<Epilogue>, (const int8_t*)x,
                           (const int8_t*)w, (int8_t*)out, M, Cin, Cout,
                           x_bs, o_bs, zp_in, ep, chunk, w_words);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
