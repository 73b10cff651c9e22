// The body of K3 (qconv.cu) and K5 (qconv_add.cu): a general k x k,
// stride-s int8 convolution as one implicit GEMM per lane on Hopper's int8
// tensor cores, with the epilogue (requantize, or requantize then add) a
// template parameter.  Rows are output pixels (M = OH*OW), the reduction
// runs over the k*k*Cin taps, columns are Cout.
//
// What bounds it on the H100: latency.  On MobileNet-v1 1.0@192 the path's
// k x k conv is the 3x3 stride-2 stem (192x192x3 -> 96x96x32, ~16 M int8
// operations, ~0.4 MB moved: a bound of ~0.12 us) and its Pex or 2-D tile
// slices ((9,125,3) -> (4,62,32) and the like: a few KB).  A block is a
// chain of dependent steps (loads, a barrier, products, epilogue) on a few
// warps, so the design shortens each thread's share of it:
// - int8 tensor cores: mma.sync.m16n8k32 (s8 x s8 -> s32).  A block is 64
//   output pixels by an N tile of BN = 8/16/32/64 columns, the smallest
//   that holds Cout (ops.plan_qconv), with 4 warps over M (16 rows each)
//   times BN / 16 over N (16 columns each): the stem's Cout = 32 fills BN
//   = 32 with 8 warps, and its 96x96 outputs make 144 blocks.  K is walked
//   in 32-deep steps; the 27 taps of the stem (3x3x3) are one step, taps
//   27-31 zero in the weights.  Any K is taken: the loop is general.
// - The A tile is gathered from a shared-memory copy of the block's input
//   rows (the "patch": the rows and columns its 64 outputs read, Cin
//   channels, each row padded to 16 bytes), staged once in 4-byte words
//   (two aligned loads joined by __byte_perm, since arena rows lie at any
//   byte offset).  A tap's offset in the patch is a table of one int per
//   K (built once per block), so the gather is table + row base, with no
//   / or % per tap.  Where Cin % 4 == 0 four consecutive taps are one
//   4-byte shared load; else bytes.
// - The weights for the block's N tile are staged transposed (K-major, as
//   mma.sync's B wants) with 16 bytes of padding per row, so the 8 rows
//   one fragment load touches hit 8 different bank groups; their first
//   bytes are loaded before the patch, so both trips to memory overlap.
// - Padding: patch positions outside [0, H) x [0, W) hold zp_in, and the
//   sum is sum(x * w) - zp_in * sum(w) in int32 (exact: |sum| <= K * 255 *
//   128 < 2^31 for K < 65 536), so a padded tap adds nothing, as the
//   reference's padding with zp_in gives.  Each column's sum(w) is taken
//   from the B fragments in registers (__dp4a against ones) and summed by
//   shuffles: no shared-memory atomics, no extra barrier.
// - A cascade ring window is read in place: input row iy of the window is
//   ring row (src + iy) % ring_rows (a plain input: src 0, ring_rows H).
// - Where the patch and weights of the whole Cin would not fit ops.QC_SMEM
//   (96 KB; never on the path), Cin is cut into chunks of ck channels,
//   staged and multiplied in turn into the same accumulators.
//
// Interface: x and out are arena views, each lane contiguous, lanes x_bs /
// o_bs bytes apart (the batch stride is passed; no copy).  x holds
// ring_rows rows; the input is the H-row window starting at ring row src.
// w is a contiguous [k, k, Cin, Cout] int8 array.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, KSTEP = 32;
// words of the patch and bytes of the weights a thread loads before it
// stores them (the stem's 2.9 KB patch and 1 KB of weights are one batch
// each)
constexpr int PATCH_BATCH = 4, W_BATCH = 4;

// c += a . b for one 16x8x32 int8 tile (PTX ISA, mma.m16n8k32): lane 4g+t
// holds rows g and g+8, columns 2t and 2t+1 of c; a[0]/a[2] are row g,
// a[1]/a[3] row g+8, at k 4t..4t+3 and 16+4t..16+4t+3; b0/b1 column g at
// the same k.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Threads of a block: 4 warps over M (16 rows each) times BN / 16 warps
// over N (16 columns each; one warp row for BN <= 16).
__host__ __device__ constexpr int block_threads(int bn) {
  return 128 * (bn >= 32 ? bn / 16 : 1);
}

// The shared-memory layout of a block, the same on the host (the launch's
// dynamic size; ops.qconv_smem) and in the kernel: the patch of at most
// `rows` rows of `pitch` bytes (`cols` pixels of ck channels, rounded up
// to 16), the weight tile [BN][ldb] and the tap offsets [kpad].
struct QconvSmem {
  int rows, cols, pitch, kpad, ldb, weights_at, offs_at, total;
  __host__ __device__ QconvSmem(int OH, int OW, int k, int stride, int ck,
                                int bn) {
    rows = (imin(OH, (BM - 1) / OW + 2) - 1) * stride + k;
    cols = (OW - 1) * stride + k;
    pitch = (cols * ck + 15) / 16 * 16;
    kpad = (k * k * ck + KSTEP - 1) / KSTEP * KSTEP;
    ldb = kpad + 16;
    weights_at = rows * pitch;
    offs_at = weights_at + bn * ldb;
    total = offs_at + 4 * kpad;
  }
};

// x at column ix0 (which may be left of the image) of input row iy of the
// window, ring row (src + iy) % ring_rows; null outside [0, H)
__device__ __forceinline__ const int8_t* patch_row(
    const int8_t* xb, int iy, int H, int src, int ring_rows, int W, int ix0,
    int Cin, int c0) {
  if (iy < 0 || iy >= H) return nullptr;
  return xb + ((long long)((src + iy) % ring_rows) * W + ix0) * Cin + c0;
}

// The 4 bytes at p (any alignment) from the two aligned words that hold
// them; the caller guarantees that p and p + 3 are bytes of the tensor, so
// both words lie in its allocation.
__device__ __forceinline__ uint32_t load4(const int8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const uint32_t sh = a & 3;
  const uint32_t w0 = __ldg(wp), w1 = sh ? __ldg(wp + 1) : 0u;
  return __byte_perm(w0, w1, sh | (sh + 1) << 4 | (sh + 2) << 8 |
                                 (sh + 3) << 12);
}

template <int BN, class Epilogue>
__global__ void __launch_bounds__(block_threads(BN))
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             int8_t* __restrict__ out, int H, int ring_rows, int src, int W,
             int Cin, int Cout, int OH, int OW, int k, int stride,
             int pad_top, int pad_left, long long x_bs, long long o_bs,
             int zp_in, Epilogue ep, int ck) {
  constexpr int NT = block_threads(BN);
  constexpr int TN = BN >= 32 ? 16 : BN;       // a warp's columns
  constexpr int NJ = TN / 8;                   // its n8 tiles
  extern __shared__ __align__(16) int8_t smem[];
  const QconvSmem lay(OH, OW, k, stride, ck, BN);
  int8_t* patch = smem;
  int8_t* bs = smem + lay.weights_at;                         // [BN][ldb]
  int* offs = reinterpret_cast<int*>(smem + lay.offs_at);     // [kpad]

  const int M = OH * OW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = (warp / 4) * TN;              // the warp's first column
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long lane_i = blockIdx.z;
  const int8_t* xb = x + lane_i * x_bs;
  int8_t* ob = out + lane_i * o_bs;

  // the pixels this block's outputs read: output rows oy_a..oy_b, and the
  // columns of its outputs (all of them where it spans two rows or more)
  const int m_last = imin(M, m0 + BM) - 1;
  const int oy_a = m0 / OW, oy_b = m_last / OW;
  const int ox_lo = oy_a == oy_b ? m0 % OW : 0;
  const int ox_hi = oy_a == oy_b ? m_last % OW : OW - 1;
  const int rows_in = (oy_b - oy_a) * stride + k;
  const int cols_in = (ox_hi - ox_lo) * stride + k;
  const int iy0 = oy_a * stride - pad_top, ix0 = ox_lo * stride - pad_left;

  // the patch pixel (row, column) of each of this thread's two rows' first
  // tap (any valid pixel past M)
  const int ma = m0 + 16 * (warp % 4) + g, mb = ma + 8;
  const int ra = ma < M ? (ma / OW - oy_a) * stride : 0;
  const int ca = ma < M ? (ma % OW - ox_lo) * stride : 0;
  const int rb = mb < M ? (mb / OW - oy_a) * stride : 0;
  const int cb = mb < M ? (mb % OW - ox_lo) * stride : 0;

  int acc[NJ][4], csum[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    csum[j] = 0;
  }

  for (int c0 = 0; c0 < Cin; c0 += ck) {
    const int ckc = imin(ck, Cin - c0);
    const int kc = k * k * ckc, kcp = (kc + KSTEP - 1) / KSTEP * KSTEP;
    const int pitch = (cols_in * ckc + 15) / 16 * 16;
    __syncthreads();   // the previous chunk's tiles are no longer read
    // the weights, transposed: bs[n][kk] = w[tap][c0 + cl][n0 + n] for kk =
    // tap * ckc + cl < kc, 0 beyond (and past Cout); n fastest so that the
    // reads of w coalesce.  A thread's first W_BATCH bytes are loaded
    // before the patch, so that both are in flight together.
    const int n_w = kcp * BN;
    int8_t wv[W_BATCH];
    auto load_w = [&](int e0) {
#pragma unroll
      for (int i = 0; i < W_BATCH; ++i) {
        const int e = e0 + i * NT, kk = e / BN, n = e % BN;
        wv[i] = 0;
        if (e < n_w && kk < kc && n0 + n < Cout) {
          const int tap = kk / ckc, cl = kk - tap * ckc;
          wv[i] = __ldg(w + ((long long)tap * Cin + c0 + cl) * Cout + n0 + n);
        }
      }
    };
    auto store_w = [&](int e0) {
#pragma unroll
      for (int i = 0; i < W_BATCH; ++i) {
        const int e = e0 + i * NT;
        if (e < n_w) bs[(e % BN) * lay.ldb + e / BN] = wv[i];
      }
    };
    load_w(tid);
    // the patch [rows_in][pitch]: row r holds pixels ix0.. of input row
    // iy0 + r, ckc channels each, zp_in outside the input.  It goes in
    // 4-byte words (a patch row is contiguous in x where ckc == Cin; bytes
    // where it is not), PATCH_BATCH words a thread loaded before the first
    // is stored.
    const int wpr = pitch / 4, n_words = rows_in * wpr;
    const int lo_b = max(0, -ix0) * ckc, hi_b = min(cols_in, W - ix0) * ckc;
    const uint32_t zp4 = 0x01010101u * (uint32_t)(uint8_t)zp_in;
    for (int e0 = tid; e0 < n_words; e0 += PATCH_BATCH * NT) {
      uint32_t v[PATCH_BATCH];
#pragma unroll
      for (int i = 0; i < PATCH_BATCH; ++i) {
        const int e = e0 + i * NT, r = e / wpr, b = 4 * (e - r * wpr);
        const int8_t* rowp =
            e < n_words
                ? patch_row(xb, iy0 + r, H, src, ring_rows, W, ix0, Cin, c0)
                : nullptr;
        v[i] = zp4;
        if (rowp && ckc == Cin && b >= lo_b && b + 4 <= hi_b) {
          v[i] = load4(rowp + b);
        } else if (rowp) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int bq = b + q, col = bq / ckc;
            if (bq >= lo_b && bq < hi_b)
              v[i] = (v[i] & ~(0xffu << (8 * q))) |
                     (uint32_t)(uint8_t)__ldg(rowp + col * Cin + bq -
                                              col * ckc)
                         << (8 * q);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < PATCH_BATCH; ++i)
        if (e0 + i * NT < n_words)
          reinterpret_cast<uint32_t*>(patch)[e0 + i * NT] = v[i];
    }
    store_w(tid);
    for (int e0 = tid + W_BATCH * NT; e0 < n_w; e0 += W_BATCH * NT) {
      load_w(e0);
      store_w(e0);
    }
    // each K's offset from a pixel's first tap: dy patch rows, dx pixels
    // and cl channels; padding K reads offset 0 (its weight is 0)
    for (int kk = tid; kk < kcp; kk += NT) {
      int off = 0;
      if (kk < kc) {
        const int tap = kk / ckc, cl = kk - tap * ckc;
        off = (tap / k) * pitch + (tap % k) * ckc + cl;
      }
      offs[kk] = off;
    }
    __syncthreads();

    const int8_t* a_lo = patch + ra * pitch + ca * ckc;
    const int8_t* a_hi = patch + rb * pitch + cb * ckc;
    for (int ks = 0; ks < kcp; ks += KSTEP) {
      uint32_t a[4];
      if (ckc % 4 == 0) {   // 4 consecutive K: one tap, 4 channels
        const int o0 = offs[ks + 4 * t], o1 = offs[ks + 16 + 4 * t];
        a[0] = *reinterpret_cast<const uint32_t*>(a_lo + o0);
        a[1] = *reinterpret_cast<const uint32_t*>(a_hi + o0);
        a[2] = *reinterpret_cast<const uint32_t*>(a_lo + o1);
        a[3] = *reinterpret_cast<const uint32_t*>(a_hi + o1);
      } else {
        a[0] = a[1] = a[2] = a[3] = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o0 = offs[ks + 4 * t + i], o1 = offs[ks + 16 + 4 * t + i];
          a[0] |= (uint32_t)(uint8_t)a_lo[o0] << (8 * i);
          a[1] |= (uint32_t)(uint8_t)a_hi[o0] << (8 * i);
          a[2] |= (uint32_t)(uint8_t)a_lo[o1] << (8 * i);
          a[3] |= (uint32_t)(uint8_t)a_hi[o1] << (8 * i);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int8_t* bp = bs + (wn + 8 * j + g) * lay.ldb + ks + 4 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_s8(acc[j], a, b0, b1);
        // column wn + 8j + g's weights over this thread's 8 K of the step
        csum[j] = __dp4a((int)b0, 0x01010101,
                         __dp4a((int)b1, 0x01010101, csum[j]));
      }
    }
  }

  // each column's sum over all K: the 4 lanes 4g..4g+3 of column g hold
  // its 8-K parts; then each lane takes its columns 2t and 2t+1
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    csum[j] += __shfl_xor_sync(0xffffffffu, csum[j], 1);
    csum[j] += __shfl_xor_sync(0xffffffffu, csum[j], 2);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s0 = __shfl_sync(0xffffffffu, csum[j], 8 * t);
    const int s1 = __shfl_sync(0xffffffffu, csum[j], 8 * t + 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = e < 2 ? ma : mb;
      const int n = n0 + wn + 8 * j + 2 * t + (e & 1);
      if (m < M && n < Cout) {
        const long long idx = (long long)m * Cout + n;
        ob[idx] = ep(acc[j][e] - zp_in * ((e & 1) ? s1 : s0), lane_i, idx);
      }
    }
  }
}

template <int BN, class Epilogue>
int qconv_launch_bn(dim3 grid, size_t smem, cudaStream_t stream,
                    const int8_t* x, const int8_t* w, int8_t* out, int H,
                    int ring_rows, int src, int W, int Cin, int Cout, int OH,
                    int OW, int k, int stride, int pad_top, int pad_left,
                    long long x_bs, long long o_bs, int zp_in, Epilogue ep,
                    int ck) {
  auto kern = qconv_kernel<BN, Epilogue>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, block_threads(BN), smem, stream>>>(
      x, w, out, H, ring_rows, src, W, Cin, Cout, OH, OW, k, stride, pad_top,
      pad_left, x_bs, o_bs, zp_in, ep, ck);
  return (int)cudaGetLastError();
}

// bn: the N tile (8, 16, 32 or 64), ck: the Cin chunk (ops.plan_qconv).
template <class Epilogue>
int qconv_run(const void* x, const void* w, void* out, int B, int H,
              int ring_rows, int src, int W, int Cin, int Cout, int OH,
              int OW, int k, int stride, int pad_top, int pad_left,
              long long x_bs, long long o_bs, int zp_in, Epilogue ep, int bn,
              int ck, int device, void* stream) {
  if ((bn != 8 && bn != 16 && bn != 32 && bn != 64) || ck < 1 || ck > Cin ||
      src < 0 || src >= ring_rows || H < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const QconvSmem lay(OH, OW, k, stride, ck, bn);
  const size_t smem = (size_t)lay.total;
  dim3 grid((OH * OW + BM - 1) / BM, (Cout + bn - 1) / bn, B);
  const cudaStream_t s = (cudaStream_t)stream;
#define QCONV_ARGS                                                         \
  grid, smem, s, (const int8_t*)x, (const int8_t*)w, (int8_t*)out, H,     \
      ring_rows, src, W, Cin, Cout, OH, OW, k, stride, pad_top, pad_left, \
      x_bs, o_bs, zp_in, ep, ck
  if (bn == 8) return qconv_launch_bn<8>(QCONV_ARGS);
  if (bn == 16) return qconv_launch_bn<16>(QCONV_ARGS);
  if (bn == 32) return qconv_launch_bn<32>(QCONV_ARGS);
  return qconv_launch_bn<64>(QCONV_ARGS);
#undef QCONV_ARGS
}

}  // namespace
