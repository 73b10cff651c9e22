// K7: flash-attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_kernel): q [B,Sq,H,D], k/v [B,Skv,K,D] with H % K == 0 and
// kv head = h / (H/K) (GQA); scores scale * (q . k) in float32; with
// `causal`, key j is masked for query row i when j > i + (Skv - Sq), and
// with a sliding `window` W > 0 (causal only) also when j <= i + (Skv -
// Sq) - W, to -1e30 (the model's window, repro/models/layers.py:108-109,
// under the same query offset); running max m, denominator l and
// accumulator acc in float32; out = acc / max(l, 1e-30) in q's type
// (float32 or bf16).
//
// What bounds it on the H100: at the prefill of Llama-3.2-3B (B 4, S 1024,
// 24 heads of 128, causal) a call does ~25.8 GFLOP of products on ~67 MB,
// so the roofline bound is the tensor cores' (~26 us at 989 TFLOP/s bf16).
//
// What the design does about it.  Two bodies, chosen by the input type:
//
// * bfloat16 (the model's type): warpgroup tensor cores, wgmma (bf16 in,
//   f32 accumulate), asynchronous, run by a warpgroup of 128 threads.
//   - One block of 2 warpgroups per (128 query rows, batch x head), each
//     warpgroup 64 rows (each of its warps 16).  Q and the K/V tiles sit
//     in shared memory in the 128-byte-swizzled layout wgmma reads through
//     descriptors.  S = Q K^T is m64n64k16 with both operands from shared
//     memory (K-major); P V is m64n64k16 with P from registers (the score
//     accumulators re-packed as A fragments) and V read MN-major from the
//     same tile bytes, 64 head dims at a time.  K and V are read once per
//     warpgroup, not once per warp as with mma.sync and ldmatrix (an
//     earlier version of this body, slower; PERF.md has both times).
//   - S = q . k on the raw bf16 q and k (the products are exact in f32);
//     the f32 scores are multiplied by scale * log2(e) afterwards (p =
//     exp2(x - m)), never q * scale rounded to bf16.
//   - P.V keeps P's low bits: P = hi + mid + lo, three bf16 parts (hi =
//     bf16(P), mid = bf16(P - hi), lo = bf16(P - hi - mid)), all three
//     products summed in f32: 2x the tensor-core work of FlashAttention-2.
//     With P rounded once to bf16, as FlashAttention-2 does, ~12 % of the
//     outputs leave the check's bound (one bf16 ulp of the plain version +
//     1e-6 * max); with hi + mid, P keeps ~2^-18 relative and outputs near
//     zero of a long non-causal row can still leave it (1 of 768 000 in
//     the CPU emulation of tests/test_torch_flash_attention.py); with three
//     parts P's error is under float32's own rounding.  For the same
//     reason each tile's P.V is summed from zero on the tensor cores (small
//     partial sums) and then added to the rescaled accumulator in f32.
//     The online softmax (m, l, alpha) stays in f32 registers; the row sum
//     l is taken from the f32 P.
//   - Key/value tiles of 64 rows are staged with 16-byte cp.async copies
//     in a ring of two stages: tile j+1 loads while tile j multiplies (a
//     third stage, to run the next tile's Q K^T during this tile's
//     softmax, was slower).  q/k/v are read in place through their strides
//     (the model passes slices of one projection); when a pointer or
//     stride is not 16-byte aligned, or D % 8 != 0, plain loads fill the
//     same tiles.
//   - D is padded with zeros in shared memory up to DP = 64 or 128 (exact:
//     zero columns add nothing to q . k, and output columns >= D are not
//     stored), so any D <= 128 is taken.  Rows past Sq / Skv are zero-
//     filled; keys past Skv get p = 0.
//   - Causal: key tiles wholly above the block's diagonal are not loaded,
//     a warpgroup skips the products of a tile wholly above its 64 rows,
//     and the mask is applied only on tiles that straddle the diagonal or
//     the end of the keys.  Blocks are launched heaviest query tile first
//     (the query tile is blockIdx.y reversed, the slowest grid axis), so
//     the short tiles fill the tail.
//   - Window: the block's key loop starts at the tile of its first row's
//     oldest key, max(0, q0 + off - W + 1) rounded down to a key tile;
//     tiles below it are neither loaded nor multiplied.  A warpgroup skips
//     a tile wholly below its 64 rows' windows, and a warp masks a tile
//     that reaches into its 16 rows' windows from below, so with a short
//     window both edges can fall in one tile.  A row meets tiles of
//     masked keys before its own keys (the rows after the block's first):
//     their p = 1 terms are wiped by alpha = exp2(-1e30 - m) = 0 at its
//     first unmasked key, which every row has (its own).  With W >= Skv
//     the loop and the unmasked scores are causal's, bit for bit.
//   Registers and spills: `-Xptxas -v`, printed by chip_smoke.py's build
//   phase and recorded in PERF.md.
//
// * float32 (reached only by tests and the hostile checks): the first,
//   CUDA-core body of the port.  One block of 256 threads per (64 query
//   rows, batch x head), 32-key tiles staged in shared memory as float32,
//   (q * scale) . k with fmaf, online softmax in registers; the window's
//   key range and mask as in the bf16 body.  It holds the 2e-5 * max
//   bound; a 3xTF32 tensor-core body is later work.
//
// Rows without any valid key (only with `causal` and Sq > Skv) are outside
// the contract: the reference's plain version gives NaN there.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float MASKED = -1e30f;     // the TPU kernel's NEG_INF

// ------------------------------------------------- float32: CUDA cores
namespace f32 {

constexpr int BQ = 64, BK = 32, THREADS = 256;
constexpr int KST = BK + 2;          // K^T row stride: float2-aligned, few
                                     // bank conflicts on the staging stores
constexpr int PST = BQ + 4;          // P^T row stride: float4-aligned

template <int DJ>
constexpr size_t smem_floats() {
  // Qs [DM][BQ] (swizzled Q^T), Ks [DM][KST], Vs [BK][DM], Ps [BK][PST]
  return (size_t)16 * DJ * BQ + 16 * DJ * KST + BK * 16 * DJ + BK * PST;
}

// Q^T is stored [d][row] with its 16 groups of 4 rows XOR-swizzled by
// d % 16: a thread's 4 rows stay one aligned float4, and the staging
// stores (consecutive d, same row) spread over 8 banks instead of one.
__device__ __forceinline__ int qs_index(int d, int r) {
  return d * BQ + ((((r >> 2) ^ (d & 15)) << 2) | (r & 3));
}

// Thread (ty, tx), ty, tx in 0..15, owns rows 4ty..4ty+3 of the tile: the
// scores of keys 2tx, 2tx+1 and the output columns DJ*tx..DJ*tx+DJ-1 (DJ =
// 4 for D <= 64, 8 for D <= 128).  Row max and row sum are reduced over
// the 16 lanes of a half-warp that share ty.
template <int DJ>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, int H,
       int groups, int Sq, int Skv, int D, long long q_bs, long long q_ss,
       long long q_hs, long long k_bs, long long k_ss, long long k_hs,
       long long v_bs, long long v_ss, long long v_hs, float scale,
       int causal, int window) {
  constexpr int DM = 16 * DJ;        // head dims this instantiation holds
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + DM * BQ;
  float* Vs = Ks + DM * KST;
  float* Ps = Vs + BK * DM;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / groups;
  const int q_offset = Skv - Sq;     // queries are the last Sq positions
  const float* qb = q + b * q_bs + h * q_hs;
  const float* kb = k + b * k_bs + kvh * k_hs;
  const float* vb = v + b * v_bs + kvh * v_hs;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[qs_index(d, r)] =
        q0 + r < Sq ? __fmul_rn(qb[(long long)(q0 + r) * q_ss + d], scale)
                    : 0.0f;
  }

  float acc[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int kv_end = Skv;
  if (causal) {   // keys past the tile's last row are masked in every row
    const int last_row = q_offset + min(q0 + BQ, Sq) - 1;
    kv_end = min(Skv, last_row + 1);
  }
  // keys below the first row's window are masked in every row
  const int kv_begin =
      window > 0 ? max(0, q_offset + q0 - window + 1) / BK * BK : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();   // Q staged; the previous tile's Ps/Vs fully read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = kv0 + c < Skv;
      Ks[d * KST + c] = in ? kb[(long long)(kv0 + c) * k_ss + d] : 0.0f;
      Vs[c * DM + d] = in ? vb[(long long)(kv0 + c) * v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(
          &Qs[d * BQ + ((ty ^ (d & 15)) << 2)]);
      const float2 kk = *reinterpret_cast<const float2*>(&Ks[d * KST + 2 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(av[i], kk.x, s[i][0]);
        s[i][1] = fmaf(av[i], kk.y, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = kv0 + 2 * tx + j;
        if (col >= Skv)
          s[i][j] = -INFINITY;       // not a key: p = 0
        else if ((causal && col > row) || (window > 0 && col <= row - window))
          s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) Ps[(2 * tx + j) * PST + 4 * ty + i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * PST + 4 * ty]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&Vs[c * DM + DJ * tx + j]);
        vv[j] = t.x;
        vv[j + 1] = t.y;
        vv[j + 2] = t.z;
        vv[j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* ob = out + (((long long)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = DJ * tx + j;
      if (d < D) ob[d] = acc[i][j] / den;
    }
  }
}

template <int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int D, const long long* st,
           float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats<DJ>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel<DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<DJ><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, H,
      H / K, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace f32

// -------------------------------------- bfloat16: tensor cores (wgmma)
namespace bf16 {

using T = __nv_bfloat16;
constexpr int BQ = 128, BKV = 64, THREADS = 256;   // 2 warpgroups x 64 rows
constexpr float LOG2E = 1.4426950408889634f;

// Tiles in shared memory in the 128-byte-swizzled layout wgmma reads: the
// head dims are cut into column blocks of 64 (128 bytes a row); block b of
// a tile of R rows holds rows 0..R-1 at 128 bytes each, the 16-byte chunk
// c of row r stored at chunk c ^ (r % 8).  Q and K are read K-major (d
// contiguous); the same bytes of V are read MN-major.  Q [BQ], then the K
// and V rings [2][BKV], each tile 1024-byte aligned.
template <int DP>
struct Layout {
  static constexpr int Q = BQ * DP * 2, KV = BKV * DP * 2;   // bytes
  static constexpr size_t bytes = (size_t)Q + 4 * KV + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `valid` false the destination is zero-
// filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) as three bf16 pairs hi + mid + lo: hi = bf16(p), mid = bf16(p -
// hi), lo = bf16(p - hi - mid).  Each difference is exact in float32, so
// the three hold p to ~2^-27 relative (hi + mid alone: ~2^-18).
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = p0 - hf.x, r1 = p1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

__device__ __forceinline__ uint32_t swz(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// A wgmma shared-memory descriptor: 128-byte swizzle, byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// what threads wrote to shared memory becomes visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a . b for m64n64k16: A (64 x 16) and B (16 x 64) from shared
// memory, both K-major with the 128-byte swizzle; scale_d 0 starts d from
// zero.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with A from registers (warp w of the warpgroup holds rows
// 16w..16w+15 as the m16n8k16 A fragment: the layout of its accumulator
// rows) and B read MN-major (transposed) from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Rows [row0, row0 + rows) of a strided [*, D] bf16 array into a swizzled
// tile of `rows` rows; rows at or past `valid` are zero.  `vec`: 16-byte
// cp.async copies (asynchronous: the caller commits and waits); otherwise
// plain element stores.
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          long long stride, int row0,
                                          int rows, int valid, int D,
                                          bool vec) {
  if (vec) {
    const int chunks = D / 8;
    for (int e = threadIdx.x; e < rows * chunks; e += THREADS) {
      const int r = e / chunks, c = e - r * chunks;
      const bool in = row0 + r < valid;
      const T* s = in ? src + (long long)(row0 + r) * stride + 8 * c : src;
      cp_async16(smem_addr(dst + swz(r, 8 * c, rows)), s, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      *reinterpret_cast<T*>(dst + swz(r, c, rows)) =
          row0 + r < valid ? src[(long long)(row0 + r) * stride + c]
                           : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ void zero_pad(unsigned char* tile, int rows,
                                         int D, int DP) {
  const int pad = DP - D;
  for (int e = threadIdx.x; e < rows * pad; e += THREADS)
    *reinterpret_cast<T*>(tile + swz(e / pad, D + e % pad, rows)) =
        __float2bfloat16_rn(0.0f);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out, int H, int groups,
       int Sq, int Skv, int D, long long q_bs, long long q_ss, long long q_hs,
       long long k_bs, long long k_ss, long long k_hs, long long v_bs,
       long long v_ss, long long v_hs, float scale, int causal, int window,
       int vec) {
  using L = Layout<DP>;
  constexpr int KSTEPS = DP / 16, NS = BKV / 8, NO = DP / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Ks = Qs + L::Q;
  unsigned char* Vs = Ks + 2 * L::KV;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, grp = warp / 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / groups;
  const int off = Skv - Sq;
  const int g0 = q0 + 64 * grp;      // the warpgroup's first query row
  const int w0 = q0 + 16 * warp;     // the warp's first query row
  const float scale_log2 = scale * LOG2E;
  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + kvh * k_hs;
  const T* vb = v + b * v_bs + kvh * v_hs;

  if (D < DP) {
    zero_pad(Qs, BQ, D, DP);
    for (int i = 0; i < 4; ++i) zero_pad(Ks + i * L::KV, BKV, D, DP);
  }
  // the key tiles some row of the block sees: from the tile of the first
  // row's oldest key (window) to the last row's newest (causal)
  const int kv_end = causal ? min(Skv, off + min(q0 + BQ, Sq)) : Skv;
  const int kv_begin =
      window > 0 ? max(0, q0 + off - window + 1) / BKV * BKV : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  load_rows(Qs, qb, q_ss, q0, BQ, Sq, D, vec);
  if (n_tiles > 0) {
    load_rows(Ks, kb, k_ss, kv_begin, BKV, Skv, D, vec);
    load_rows(Vs, vb, v_ss, kv_begin, BKV, Skv, D, vec);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_addr = smem_addr(Qs) + 64 * grp * 128;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};   // rows g, g + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = kv_begin + j * BKV;
    if (j + 1 < n_tiles) {
      const int nxt = (j + 1) & 1;
      load_rows(Ks + nxt * L::KV, kb, k_ss, kv0 + BKV, BKV, Skv, D, vec);
      load_rows(Vs + nxt * L::KV, vb, v_ss, kv0 + BKV, BKV, Skv, D, vec);
      cp_async_commit();
    }
    const uint32_t k_addr = smem_addr(Ks + (j & 1) * L::KV);
    const uint32_t v_addr = smem_addr(Vs + (j & 1) * L::KV);
    // the warpgroup's 64 rows all past Sq, all above the tile's first key,
    // or the tile's last key below all their windows: nothing to add
    // (uniform over the warpgroup, as wgmma needs)
    const bool active = g0 < Sq && !(causal && kv0 > off + g0 + 63) &&
                        !(window > 0 && kv0 + BKV - 1 <= off + g0 - window);
    if (active) {
      // S = Q K^T: 64 x 64 per warpgroup, K-steps of 16 head dims.  Step
      // kk starts 32 bytes into 64-dim column block kk / 4 (the hardware
      // applies the swizzle to the full address); SBO 1024 = 8 rows, LBO
      // unused for K-major with this swizzle
      float s[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t cb = (kk >> 2), kb16 = (kk & 3) * 32;
        wgmma_ss(s, desc(q_addr + cb * BQ * 128 + kb16, 16, 1024),
                 desc(k_addr + cb * BKV * 128 + kb16, 16, 1024), kk > 0);
      }
      wg_commit_wait();
      fence_regs(s);

      const bool edge = kv0 + BKV > Skv ||
                        (causal && kv0 + BKV - 1 > off + w0) ||
                        (window > 0 && kv0 <= off + w0 + 15 - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * n + e] * scale_log2;
          if (edge) {
            const int col = kv0 + 8 * n + 2 * t + (e & 1);
            const int row = w0 + g + (e >> 1) * 8;
            if (col >= Skv)
              x = -INFINITY;
            else if ((causal && col > row + off) ||
                     (window > 0 && col <= row + off - window))
              x = MASKED;
          }
          s[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      uint32_t pf[BKV / 16][3][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * n + e] - m[e >> 1]);
          s[4 * n + e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3(s[4 * (2 * c + (r >> 1)) + 2 * (r & 1)],
                       s[4 * (2 * c + (r >> 1)) + 2 * (r & 1) + 1],
                       pf[c][0][r], pf[c][1][r], pf[c][2][r]);

      // o = alpha * o + P . V, 64 head dims at a time: the tile's 64 keys
      // summed from zero on the tensor cores, then added in float32
#pragma unroll
      for (int half = 0; half < DP / 64; ++half) {
        float f[32];
        wg_fence();
#pragma unroll
        for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
          for (int part = 2; part >= 0; --part)     // smallest first
            wgmma_rs(f, pf[c][part],       // keys 16c..: SBO 1024 = 8 keys
                     desc(v_addr + half * BKV * 128 + 16 * c * 128,
                          BKV * 128, 1024),
                     c > 0 || part < 2);
        wg_commit_wait();
        fence_regs(f);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* on = o[8 * half + n];
          on[0] = on[0] * alpha[0] + f[4 * n];
          on[1] = on[1] * alpha[0] + f[4 * n + 1];
          on[2] = on[2] * alpha[1] + f[4 * n + 2];
          on[3] = on[3] * alpha[1] + f[4 * n + 3];
        }
      }
    }
    cp_async_wait_all();   // tile j + 1 has landed ...
    fence_async_smem();
    __syncthreads();             // ... and every warp is done with tile j
  }

  // out = o / max(l, 1e-30), staged in the (now free) K/V rings, plain
  // rows of DP + 8, so that rows leave in 16-byte stores
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-30f);
  }
  constexpr int LD = DP + 8;
  T* Ow = reinterpret_cast<T*>(Ks) + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * LD + 8 * n + 2 * t) =
        __floats2bfloat162_rn(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * LD + 8 * n + 2 * t) =
        __floats2bfloat162_rn(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  const long long row_stride = (long long)H * D;
  T* ob = out + ((long long)b * Sq * H + h) * D;
  if (vec) {
    const int chunks = D / 8;
    for (int e = lane; e < 16 * chunks; e += 32) {
      const int r = e / chunks, c = e - r * chunks;
      if (w0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + (w0 + r) * row_stride + 8 * c) =
            *reinterpret_cast<const uint4*>(Ow + r * LD + 8 * c);
    }
  } else {
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D, c = e - r * D;
      if (w0 + r < Sq) ob[(w0 + r) * row_stride + c] = Ow[r * LD + c];
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int D, const long long* st,
           float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const void* ptrs[4] = {q, k, v, out};
  bool vec = D % 8 == 0;
  for (int i = 0; i < 4; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<DP><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, H / K, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window, (int)vec);
  return (int)cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the head
// dimension is contiguous.  out is a contiguous [B, Sq, H, D] array.
// window: 0 for none, else W > 0 with causal.  Returns a cudaError_t
// (cudaErrorInvalidValue for D outside 1..128 or a window without causal).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int D, long long q_bs, long long q_ss,
    long long q_hs, long long k_bs, long long k_ss, long long k_hs,
    long long v_bs, long long v_ss, long long v_hs, float scale, int causal,
    int window, int dtype, int device, void* stream) {
  if (D < 1 || D > 128 || K < 1 || H % K != 0 || B * H > 65535 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long st[9] = {q_bs, q_ss, q_hs, k_bs, k_ss, k_hs,
                           v_bs, v_ss, v_hs};
  if (dtype == 0)
    return D <= 64 ? f32::launch<4>(q, k, v, out, B, H, K, Sq, Skv, D, st,
                                    scale, causal, window, s)
                   : f32::launch<8>(q, k, v, out, B, H, K, Sq, Skv, D, st,
                                    scale, causal, window, s);
  if (dtype == 1)
    return D <= 64 ? bf16::launch<64>(q, k, v, out, B, H, K, Sq, Skv, D, st,
                                      scale, causal, window, s)
                   : bf16::launch<128>(q, k, v, out, B, H, K, Sq, Skv, D, st,
                                       scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
