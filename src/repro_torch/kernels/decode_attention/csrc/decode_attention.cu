// K8: single-token decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _decode_kernel): q [B,H,D] (one query row per head), caches
// [B,S,K,D] with H % K == 0 and kv head = h / (H/K), lengths [B] int32;
// cache rows >= lengths[b] are masked; scores (q * scale) . k, online
// softmax and the weighted sum of V in float32; out = acc / max(l, 1e-30)
// in q's type (float32 or bf16), [B,H,D].
//
// What bounds it on the H100: bytes.  A step reads each valid K and V row
// once (B 4, ~1 040 rows, 8 kv heads of 128 in bf16: ~17 MB, ~5 us at
// 3.35 TB/s) and does 4 * D flops per query head over the row's 4 * D
// bytes in bf16: G = H/K flops a byte, at most 16 (GLM-4-9B), below the
// ~20 a byte where float32 on the CUDA cores (67 TFLOP/s) would bound it.
// Reaching that rate takes every SM and tens of KB in flight on each.
//
// What the design does about it:
// - One cluster of `split` blocks per (batch row, kv head, chunk) serves
//   the chunk's query heads of that kv head, so each K/V row leaves device
//   memory once per chunk and step.  A kv head's G = H/K query heads fall
//   into `chunks` = ceil(G / 8) chunks of ceil or floor G / chunks heads
//   (ops.plan_chunks; GLM-4-9B's 16: 8 + 8), since a lane keeps every
//   head's accumulators in registers (the template's G, at most 8: ptxas
//   already reports up to 250 registers a thread at 8).  A group of 8 or
//   fewer is one chunk, and K/V rows leave device memory once per step.
//   `split` (<= 8, a portable cluster) is planned on the host from B,
//   K * chunks and the cache's capacity S (ops.plan_split), never from
//   `lengths`, which stays on the card: no host sync.  Block p of the
//   cluster takes rows [p * c, min(len, (p + 1) * c)) of the valid prefix,
//   c = ceil(len / split), len = lengths[b] read on the device; a block
//   whose share is empty keeps m = -1e30, l = 0, acc = 0 and merges with
//   weight 0 (flash-decoding).
// - A block streams its rows in tiles of 16 K and 16 V rows through a
//   ring of shared memory (4 stages in bf16, 2 in float32: 32 KB) filled
//   by 16-byte cp.async, three tiles (24 KB) in flight while one is
//   consumed.  The 16-byte path needs D * sizeof(T), every cache stride
//   and both cache pointers to be multiples of 16 bytes; the wrapper checks
//   that and otherwise launches the scalar path, which fills the same ring
//   with element loads.  Rows past the share and dims past D are zeroed.
// - Each half-warp is one row stream: lane j holds head dims 8j..8j+7
//   (16 lanes cover D = 128), two rows of each tile, and its own running
//   max, sum and accumulator per query head in registers.  At the end the
//   two half-warps of a warp merge by shuffles, the warps of a block in
//   shared memory, and after a cluster barrier the blocks of the cluster
//   from each other's shared memory (distributed shared memory), each
//   merge in a fixed order, rescaled to the common max, as the in-block
//   merge of the first version did.  One launch, no workspace.
//
// lengths[b] >= 1 is the contract (the model never passes 0).  A length of
// 0 (or less) streams no row and returns zeros; the TPU kernel would
// return the mean of every V row there.  Lengths above S are clamped to S.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 4, THREADS = 32 * NW, HALVES = 2 * NW;
constexpr int DMAX = 128, EPL = 8;        // head dims; 8 per half-warp lane
constexpr int TR = 16, RPH = TR / HALVES; // rows per tile, per half-warp
constexpr int RING_BYTES = 32768, MAX_SPLIT = 8;
constexpr float MASKED = -1e30f;          // the TPU kernel's NEG_INF

template <typename T>
struct Ring {
  static constexpr int ROW = DMAX * (int)sizeof(T);  // bytes per cached row
  static constexpr int TILE = 2 * TR * ROW;          // K rows, then V rows
  static constexpr int STAGES = RING_BYTES / TILE;   // bf16 4, float32 2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// 8 consecutive elements of a shared-memory row, as float
__device__ __forceinline__ void load8(const float* p, float (&v)[EPL]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[EPL]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
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

template <typename T, int G, bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int S, int D, int chunks, long long q_bs,
                        long long q_hs,
                        long long k_bs, long long k_ss, long long k_hs,
                        long long v_bs, long long v_ss, long long v_hs,
                        float scale) {
  using R = Ring<T>;
  // the K/V ring; after the loop, the warps' partial accumulators
  // [NW][G][DMAX] and the block's merged one [G][DMAX] (float)
  __shared__ __align__(16) unsigned char ring[RING_BYTES];
  static_assert((NW + 1) * G * DMAX * 4 <= RING_BYTES, "merge space");
  __shared__ float part_m[NW][G], part_l[NW][G];
  __shared__ float blk_m[G], blk_l[G];

  const int split = gridDim.x, rank = blockIdx.x;
  const int kvh = blockIdx.y / chunks, chunk = blockIdx.y % chunks;
  const int b = blockIdx.z;
  // this chunk's query heads h0 .. h0 + gn - 1 (gn <= G) of the kv head's
  // group of H / K; heads gn .. G - 1 of the registers stay unused
  const int group = H / (gridDim.y / chunks);
  const int c0 = chunk * group / chunks, c1 = (chunk + 1) * group / chunks;
  const int h0 = kvh * group + c0, gn = c1 - c0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int half = tid / 16, j = tid % 16;
  const int len = max(0, min(lengths[b], S));
  const int share = (len + split - 1) / split;
  const int row0 = min(len, rank * share), row1 = min(len, row0 + share);
  const int tiles = (row1 - row0 + TR - 1) / TR;
  const T* kb = kc + b * k_bs + kvh * k_hs;
  const T* vb = vc + b * v_bs + kvh * v_hs;

  // tile t of this block's rows into ring slot t % STAGES; always commits
  // a group (empty past the end), so the waits count evenly
  auto load = [&](int t) {
    if (t < tiles) {
      unsigned char* dst = ring + (t % R::STAGES) * R::TILE;
      const int r0 = row0 + t * TR;
      if (VEC) {
        constexpr int CPR = R::ROW / 16;                // 16-byte chunks
        const int cpr = D * (int)sizeof(T) / 16;        // ... of the row
        constexpr int PER = 16 / (int)sizeof(T);        // elements a chunk
#pragma unroll
        for (int i = 0; i < 2 * TR * CPR / THREADS; ++i) {
          const int e = tid + THREADS * i;
          const int kv = e / (TR * CPR), r = (e / CPR) % TR, c = e % CPR;
          const int row = r0 + r;
          const bool in = row < row1 && c < cpr;
          const T* src = kv ? vb + (long long)row * v_ss
                            : kb + (long long)row * k_ss;
          cp_async16(dst + e * 16, in ? src + c * PER : kb, in);
        }
      } else {
        T* d = reinterpret_cast<T*>(dst);
        for (int e = tid; e < 2 * TR * DMAX; e += THREADS) {
          const int kv = e / (TR * DMAX), r = (e / DMAX) % TR, c = e % DMAX;
          const int row = r0 + r;
          T val = zero<T>();
          if (row < row1 && c < D)
            val = kv ? vb[(long long)row * v_ss + c]
                     : kb[(long long)row * k_ss + c];
          d[e] = val;
        }
      }
    }
    cp_async_commit();
  };

  // the first tiles go out before q is read
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) load(s);
  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qg = q + b * q_bs + (long long)(h0 + g) * q_hs;
    m[g] = MASKED;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = EPL * j + e;
      qr[g][e] = d < D && g < gn ? __fmul_rn(to_f32(qg[d]), scale) : 0.0f;
      acc[g][e] = 0.0f;
    }
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<R::STAGES - 2>();   // tile t has landed
    __syncthreads();                  // ... for every thread; slot t-1 free
    load(t + R::STAGES - 1);
    const T* ks = reinterpret_cast<const T*>(ring + (t % R::STAGES) * R::TILE);
    const T* vs = ks + TR * DMAX;
    const int r0 = row0 + t * TR + half * RPH;
    float kx[RPH][EPL], vx[RPH][EPL];
#pragma unroll
    for (int rr = 0; rr < RPH; ++rr) {
      load8(ks + (half * RPH + rr) * DMAX + EPL * j, kx[rr]);
      load8(vs + (half * RPH + rr) * DMAX + EPL * j, vx[rr]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[RPH];
      float mx = -INFINITY;
#pragma unroll
      for (int rr = 0; rr < RPH; ++rr) {
        float p = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) p = fmaf(qr[g][e], kx[rr][e], p);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)   // the 16 lanes of this half-warp
          p += __shfl_xor_sync(0xffffffffu, p, o);
        s[rr] = r0 + rr < row1 ? p : -INFINITY;   // past the share: p = 0
        mx = fmaxf(mx, s[rr]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int rr = 0; rr < RPH; ++rr) {
        const float p = expf(s[rr] - m_new);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p, vx[rr][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring's bytes are free

  // the two half-warps of each warp (lanes j and j + 16 hold the same dims)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
    const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
    const float mx = fmaxf(m[g], mo);
    const float c = expf(m[g] - mx), co = expf(mo - mx);
    l[g] = __fadd_rn(__fmul_rn(l[g], c), __fmul_rn(lo, co));
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
      acc[g][e] = __fadd_rn(__fmul_rn(acc[g][e], c), __fmul_rn(ao, co));
    }
    m[g] = mx;
  }
  float* part_acc = reinterpret_cast<float*>(ring);      // [NW][G][DMAX]
  float* blk_acc = part_acc + NW * G * DMAX;              // [G][DMAX]
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        part_acc[(warp * G + g) * DMAX + EPL * j + e] = acc[g][e];
      if (lane == 0) {
        part_m[warp][g] = m[g];
        part_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's warps, in warp order
  for (int e = tid; e < G * DMAX; e += THREADS) {
    const int g = e / DMAX;
    float mx = MASKED;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, part_m[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(part_m[w][g] - mx);
      den = fmaf(part_l[w][g], c, den);
      num = fmaf(part_acc[w * G * DMAX + e], c, num);
    }
    blk_acc[e] = num;
    if (e % DMAX == 0) {
      blk_m[g] = mx;
      blk_l[g] = den;
    }
  }

  // the cluster's blocks, in block order; block `rank` writes outputs
  // rank, rank + split, ... (in steps of THREADS)
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  for (int e = rank * THREADS + tid; e < gn * D; e += split * THREADS) {
    const int g = e / D, d = e % D;
    float pm[MAX_SPLIT], pl[MAX_SPLIT], pa[MAX_SPLIT];
#pragma unroll
    for (int p = 0; p < MAX_SPLIT; ++p)
      if (p < split) {
        const unsigned r = (unsigned)p;
        pm[p] = split > 1 ? *cluster.map_shared_rank(&blk_m[g], r) : blk_m[g];
        pl[p] = split > 1 ? *cluster.map_shared_rank(&blk_l[g], r) : blk_l[g];
        pa[p] = split > 1 ? *cluster.map_shared_rank(&blk_acc[g * DMAX + d], r)
                          : blk_acc[g * DMAX + d];
      }
    float mx = MASKED;
#pragma unroll
    for (int p = 0; p < MAX_SPLIT; ++p)
      if (p < split) mx = fmaxf(mx, pm[p]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int p = 0; p < MAX_SPLIT; ++p)
      if (p < split) {
        const float c = expf(pm[p] - mx);
        den = fmaf(pl[p], c, den);
        num = fmaf(pa[p], c, num);
      }
    store(out + ((long long)b * H + h0 + g) * D + d,
          num / fmaxf(den, 1e-30f));
  }
  if (split > 1) cluster.sync();   // no block leaves while another reads it
}

template <typename T, int G, bool VEC>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int H, int K, int S, int D, int chunks,
           long long q_bs, long long q_hs, long long k_bs, long long k_ss,
           long long k_hs, long long v_bs, long long v_ss, long long v_hs,
           float scale, int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, K * chunks, B);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, G, VEC>, (const T*)q, (const T*)k,
      (const T*)v, (const int*)lengths, (T*)out, H, S, D, chunks, q_bs,
      q_hs, k_bs, k_ss, k_hs, v_bs, v_ss, v_hs, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the template's G: the largest chunk's heads, ceil((H / K) / chunks)
template <typename T, bool VEC>
int launch_groups(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int B, int H, int K, int S,
                  int D, int chunks, long long q_bs, long long q_hs,
                  long long k_bs, long long k_ss, long long k_hs,
                  long long v_bs, long long v_ss, long long v_hs, float scale,
                  int split, cudaStream_t s) {
#define K8_CASE(G)                                                          \
  case G:                                                                  \
    return launch<T, G, VEC>(q, k, v, lengths, out, B, H, K, S, D, chunks, \
                             q_bs, q_hs, k_bs, k_ss, k_hs, v_bs, v_ss,     \
                             v_hs, scale, split, s);
  switch ((H / K + chunks - 1) / chunks) {
    K8_CASE(1)
    K8_CASE(2)
    K8_CASE(3)
    K8_CASE(4)
    K8_CASE(5)
    K8_CASE(6)
    K8_CASE(7)
    K8_CASE(8)
    default:
      break;
  }
#undef K8_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_path(int vec, const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int H, int K, int S,
                int D, int chunks, long long q_bs, long long q_hs,
                long long k_bs, long long k_ss, long long k_hs,
                long long v_bs, long long v_ss, long long v_hs, float scale,
                int split, cudaStream_t s) {
  if (vec)
    return launch_groups<T, true>(q, k, v, lengths, out, B, H, K, S, D,
                                  chunks, q_bs, q_hs, k_bs, k_ss, k_hs, v_bs,
                                  v_ss, v_hs, scale, split, s);
  return launch_groups<T, false>(q, k, v, lengths, out, B, H, K, S, D,
                                 chunks, q_bs, q_hs, k_bs, k_ss, k_hs, v_bs,
                                 v_ss, v_hs, scale, split, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the head
// dimension is contiguous.  lengths is an int32 device array [B]; out a
// contiguous [B, H, D] array.  chunks splits each kv head's H/K query
// heads into that many clusters of at most 8 heads (ops.plan_chunks);
// split (1..8) is the cluster size (ops.plan_split); vec != 0 takes the
// 16-byte path, which the caller has checked the caches' pointers,
// strides and D allow.  Returns a cudaError_t (cudaErrorInvalidValue for
// D outside 1..128, H not a multiple of K, chunks outside 1..H/K or
// leaving a chunk more than 8 heads, K * chunks or B above 65535, or split
// outside 1..8).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int K, int S, int D, long long q_bs,
    long long q_hs, long long k_bs, long long k_ss, long long k_hs,
    long long v_bs, long long v_ss, long long v_hs, float scale, int dtype,
    int chunks, int split, int vec, int device, void* stream) {
  if (D < 1 || D > DMAX || K < 1 || H < K || H % K != 0 || chunks < 1 ||
      chunks > H / K || (H / K + chunks - 1) / chunks > 8 ||
      (long long)K * chunks > 65535 || B > 65535 || split < 1 ||
      split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_path<float>(vec, q, k, v, lengths, out, B, H, K, S, D,
                              chunks, q_bs, q_hs, k_bs, k_ss, k_hs, v_bs,
                              v_ss, v_hs, scale, split, s);
  if (dtype == 1)
    return launch_path<__nv_bfloat16>(vec, q, k, v, lengths, out, B, H, K, S,
                                      D, chunks, q_bs, q_hs, k_bs, k_ss, k_hs,
                                      v_bs, v_ss, v_hs, scale, split, s);
  return (int)cudaErrorInvalidValue;
}
