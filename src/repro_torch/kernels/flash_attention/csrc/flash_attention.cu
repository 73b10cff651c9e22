// K7: flash-attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_kernel): q [B,Sq,H,D], k/v [B,Skv,K,D] with H % K == 0 and
// kv head = h / (H/K) (GQA); scores (q * scale) . k in float32; with
// `causal`, key j is masked for query row i when j > i + (Skv - Sq), to
// -1e30; running max m, denominator l and accumulator acc in float32;
// out = acc / max(l, 1e-30) in q's type (float32 or bf16).
//
// What bounds it on the H100: at the prefill of Llama-3.2-3B (B 4, S 1024,
// 24 heads of 128, causal) a call does ~25.8 GFLOP of products on ~67 MB,
// so the roofline bound is the tensor cores' (~26 us at 989 TFLOP/s bf16).
// What the design does about it: not yet that.  This first kernel is
// plain float32 FMA on the CUDA cores (67 TFLOP/s peak), so it lands
// several times above the bound; mma/wgmma on bf16 tiles with TMA loads
// is later work.  What it does do: it keeps the S x S scores out of device
// memory (one pass over K/V per query tile, online softmax in registers),
// it reads q/k/v in place through their strides (no transposed copy, as
// the TPU wrapper makes), and with `causal` it skips key tiles that lie
// wholly above the diagonal (those keys get p = 0 in every row of the
// tile that has a valid key, so the result is the same).
//
// Structure: one block of 256 threads per (tile of BQ = 64 query rows,
// batch x query head).  The TPU grid's sequential kv axis is a loop inside
// the block over tiles of BK = 32 keys staged in shared memory as float32.
// Thread (ty, tx), ty, tx in 0..15, owns rows 4ty..4ty+3 of the tile: the
// scores of keys 2tx, 2tx+1 and the output columns DJ*tx..DJ*tx+DJ-1
// (DJ = 4 for D <= 64, 8 for D <= 128).  Row max and row sum are reduced
// over the 16 lanes of a half-warp that share ty.  Ragged edges (Sq, Skv
// not multiples of the tiles) are masked by bounds tests: a key past Skv
// gets p = 0, a query row past Sq is computed on zeros and not stored.
//
// Rows without any valid key (only with `causal` and Sq > Skv) are outside
// the contract: the reference's plain version gives NaN there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 32, THREADS = 256;
constexpr int KST = BK + 2;          // K^T row stride: float2-aligned, few
                                     // bank conflicts on the staging stores
constexpr int PST = BQ + 4;          // P^T row stride: float4-aligned
constexpr float MASKED = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int groups, int Sq, int Skv, int D, long long q_bs,
                       long long q_ss, long long q_hs, long long k_bs,
                       long long k_ss, long long k_hs, long long v_bs,
                       long long v_ss, long long v_hs, float scale,
                       int causal) {
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
  const T* qb = q + b * q_bs + h * q_hs;
  const T* kb = k + b * k_bs + kvh * k_hs;
  const T* vb = v + b * v_bs + kvh * v_hs;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    Qs[qs_index(d, r)] =
        q0 + r < Sq ? __fmul_rn(to_f32(qb[(long long)(q0 + r) * q_ss + d]),
                                scale)
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
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();   // Q staged; the previous tile's Ps/Vs fully read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = kv0 + c < Skv;
      Ks[d * KST + c] = in ? to_f32(kb[(long long)(kv0 + c) * k_ss + d]) : 0.0f;
      Vs[c * DM + d] = in ? to_f32(vb[(long long)(kv0 + c) * v_ss + d]) : 0.0f;
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
        else if (causal && col > row)
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
    T* ob = out + (((long long)b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = DJ * tx + j;
      if (d < D) store(ob + d, acc[i][j] / den);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int D, long long q_bs,
           long long q_ss, long long q_hs, long long k_bs, long long k_ss,
           long long k_hs, long long v_bs, long long v_ss, long long v_hs,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DJ>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, H / K, Sq, Skv, D,
      q_bs, q_ss, q_hs, k_bs, k_ss, k_hs, v_bs, v_ss, v_hs, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the head
// dimension is contiguous.  out is a contiguous [B, Sq, H, D] array.
// Returns a cudaError_t (cudaErrorInvalidValue for D outside 1..128).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int Sq, int Skv, int D, long long q_bs, long long q_ss,
    long long q_hs, long long k_bs, long long k_ss, long long k_hs,
    long long v_bs, long long v_ss, long long v_hs, float scale, int causal,
    int dtype, int device, void* stream) {
  if (D < 1 || D > 128 || K < 1 || H % K != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return D <= 64 ? launch<float, 4>(q, k, v, out, B, H, K, Sq, Skv, D, q_bs,
                                      q_ss, q_hs, k_bs, k_ss, k_hs, v_bs, v_ss,
                                      v_hs, scale, causal, s)
                   : launch<float, 8>(q, k, v, out, B, H, K, Sq, Skv, D, q_bs,
                                      q_ss, q_hs, k_bs, k_ss, k_hs, v_bs, v_ss,
                                      v_hs, scale, causal, s);
  }
  if (dtype == 1) {
    return D <= 64
               ? launch<__nv_bfloat16, 4>(q, k, v, out, B, H, K, Sq, Skv, D,
                                          q_bs, q_ss, q_hs, k_bs, k_ss, k_hs,
                                          v_bs, v_ss, v_hs, scale, causal, s)
               : launch<__nv_bfloat16, 8>(q, k, v, out, B, H, K, Sq, Skv, D,
                                          q_bs, q_ss, q_hs, k_bs, k_ss, k_hs,
                                          v_bs, v_ss, v_hs, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
