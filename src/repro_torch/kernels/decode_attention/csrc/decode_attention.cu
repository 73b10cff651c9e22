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
// 3.35 TB/s) and does ~2 flops per byte.  What the design does about it:
// one block per (batch row, kv head) serves all H/K query heads of that
// kv head, so each K/V row leaves device memory once per step, not once
// per query head as the TPU kernel's per-head grid reads it; and it
// streams only the rows < lengths[b] instead of masking whole blocks
// (a masked row's p is exactly 0 once any row is valid, so the result is
// the same).  What it does not do yet: with B x K blocks (32 at the model's
// batch of 4) most of the card's 132 SMs are idle; splitting the sequence
// over blocks with a second merge pass (flash-decoding) is later work.
//
// Structure: 8 warps per block; warp w takes the tiles of R = 4 rows
// w, w+8, w+16, ...; lane l holds head dims l, l+32, l+64, l+96 (loads
// coalesced across the warp).  Each warp keeps its own running max, sum
// and accumulator per query head in registers; the 8 partial states are
// merged in shared memory at the end, rescaled to the common max.
//
// lengths[b] >= 1 is the contract (the model never passes 0).  A length of
// 0 (or less) streams no row and returns zeros; the TPU kernel would
// return the mean of every V row there.  Lengths above S are clamped to S.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 8, THREADS = 32 * NW, R = 4, DV = 4;  // D <= 32 * DV
constexpr float MASKED = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int S, int D, long long q_bs, long long q_hs,
                        long long k_bs, long long k_ss, long long k_hs,
                        long long v_bs, long long v_ss, long long v_hs,
                        float scale) {
  __shared__ float part_m[NW][G], part_l[NW][G];
  __shared__ float part_acc[NW][G][32 * DV];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int len = min(lengths[b], S);
  const T* kb = kc + b * k_bs + kvh * k_hs;
  const T* vb = vc + b * v_bs + kvh * v_hs;

  float qr[G][DV], acc[G][DV], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qg = q + b * q_bs + (long long)(kvh * G + g) * q_hs;
    m[g] = MASKED;
    l[g] = 0.0f;
#pragma unroll
    for (int t = 0; t < DV; ++t) {
      const int d = lane + 32 * t;
      qr[g][t] = d < D ? __fmul_rn(to_f32(qg[d]), scale) : 0.0f;
      acc[g][t] = 0.0f;
    }
  }

  for (int r0 = warp * R; r0 < len; r0 += NW * R) {
    float kx[R][DV], vx[R][DV];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = r0 + rr;
#pragma unroll
      for (int t = 0; t < DV; ++t) {
        const int d = lane + 32 * t;
        const bool in = row < len && d < D;
        kx[rr][t] = in ? to_f32(kb[(long long)row * k_ss + d]) : 0.0f;
        vx[rr][t] = in ? to_f32(vb[(long long)row * v_ss + d]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[R];
      float mx = -INFINITY;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        float part = 0.0f;
#pragma unroll
        for (int t = 0; t < DV; ++t) part = fmaf(qr[g][t], kx[rr][t], part);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        s[rr] = r0 + rr < len ? part : -INFINITY;   // past the length: p = 0
        mx = fmaxf(mx, s[rr]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int t = 0; t < DV; ++t) acc[g][t] *= alpha;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float p = expf(s[rr] - m_new);
        l[g] += p;
#pragma unroll
        for (int t = 0; t < DV; ++t) acc[g][t] = fmaf(p, vx[rr][t], acc[g][t]);
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < DV; ++t) part_acc[warp][g][lane + 32 * t] = acc[g][t];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float mx = MASKED;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, part_m[w][g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(part_m[w][g] - mx);
      den = fmaf(part_l[w][g], c, den);
      num = fmaf(part_acc[w][g][d], c, num);
    }
    store(out + ((long long)b * H + kvh * G + g) * D + d,
          num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int H, int K, int S, int D, long long q_bs,
           long long q_hs, long long k_bs, long long k_ss, long long k_hs,
           long long v_bs, long long v_ss, long long v_hs, float scale,
           cudaStream_t stream) {
  dim3 grid(K, B);
  decode_attention_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)out, H,
      S, D, q_bs, q_hs, k_bs, k_ss, k_hs, v_bs, v_ss, v_hs, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_groups(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int B, int H, int K, int S,
                  int D, long long q_bs, long long q_hs, long long k_bs,
                  long long k_ss, long long k_hs, long long v_bs,
                  long long v_ss, long long v_hs, float scale,
                  cudaStream_t s) {
#define K8_CASE(G)                                                          \
  case G:                                                                  \
    return launch<T, G>(q, k, v, lengths, out, B, H, K, S, D, q_bs, q_hs,  \
                        k_bs, k_ss, k_hs, v_bs, v_ss, v_hs, scale, s);
  switch (H / K) {
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the head
// dimension is contiguous.  lengths is an int32 device array [B]; out a
// contiguous [B, H, D] array.  Returns a cudaError_t
// (cudaErrorInvalidValue for D outside 1..128 or H/K outside 1..8).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int K, int S, int D, long long q_bs,
    long long q_hs, long long k_bs, long long k_ss, long long k_hs,
    long long v_bs, long long v_ss, long long v_hs, float scale, int dtype,
    int device, void* stream) {
  if (D < 1 || D > 32 * DV || K < 1 || H % K != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_groups<float>(q, k, v, lengths, out, B, H, K, S, D, q_bs,
                                q_hs, k_bs, k_ss, k_hs, v_bs, v_ss, v_hs,
                                scale, s);
  if (dtype == 1)
    return launch_groups<__nv_bfloat16>(q, k, v, lengths, out, B, H, K, S, D,
                                        q_bs, q_hs, k_bs, k_ss, k_hs, v_bs,
                                        v_ss, v_hs, scale, s);
  return (int)cudaErrorInvalidValue;
}
