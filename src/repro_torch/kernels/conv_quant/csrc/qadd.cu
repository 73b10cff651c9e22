// K9: the residual add of two int8 tensors, one launch over every lane,
// for Hopper (sm_90a).
//
// It has no TPU kernel counterpart: the reference computes a graph's qadd
// as XLA element-wise ops, and the port ran ref.qadd as about a dozen
// torch element-wise kernels an add (casts, two products, the
// round-half-even shift, the clamp, the cast).  Here each element is
// qadd.cuh's qadd_replay, the body K4/K5 already run after their conv, so
// the arithmetic is bit-exact to ref.qadd:
//   out = clip(round_half_even(((a - zp_a) * ma + (b - zp_b) * mb) / 2^16)
//              + zp_out, -128, 127)
// with ma, mb quantized to 16 fractional bits on the host.
//
// What bounds it: bytes (two int8 reads and one write an element; at
// MobileNetV2's add shapes a lane moves 23-226 KB) and the launch.  Each
// thread takes VEC consecutive elements of one lane (16 where the
// element count and every pointer and lane stride are multiples of 16,
// 4 where they are multiples of 4, else 1: ops.load_width), so a warp
// reads and writes whole 16-byte words.  The legs and the output are read
// and written where they lie in the arena: lanes a_bs / b_bs / o_bs bytes
// apart, each lane's n elements contiguous.  The output may be the same
// bytes as a leg (an in-place plan): each thread reads its elements
// before it writes them, and no two threads share one.
#include <cuda_runtime.h>

#include <cstdint>

#include "qadd.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 4096;

template <int VEC>
struct Word;
template <>
struct Word<16> {
  using T = int4;
};
template <>
struct Word<4> {
  using T = int;
};
template <>
struct Word<1> {
  using T = int8_t;
};

template <int VEC>
union Bytes {
  typename Word<VEC>::T word;
  int8_t b[VEC];
};

template <int VEC>
__global__ void __launch_bounds__(THREADS)
qadd_kernel(const int8_t* a, const int8_t* b, int8_t* out, long long words,
            long long a_bs, long long b_bs, long long o_bs, int ma, int mb,
            int zp_a, int zp_b, int zp_out) {
  using T = typename Word<VEC>::T;
  const long long lane = blockIdx.y;
  const T* aw = reinterpret_cast<const T*>(a + lane * a_bs);
  const T* bw = reinterpret_cast<const T*>(b + lane * b_bs);
  T* ow = reinterpret_cast<T*>(out + lane * o_bs);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < words; i += (long long)gridDim.x * THREADS) {
    Bytes<VEC> x, y, z;
    x.word = aw[i];
    y.word = bw[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      z.b[j] = qadd_replay(x.b[j], y.b[j], ma, mb, zp_a, zp_b, zp_out);
    ow[i] = z.word;
  }
}

template <int VEC>
int launch(const void* a, const void* b, void* out, int B, long long n,
           long long a_bs, long long b_bs, long long o_bs, int ma, int mb,
           int zp_a, int zp_b, int zp_out, cudaStream_t stream) {
  const long long words = n / VEC;
  const long long want = (words + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(want < MAX_BLOCKS_X ? want : MAX_BLOCKS_X),
                  (unsigned)B);
  qadd_kernel<VEC><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int8_t*)out, words, a_bs, b_bs,
      o_bs, ma, mb, zp_a, zp_b, zp_out);
  return (int)cudaGetLastError();
}

}  // namespace

// n: elements a lane; vec: elements a thread takes at once (16, 4 or 1;
// ops.load_width of n and every pointer and lane stride).
extern "C" int qadd_launch(const void* a, const void* b, void* out, int B,
                           long long n, long long a_bs, long long b_bs,
                           long long o_bs, int ma, int mb, int zp_a,
                           int zp_b, int zp_out, int vec, int device,
                           void* stream) {
  if (B < 1 || B > 65535 || n < 1 || (vec != 16 && vec != 4 && vec != 1) ||
      n % vec || a_bs % vec || b_bs % vec || o_bs % vec ||
      (uintptr_t)a % vec || (uintptr_t)b % vec || (uintptr_t)out % vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 16)
    return launch<16>(a, b, out, B, n, a_bs, b_bs, o_bs, ma, mb, zp_a, zp_b,
                      zp_out, s);
  if (vec == 4)
    return launch<4>(a, b, out, B, n, a_bs, b_bs, o_bs, ma, mb, zp_a, zp_b,
                     zp_out, s);
  return launch<1>(a, b, out, B, n, a_bs, b_bs, o_bs, ma, mb, zp_a, zp_b,
                   zp_out, s);
}
