// K10: squeeze-and-excite's channel scale, an int8 map times its lane's
// int8 gate channel by channel, one launch over every lane, for Hopper
// (sm_90a).
//
// It has no TPU kernel counterpart: MobileNetV3's SE block is new to the
// port.  Each element is the plain version's sequence (ref.qmul):
//   acc = (x - zp_x) * (g[c] - zp_g)                 (int32, |acc| <= 255^2)
//   out = clip(round(f32(acc) * f32(mult)) + zp_out, -128, 127)
// with mult = s_x * s_g / s_out, through requant.cuh's requant_clamp, the
// conv epilogue's own replay of that rounding.
//
// What bounds it: bytes (the map read and the output written, the gate's
// C bytes a lane read through the read-only cache; at MobileNetV3-Large's
// SE shapes a lane moves 19-188 KB) and the launch.  Each thread takes
// VEC consecutive elements of one lane, VEC channels of one pixel (16
// where C and every pointer and lane stride are multiples of 16, 4 where
// they are multiples of 4, else 1: ops.load_width), so a warp reads and
// writes whole 16-byte words of the map and the VEC gate bytes it needs
// are one word too.  The map, the gate and the output are read and written
// where they lie in the arena: lanes x_bs / g_bs / o_bs bytes apart, each
// lane's elements contiguous.  The output may be the map's own bytes (an
// in-place plan): each thread reads its elements before it writes them,
// and no two threads share one.
#include <cuda_runtime.h>

#include <cstdint>

#include "requant.cuh"

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

// words: VEC-element words a lane; cw: words a pixel (C / VEC)
template <int VEC>
__global__ void __launch_bounds__(THREADS)
qscale_kernel(const int8_t* x, const int8_t* g, int8_t* out, long long words,
              int cw, long long x_bs, long long g_bs, long long o_bs,
              float mult, int zp_x, int zp_g, int zp_out) {
  using T = typename Word<VEC>::T;
  const long long lane = blockIdx.y;
  const T* xw = reinterpret_cast<const T*>(x + lane * x_bs);
  const T* gw = reinterpret_cast<const T*>(g + lane * g_bs);
  T* ow = reinterpret_cast<T*>(out + lane * o_bs);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < words; i += (long long)gridDim.x * THREADS) {
    Bytes<VEC> v, s, z;
    v.word = xw[i];
    s.word = __ldg(gw + i % cw);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      z.b[j] = requant_clamp((v.b[j] - zp_x) * (s.b[j] - zp_g), mult,
                             zp_out, -128, 127);
    ow[i] = z.word;
  }
}

template <int VEC>
int launch(const void* x, const void* g, void* out, int B, long long n,
           int C, long long x_bs, long long g_bs, long long o_bs, float mult,
           int zp_x, int zp_g, int zp_out, cudaStream_t stream) {
  const long long words = n / VEC;
  const long long want = (words + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(want < MAX_BLOCKS_X ? want : MAX_BLOCKS_X),
                  (unsigned)B);
  qscale_kernel<VEC><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)g, (int8_t*)out, words, C / VEC,
      x_bs, g_bs, o_bs, mult, zp_x, zp_g, zp_out);
  return (int)cudaGetLastError();
}

}  // namespace

// n: elements a lane (a whole number of pixels of C channels); vec:
// elements a thread takes at once (16, 4 or 1; ops.load_width of C and
// every pointer and lane stride).
extern "C" int qscale_launch(const void* x, const void* g, void* out, int B,
                             long long n, int C, long long x_bs,
                             long long g_bs, long long o_bs, float mult,
                             int zp_x, int zp_g, int zp_out, int vec,
                             int device, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || C < 1 || n % C ||
      (vec != 16 && vec != 4 && vec != 1) || C % vec || x_bs % vec ||
      g_bs % vec || o_bs % vec || (uintptr_t)x % vec ||
      (uintptr_t)g % vec || (uintptr_t)out % vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 16)
    return launch<16>(x, g, out, B, n, C, x_bs, g_bs, o_bs, mult, zp_x, zp_g,
                      zp_out, s);
  if (vec == 4)
    return launch<4>(x, g, out, B, n, C, x_bs, g_bs, o_bs, mult, zp_x, zp_g,
                     zp_out, s);
  return launch<1>(x, g, out, B, n, C, x_bs, g_bs, o_bs, mult, zp_x, zp_g,
                   zp_out, s);
}
