// The client's float32 -> int8 input quantize, one pass on the host:
//
//   q[i] = clamp(rint(x[i] / scale) + zero_point, -128, 127)
//
// in float32, as QParams.quantize's numpy expression computes it: a true
// IEEE division (never a multiply by the reciprocal), round half to even
// (rint in the default rounding mode), the zero point added in float32,
// the clamp, the cast.  Each step rounds as numpy's does, so every output
// is bit-identical to it.  NaN is outside the contract, as in numpy.
//
// The loop is vectorised once per x86-64 level and the host's is picked at
// load time (target_clones; v4's AVX-512 BW/VL narrow float to int8 in two
// instructions, AVX-512F alone takes as long as AVX2): the build has no
// -march, so one library serves every x86-64 host, and the compiler's
// flags allow it no change of the arithmetic.  Elsewhere -O3 vectorises
// it for the base instruction set.  Single-threaded; the element count is
// all it needs.
#include <cmath>
#include <cstdint>

#if defined(__x86_64__) && defined(__GNUC__)
#define PER_ISA                                                    \
  __attribute__((target_clones("arch=x86-64-v4", "arch=x86-64-v3", \
                               "arch=x86-64-v2", "default")))
#else
#define PER_ISA
#endif

namespace {

PER_ISA void quantize(const float* __restrict x, int8_t* __restrict q,
                      long long n, float scale, float zero_point) {
  for (long long i = 0; i < n; ++i) {
    float v = std::rint(x[i] / scale) + zero_point;
    v = v < -128.0f ? -128.0f : v;
    v = v > 127.0f ? 127.0f : v;
    q[i] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

extern "C" int quantize_int8_launch(const float* x, int8_t* q, long long n,
                                    float scale, int zero_point) {
  quantize(x, q, n, scale, static_cast<float>(zero_point));
  return 0;
}
