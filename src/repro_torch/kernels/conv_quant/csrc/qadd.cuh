// The fused conv -> add epilogue of K4 and K5.
//
// It replays the reference's fixed-point qadd bit for bit
// (repro/kernels/conv_quant/kernel.py:_qadd_replay, cnn_ops.qadd): with
// ma, mb = round(mult * 2^16) computed on the host,
//   acc = (y - zp_a) * ma + (r - zp_b) * mb        (int32)
//   z   = acc / 2^16 rounded half to even           (integers only)
//   out = clip(z + zp_out, -128, 127)               (no ReLU)
// where y is the conv's requantized int8 output and r the residual.  The
// host asserts |ma| + |mb| <= 2^23, so |acc| <= 255 * 2^23 < 2^31.
#pragma once

#include <cstdint>

#include "requant.cuh"

constexpr int QADD_SHIFT = 16;
constexpr int QADD_ONE = 1 << QADD_SHIFT;

// floor(acc / 2^16) by integer division, not by a right shift: shifting a
// negative signed int is implementation-defined before C++20.
__device__ __forceinline__ int floor_div_qadd_one(int acc) {
  return acc >= 0 ? acc / QADD_ONE : -((-acc + QADD_ONE - 1) / QADD_ONE);
}

__device__ __forceinline__ int8_t qadd_replay(int y, int r, int ma, int mb,
                                              int zp_a, int zp_b,
                                              int zp_out) {
  const int acc = (y - zp_a) * ma + (r - zp_b) * mb;
  const int base = floor_div_qadd_one(acc);
  const int rem = acc - base * QADD_ONE;           // in [0, 2^16)
  const int half = QADD_ONE / 2;
  // a tie goes to the even neighbour; (base & 1) is the low bit of the
  // two's-complement value, as in the reference's jnp.where sequence
  const int z =
      rem > half ? base + 1 : (rem < half ? base : base + (base & 1));
  return (int8_t)min(max(z + zp_out, -128), 127);
}

// Requantize the conv's accumulator with the fused ReLU, then add the
// residual lane r (lanes r_bs bytes apart, same layout as the output).
struct RequantAdd {
  float mult;
  int zp_out;
  const int8_t* r;
  long long r_bs;
  int ma, mb, zp_a, zp_b, zp_add;
  __device__ __forceinline__ int8_t operator()(int acc, long long lane,
                                               long long idx) const {
    const int y = requant_relu(acc, mult, zp_out);
    return qadd_replay(y, r[lane * r_bs + idx], ma, mb, zp_a, zp_b, zp_add);
  }
};
