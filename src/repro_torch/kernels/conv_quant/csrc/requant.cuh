// The requantize epilogue shared by the int8 conv kernels.
//
// It replays the reference's element-wise sequence bit for bit
// (repro/kernels/conv_quant/kernel.py:_requant, cnn_ops.requantize):
//   round(float32(acc) * float32(mult)) + zp_out, clip to [lo, 127], int8.
// __fmul_rn and __fadd_rn are never contracted into an FMA, rintf rounds
// half to even as jnp.round does, and the clamped value is an integer in
// [-128, 127], so the final conversion is exact.
#pragma once

#include <cstdint>

__device__ __forceinline__ int8_t requant_relu(int acc, float mult,
                                               int zp_out) {
  float f = __fmul_rn(__int2float_rn(acc), mult);
  f = __fadd_rn(rintf(f), (float)zp_out);
  f = fminf(fmaxf(f, (float)zp_out), 127.0f);
  return (int8_t)__float2int_rn(f);
}
