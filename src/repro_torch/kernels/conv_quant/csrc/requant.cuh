// The requantize epilogues shared by the int8 conv kernels.
//
// It replays the reference's element-wise sequence bit for bit
// (repro/kernels/conv_quant/kernel.py:_requant, cnn_ops.requantize):
//   round(float32(acc) * float32(mult)) + zp_out, clip to [lo, hi], int8.
// [lo, hi] is the activation's int8 clamp pair (ref.clamp_pair): [zp_out,
// 127] for a ReLU, [zp_out, min(127, zp_out + round(6 / s_out))] for a
// ReLU6, [-128, 127] for a linear conv.  __fmul_rn and __fadd_rn are never
// contracted into an FMA, rintf rounds half to even as jnp.round does, and
// the clamped value is an integer in [-128, 127], so the final conversion
// is exact.
#pragma once

#include <cstdint>

__device__ __forceinline__ int8_t requant_clamp(int acc, float mult,
                                                int zp_out, int lo, int hi) {
  float f = __fmul_rn(__int2float_rn(acc), mult);
  f = __fadd_rn(rintf(f), (float)zp_out);
  f = fminf(fmaxf(f, (float)lo), (float)hi);
  return (int8_t)__float2int_rn(f);
}

// The plain conv epilogue (K1, K3): requantize and clamp to [lo, hi].  An
// epilogue maps (int32 accumulator, lane, element index in the lane) to
// the int8 output.
struct RequantClamp {
  float mult;
  int zp_out, lo, hi;
  __device__ __forceinline__ int8_t operator()(int acc, long long,
                                               long long) const {
    return requant_clamp(acc, mult, zp_out, lo, hi);
  }
};

// The table epilogue (K1-K3 where the conv ends in MobileNetV3's h-swish
// or h-sigmoid): requantize to the pre-activation's params and clamp to
// [lo, hi], which the host holds to [-128, 127], then write table[q +
// 128], one of the 256 int8 values graphs/quantize.py computed from the
// activation's float definition.  The 256 bytes are read through the
// read-only cache; the clamp path is the other template instance, so its
// code is unchanged.
struct RequantTable {
  float mult;
  int zp_out, lo, hi;
  const int8_t* table;
  __device__ __forceinline__ int8_t operator()(int acc, long long,
                                               long long) const {
    return __ldg(table + 128 + requant_clamp(acc, mult, zp_out, lo, hi));
  }
};
