// K4: int8 1x1 convolution + requantize + ReLU, then the fixed-point add
// of a residual, for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv1x1_add_pallas (body
// _qconv1x1_add_kernel): K1's product (qconv1x1.cuh), whose requantized
// int8 value goes straight into the qadd replay (qadd.cuh) with the
// residual's element at the same index; the conv's output never reaches
// device memory.  It moves one more int8 tensor than K1 (the residual), so
// its bound is K1's plus those bytes; the design is K1's.
//
// Interface: K1's, plus r (the residual, [H*W, Cout] per lane, lanes r_bs
// bytes apart) and the add's (ma, mb, zp_a, zp_b, zp_add), with ma and mb
// already quantized to 16 fractional bits on the host, then K1's split-K
// plan (split, chunk).
#include "qadd.cuh"
#include "qconv1x1.cuh"

extern "C" int qconv1x1_add_launch(const void* x, const void* w, void* out,
                                   int B, int M, int Cin, int Cout,
                                   long long x_bs, long long o_bs,
                                   float mult, int zp_in, int zp_out,
                                   const void* r, long long r_bs, int ma,
                                   int mb, int zp_a, int zp_b, int zp_add,
                                   int split, int chunk, int device,
                                   void* stream) {
  const RequantAdd ep{mult, zp_out, (const int8_t*)r, r_bs,
                      ma, mb, zp_a, zp_b, zp_add};
  return qconv1x1_run(x, w, out, B, M, Cin, Cout, x_bs, o_bs, zp_in, ep,
                      split, chunk, device, stream);
}
