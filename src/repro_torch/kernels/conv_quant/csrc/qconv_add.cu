// K5: general k x k, stride-s int8 convolution + requantize + clamp, then
// the fixed-point add of a residual, for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv_add_pallas (via
// _windowed_call, body _qconv_add_kernel): K3's implicit GEMM on the int8
// tensor cores (qconv.cuh), whose requantized int8 value goes straight into
// the qadd replay (qadd.cuh) with the residual's element at the same
// output index.  It moves one more int8 tensor than K3 (the residual,
// [OH, OW, Cout]), so its bound is K3's plus those bytes: latency on every
// shape of the repo, which K3's design addresses for both.
//
// Interface: K3's (the conv's clamp pair lo, hi included), plus r (lanes
// r_bs bytes apart, each [OH*OW, Cout]
// contiguous) and the add's (ma, mb, zp_a, zp_b, zp_add), with ma and mb
// already quantized to 16 fractional bits on the host.
#include "qadd.cuh"
#include "qconv.cuh"

extern "C" int qconv_add_launch(const void* x, const void* w, void* out,
                                int B, int H, int ring_rows, int src, int W,
                                int Cin, int Cout, int OH, int OW, int k,
                                int stride, int pad_top, int pad_left,
                                long long x_bs, long long o_bs, float mult,
                                int zp_in, int zp_out, int lo, int hi,
                                const void* r, long long r_bs, int ma,
                                int mb, int zp_a, int zp_b, int zp_add,
                                int bn, int ck, int device, void* stream) {
  const RequantAdd ep{mult, zp_out, lo, hi, (const int8_t*)r, r_bs,
                      ma, mb, zp_a, zp_b, zp_add};
  return qconv_run(x, w, out, B, H, ring_rows, src, W, Cin, Cout, OH, OW, k,
                   stride, pad_top, pad_left, x_bs, o_bs, zp_in, ep, bn, ck,
                   device, stream);
}
