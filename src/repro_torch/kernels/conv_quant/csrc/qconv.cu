// K3: general k x k, stride-s int8 convolution + requantize + ReLU for
// Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv_pallas (via
// _windowed_call, body _qconv_kernel), which accumulates k*k shifted
// (rows*OW, Cin) x (Cin, Cout) int32 products over a zp_in-padded input.
// Here the same sum is one implicit GEMM per lane; the body, its bound
// and its layout are in qconv.cuh.
#include "qconv.cuh"
#include "requant.cuh"

extern "C" int qconv_launch(const void* x, const void* w, void* out, int B,
                            int H, int W, int Cin, int Cout, int OH, int OW,
                            int k, int stride, int pad_top, int pad_left,
                            long long x_bs, long long o_bs, float mult,
                            int zp_in, int zp_out, int device, void* stream) {
  return qconv_run(x, w, out, B, H, W, Cin, Cout, OH, OW, k, stride,
                   pad_top, pad_left, x_bs, o_bs, zp_in,
                   RequantRelu{mult, zp_out}, device, stream);
}
