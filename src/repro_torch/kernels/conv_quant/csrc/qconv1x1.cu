// K1: int8 1x1 convolution + requantize + ReLU for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv1x1_pallas (body
// _qconv1x1_kernel): per lane, out[m, n] = requant(sum_k (x[m, k] - zp_in)
// * w[k, n]) over the (H*W, Cin) x (Cin, Cout) int32 product.  The body
// (int8 tensor cores, split-K), its bound and its layout are in
// qconv1x1.cuh; split/chunk are its split-K plan (ops.plan_split_k).
#include "qconv1x1.cuh"
#include "requant.cuh"

extern "C" int qconv1x1_launch(const void* x, const void* w, void* out,
                               int B, int M, int Cin, int Cout,
                               long long x_bs, long long o_bs, float mult,
                               int zp_in, int zp_out, int split, int chunk,
                               int device, void* stream) {
  return qconv1x1_run(x, w, out, B, M, Cin, Cout, x_bs, o_bs, zp_in,
                      RequantRelu{mult, zp_out}, split, chunk, device,
                      stream);
}
