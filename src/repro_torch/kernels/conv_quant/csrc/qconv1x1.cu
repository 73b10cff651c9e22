// K1: int8 1x1 convolution + requantize + clamp for Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv1x1_pallas (body
// _qconv1x1_kernel): per lane, out[m, n] = requant(sum_k (x[m, k] - zp_in)
// * w[k, n]) over the (H*W, Cin) x (Cin, Cout) int32 product, clamped to
// the activation's [lo, hi] (requant.cuh), or, for a table activation,
// mapped through its table after that (requant.cuh's RequantTable).  The
// body (int8 tensor cores, split-K), its bound and its layout are in
// qconv1x1.cuh; split/chunk are its split-K plan (ops.plan_split_k).
#include "qconv1x1.cuh"
#include "requant.cuh"

// table: null for the clamp epilogue, else the 256-byte activation table
// of the table epilogue (requant.cuh).
extern "C" int qconv1x1_launch(const void* x, const void* w, void* out,
                               int B, int M, int Cin, int Cout,
                               long long x_bs, long long o_bs, float mult,
                               int zp_in, int zp_out, int lo, int hi,
                               const void* table, int split, int chunk,
                               int device, void* stream) {
  if (table)
    return qconv1x1_run(
        x, w, out, B, M, Cin, Cout, x_bs, o_bs, zp_in,
        RequantTable{mult, zp_out, lo, hi, (const int8_t*)table}, split,
        chunk, device, stream);
  return qconv1x1_run(x, w, out, B, M, Cin, Cout, x_bs, o_bs, zp_in,
                      RequantClamp{mult, zp_out, lo, hi}, split, chunk,
                      device, stream);
}
