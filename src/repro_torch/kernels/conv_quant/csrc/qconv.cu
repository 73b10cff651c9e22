// K3: general k x k, stride-s int8 convolution + requantize + clamp for
// Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qconv_pallas (via
// _windowed_call, body _qconv_kernel), which accumulates k*k shifted
// (rows*OW, Cin) x (Cin, Cout) int32 products over a zp_in-padded input.
// Here the same sum is one implicit GEMM per lane on the int8 tensor cores
// (mma.sync.m16n8k32), its A tile gathered from the block's input rows in
// shared memory; it is bound by latency (a call moves at most ~0.4 MB on
// the path), and the body, its tiling and why are in qconv.cuh.  table:
// null for the clamp epilogue, else the table epilogue's 256 bytes
// (requant.cuh).
#include "qconv.cuh"
#include "requant.cuh"

extern "C" int qconv_launch(const void* x, const void* w, void* out, int B,
                            int H, int ring_rows, int src, int W, int Cin,
                            int Cout, int OH, int OW, int k, int stride,
                            int pad_top, int pad_left, long long x_bs,
                            long long o_bs, float mult, int zp_in,
                            int zp_out, int lo, int hi, const void* table,
                            int bn, int ck, int device, void* stream) {
  if (table)
    return qconv_run(x, w, out, B, H, ring_rows, src, W, Cin, Cout, OH, OW,
                     k, stride, pad_top, pad_left, x_bs, o_bs, zp_in,
                     RequantTable{mult, zp_out, lo, hi, (const int8_t*)table},
                     bn, ck, device, stream);
  return qconv_run(x, w, out, B, H, ring_rows, src, W, Cin, Cout, OH, OW, k,
                   stride, pad_top, pad_left, x_bs, o_bs, zp_in,
                   RequantClamp{mult, zp_out, lo, hi}, bn, ck, device,
                   stream);
}
