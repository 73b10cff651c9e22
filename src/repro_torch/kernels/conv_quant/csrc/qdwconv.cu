// K2: depthwise k x k, stride-s int8 convolution + requantize + ReLU for
// Hopper (sm_90a).
//
// Replaces repro/kernels/conv_quant/kernel.py:qdwconv_pallas (via
// _windowed_call, body _qdwconv_kernel): per channel, k*k shifted int32
// multiply-accumulates of (x - zp_in) * w over a zp_in-padded input.
//
// What bounds it on the H100: bytes and launch latency, never arithmetic.
// At MobileNet-v1 1.0@192's depthwise shapes a call moves at most ~0.6 MB
// (bound < 0.2 us at 3.35 TB/s) and does at most ~5 M int8 operations; at
// the 224 KB cascade's windows (1-2 output rows x 26-61 x 32-128
// channels) it moves a few KB.  A block is a chain of dependent steps on
// 4 warps (launch, one trip to memory, a barrier, the products, the
// stores), so the design is about loads, about reading the input where it
// lies, and about keeping each thread's share of that chain short:
// - An input tile with its halo is staged once per block in shared
//   memory, so each input byte leaves device memory once per block, not
//   k*k times.  The copies are cp.async of 16 bytes where C and every
//   pointer and stride are multiples of 16 (both main-path schedules), or
//   of 4 bytes where they are multiples of 4; ops.load_width decides on
//   the host.  Only the channels below C are staged, and a thread walks
//   its copies by adding to (row, column, unit), with no division per
//   copy.  Elsewhere (C % 4 != 0, or a view at an odd offset: the scalar
//   path) a thread reads its taps' bytes from device memory through L1
//   and no tile is staged: a staged byte costs a copy's address
//   arithmetic in the block's chain, more than the reuse saves at such
//   shapes (SwiftNet's C = 2, 9, 10).
// - Halo taps outside [0, H) x [0, W) are written into shared memory as
//   zp_in, and the sum is formed as sum(x * w) - zp_in * sum(w) (int32,
//   exact): a padded tap adds zp_in * w - zp_in * w = 0, which is what the
//   reference's padding with zp_in gives.  No padding reaches device
//   memory.
// - A cascade ring window is read in place: input row iy of the window is
//   ring row (src + iy) % ring_rows (a plain input is src 0, ring_rows H),
//   so the executor copies nothing before K2 runs.
// - One channel a thread, channels on the fast axis (NHWC): a warp's
//   copies, tile reads and byte stores are consecutive bytes.  A thread's
//   k*k weights are loaded into registers (k = 3) before the tile, so both
//   are in flight together.  Four channels a thread (a 4-byte word, fewer
//   threads) made every block's chain longer and was slower or level at
//   every shape of the repo's int8 graphs on an H100.
// Tiles (ops.plan_dw_tile): 128 threads; cq channels a block (a power of
// two up to 128, as many as C needs), gy output rows of gx pixel groups
// of ppt pixels, cq * gx * gy = 128.  ppt is 4 or 2 only where the grid
// still has 2 blocks an SM (264 on an H100), else 1 (forced-plan device
// times, tools/kernel_times.py --ppt).  Shared memory: the tile,
// ((gy-1)*s+k) x ((gx*ppt-1)*s+k) x cq bytes, at most a few KB on the
// path.
//
// Interface: x and out are arena views, each lane contiguous, lanes x_bs /
// o_bs bytes apart (the batch stride is passed; no copy).  x holds
// ring_rows rows; the input is the H-row window starting at ring row src.
// w is a contiguous [k, k, C] int8 array.
#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int LD>
__device__ __forceinline__ void copy_async(int8_t* dst, const int8_t* src) {
  if constexpr (LD == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (LD == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = __ldg(src);
  }
}

// KC: k when it is known at compile time (weights in registers), 0 for any
// k (weights read from device memory, through L1, where used).  LD: bytes
// a copy moves (16, 4; 1: the scalar path, no tile).
template <int KC, int LD>
__global__ void __launch_bounds__(THREADS)
qdwconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               int8_t* __restrict__ out, int H, int ring_rows, int src,
               int W, int C, int OH, int OW, int k_rt, int stride,
               int pad_top, int pad_left, long long x_bs, long long o_bs,
               float mult, int zp_in, int zp_out, int cq, int gx, int gy,
               int ppt, int tiles_x, int tiles_c) {
  extern __shared__ __align__(16) int8_t smem[];
  const int k = KC ? KC : k_rt;
  const int tc = cq;                        // channels a block
  const int cb = blockIdx.x % tiles_c;
  const int rest = blockIdx.x / tiles_c;
  const int oy0 = (rest / tiles_x) * gy, ox0 = (rest % tiles_x) * gx * ppt;
  const int c0 = cb * tc;
  const int rows_in = (gy - 1) * stride + k;
  const int cols_in = (gx * ppt - 1) * stride + k;
  const int iy0 = oy0 * stride - pad_top, ix0 = ox0 * stride - pad_left;
  const int8_t* xb = x + (long long)blockIdx.y * x_bs;
  int8_t* tile = smem;
  const int tid = threadIdx.x;
  const int q = tid % cq, g = tid / cq;
  const int c = c0 + q;                     // this thread's channel
  const bool live = c < C;

  // this thread's weights first, so that they are in flight with the
  // tile: its channel's k*k taps in registers where k is known at compile
  // time
  int wr[KC > 0 ? KC * KC : 1];
  if constexpr (KC > 0) {
#pragma unroll
    for (int t = 0; t < KC * KC; ++t)
      wr[t] = live ? __ldg(w + (long long)t * C + c) : 0;
  }

  if constexpr (LD != 1) {
    // the input tile with its halo (16- and 4-byte copies; the scalar path
    // reads its taps from device memory instead): copies of LD bytes, (row,
    // col, unit) with the unit fastest, only the units that hold channels
    // below C (the rest meet zero weights and unstored outputs); outside the
    // input: zp_in.  A thread walks its copies tid, tid + THREADS, ... by
    // adding to (row, col, unit), with no division per copy.
    const int units = tc / LD;
    const int valid = (min(tc, C - c0) + LD - 1) / LD;
    const int total = rows_in * cols_in * valid;
    auto row_at = [&](int row) -> const int8_t* {
      const int iy = iy0 + row;
      if (iy < 0 || iy >= H) return nullptr;
      return xb + ((long long)((src + iy) % ring_rows) * W + ix0) * C + c0;
    };
    int u = tid % valid, col = tid / valid % cols_in;
    int row = tid / valid / cols_in;
    const int du = THREADS % valid, dcol = THREADS / valid;
    const int8_t* rp = row_at(row);
    // the source of the current copy (null: zp_in) and its tile address;
    // then the next copy's (row, col, unit)
    auto here = [&]() -> const int8_t* {
      return rp && ix0 + col >= 0 && ix0 + col < W ? rp + col * C + u * LD
                                                   : nullptr;
    };
    auto dst_at = [&]() {
      return tile + ((row * cols_in + col) * units + u) * LD;
    };
    auto advance = [&]() {
      u += du;
      const int carry = u >= valid;
      u -= carry ? valid : 0;
      col += dcol + carry;
      if (col >= cols_in) {
        do {
          col -= cols_in;
          ++row;
        } while (col >= cols_in);
        rp = row_at(row);
      }
    };
    const uint32_t zp4 = 0x01010101u * (uint32_t)(uint8_t)zp_in;
    for (int e = tid; e < total; e += THREADS) {
      int8_t* dst = dst_at();
      const int8_t* sp = here();
      if (sp) {
        copy_async<LD>(dst, sp);
      } else if constexpr (LD == 16) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(zp4, zp4, zp4, zp4);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = zp4;
      }
      advance();
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  const int gxi = g % gx, gyi = g / gx;
  const int oy = oy0 + gyi;
  if (!live || oy >= OH) return;

  int wsum = 0;
#pragma unroll
  for (int t = 0; t < k * k; ++t)
    wsum += KC > 0 ? wr[t] : __ldg(w + (long long)t * C + c);

  int acc[4] = {0, 0, 0, 0};
  // k is a compile-time constant where KC > 0: the tap loops unroll and
  // the weights stay in registers
#pragma unroll
  for (int dy = 0; dy < k; ++dy) {
    const int tr = gyi * stride + dy;             // the tile's row
    const int8_t* row = tile + tr * cols_in * tc + q;
    const int iy = iy0 + tr;                      // the scalar path's
    const int8_t* xrow =
        LD == 1 && iy >= 0 && iy < H
            ? xb + ((long long)((src + iy) % ring_rows) * W + ix0) * C + c
            : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < ppt) {
#pragma unroll
        for (int dx = 0; dx < k; ++dx) {
          const int tcol = (gxi * ppt + j) * stride + dx;
          int xv;
          if constexpr (LD == 1)   // zp_in outside the input
            xv = xrow && ix0 + tcol >= 0 && ix0 + tcol < W
                     ? __ldg(xrow + (long long)tcol * C)
                     : zp_in;
          else
            xv = row[tcol * tc];
          const int wv =
              KC > 0 ? wr[dy * KC + dx]
                     : __ldg(w + (long long)(dy * k + dx) * C + c);
          acc[j] += xv * wv;
        }
      }
    }
  }

  int8_t* ob =
      out + (long long)blockIdx.y * o_bs + (long long)oy * OW * C + c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ox = ox0 + gxi * ppt + j;
    if (j >= ppt || ox >= OW) break;
    ob[(long long)ox * C] = requant_relu(acc[j] - zp_in * wsum, mult, zp_out);
  }
}

struct Args {
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  const int8_t* x;
  const int8_t* w;
  int8_t* out;
  int H, ring_rows, src, W, C, OH, OW, k, stride, pad_top, pad_left;
  long long x_bs, o_bs;
  float mult;
  int zp_in, zp_out, cq, gx, gy, ppt, tiles_x, tiles_c;
};

template <int KC, int LD>
int launch(const Args& a) {
  auto kern = qdwconv_kernel<KC, LD>;
  if (a.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.grid, THREADS, a.smem, a.stream>>>(
      a.x, a.w, a.out, a.H, a.ring_rows, a.src, a.W, a.C, a.OH, a.OW, a.k,
      a.stride, a.pad_top, a.pad_left, a.x_bs, a.o_bs, a.mult, a.zp_in,
      a.zp_out, a.cq, a.gx, a.gy, a.ppt, a.tiles_x, a.tiles_c);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_ld(int ld, const Args& a) {
  if (ld == 16) return launch<KC, 16>(a);
  if (ld == 4) return launch<KC, 4>(a);
  return launch<KC, 1>(a);
}

}  // namespace

// ld: bytes a copy moves (16, 4 or 1; ops.load_width); cq/gx/gy/ppt: the
// tile (ops.plan_dw_tile), cq * gx * gy == 128.
extern "C" int qdwconv_launch(const void* x, const void* w, void* out,
                              int B, int H, int ring_rows, int src, int W,
                              int C, int OH, int OW, int k, int stride,
                              int pad_top, int pad_left, long long x_bs,
                              long long o_bs, float mult, int zp_in,
                              int zp_out, int ld, int cq, int gx, int gy,
                              int ppt, int device, void* stream) {
  if (cq * gx * gy != THREADS || ppt < 1 || ppt > 4 ||
      (ld != 16 && ld != 4 && ld != 1) || (ld > 1 && C % ld) || cq % ld ||
      src < 0 || src >= ring_rows || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.tiles_x = (OW + gx * ppt - 1) / (gx * ppt);
  a.tiles_c = (C + cq - 1) / cq;
  const int tiles_y = (OH + gy - 1) / gy;
  const size_t tile = (size_t)((gy - 1) * stride + k) *
                      ((gx * ppt - 1) * stride + k) * cq;
  a.grid = dim3((unsigned)(tiles_y * a.tiles_x * a.tiles_c), B);
  a.smem = ld == 1 ? 0 : tile;   // the scalar path stages no tile
  a.stream = (cudaStream_t)stream;
  a.x = (const int8_t*)x;
  a.w = (const int8_t*)w;
  a.out = (int8_t*)out;
  a.H = H, a.ring_rows = ring_rows, a.src = src, a.W = W, a.C = C;
  a.OH = OH, a.OW = OW, a.k = k, a.stride = stride, a.pad_top = pad_top;
  a.pad_left = pad_left, a.x_bs = x_bs, a.o_bs = o_bs, a.mult = mult;
  a.zp_in = zp_in, a.zp_out = zp_out, a.cq = cq;
  a.gx = gx, a.gy = gy, a.ppt = ppt;
  return k == 3 ? launch_ld<3>(ld, a) : launch_ld<0>(ld, a);
}
