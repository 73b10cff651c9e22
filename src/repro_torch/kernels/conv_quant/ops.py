"""Host wrappers of the int8 conv kernels K1–K5, and the q-op drop-ins
``qconv_fused``/``qdwconv_fused``/``qconv_add_fused`` with the reference's
routing rule (k=1, stride 1 and no pads to the 1x1 kernel K1/K4,
everything else to the implicit-GEMM kernel K3/K5).

The device decides, not a knob (the reference's ``use_pallas`` and
``interpret`` are gone): on a CUDA tensor a wrapper launches its Hopper
kernel or raises; on a CPU tensor it runs the plain version in ``ref.py``.
No path falls back from a failed build or launch to the plain version.

Tensors are NHWC with an optional leading batch dimension; one call over
``B`` lanes is one launch.  The kernels read and write arena views in
place: every lane's [H, W, C] block must be contiguous, and the lanes may
lie any number of bytes apart (the batch stride is passed to the kernel,
so no copy is made).  ``out`` (optional) is the destination view.

Each kernel wrapper counts its launches in ``<wrapper>.launches``, a plain
integer that only a kernel launch increments.

K1 and K4 split Cin over a cluster of blocks where the output tiles alone
would leave SMs idle (``plan_split_k``); the blocks add their int32
partials through distributed shared memory, so nothing is allocated for
it.

K2, K3 and K5 also take a cascade ring window in place (``src``/``n``:
the input is rows ``(src + j) % ring_rows``, j < n, of the ring ``x``
[..., ring_rows, W, C]).  The arena executor hands a zero-copy ring read
to ``qdwconv_fused``/``qconv_fused`` as a ``RingWindow``; on a CUDA tensor
K2 and K3 read it where it lies, and every other consumer (K1, a CPU
tensor) gathers it first.  ``plan_dw_tile``, ``load_width`` and
``plan_qconv`` are K2's and K3's host-side plans.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.partition import same_pads

from . import ref
from .build import CONV_QUANT


def _pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    _, beg, end = same_pads(n, k, stride)
    return beg, end


def _require_int8(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int8:
        raise TypeError(f"{name} must be an int8 torch tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")


def _lanes(name: str, t: torch.Tensor) -> Tuple[int, int]:
    """(lanes, batch stride in elements — bytes for int8) of an NHWC
    tensor whose every lane is contiguous; raises on any other layout.
    (On the launch path of every conv: shape and strides are read once.)"""
    shape, stride = t.shape, t.stride()
    nd = len(shape)
    if nd != 3 and nd != 4:
        raise ValueError(f"{name} must be [H,W,C] or [B,H,W,C], got "
                         f"shape {tuple(shape)}")
    c = shape[-1]
    if stride[-1] != 1 or stride[-2] != c or stride[-3] != shape[-2] * c:
        raise ValueError(f"{name}: each lane must be contiguous NHWC, got "
                         f"strides {stride}")
    if nd == 3:
        return 1, 0
    return shape[0], stride[0]


def _same_device(a: torch.Tensor, b: torch.Tensor) -> bool:
    # without building two torch.device objects per call
    return (a.get_device() == b.get_device() and a.is_cuda == b.is_cuda
            and a.is_meta == b.is_meta)


def _destination(out: Optional[torch.Tensor], shape, like: torch.Tensor
                 ) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.int8, device=like.device)
    _require_int8("out", out)
    if out.shape != tuple(shape) or not _same_device(out, like):
        raise ValueError(f"out is {tuple(out.shape)} on {out.device}, "
                         f"expected {tuple(shape)} on {like.device}")
    return out


def _plain(y: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return y
    _destination(out, y.shape, y).copy_(y)
    return out


# the current stream's handle; torch's raw getter (what its own generated
# kernels launch with) skips building a torch.cuda.Stream per call
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(dev: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev)
    return torch.cuda.current_stream(dev).cuda_stream


def _require_cuda(name: str, x: torch.Tensor, w: torch.Tensor,
                  out: torch.Tensor) -> None:
    if not (x.is_cuda and w.is_cuda and out.is_cuda):
        raise ValueError(f"{name}: x, w and out must all be CUDA tensors")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            *args, split_k: Optional[Tuple[int, int, int, int]] = None
            ) -> None:
    """Launch kernel ``name`` on the current stream; ``split_k = (lanes,
    m, cin, cout)`` appends K1/K4's split-K plan (split, chunk)."""
    _require_cuda(name, x, w, out)
    if not w.is_contiguous():
        raise ValueError(f"{name}: weights must be contiguous")
    dev = x.get_device()
    stream = _current_stream(dev)
    if split_k is not None:
        args += _plan(*split_k, dev)
    CONV_QUANT.launch(name, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      *args, dev, stream)


# K1/K4's tile (csrc/qconv1x1.cuh: BM = BN = BK = 64), the most chunks one
# output tile's Cin is cut into (a portable cluster: 8 blocks), the
# shortest Cin loop (in 64-channel K-steps) that is cut at all and the
# fewest K-steps a chunk keeps.  On an H100 a split cost ~0.9-1.4 us of
# device time and paid from 4 K-steps on (tools/kernel_times.py --splits;
# PERF.md).
K1_TILE = 64
MAX_SPLIT = 8
MIN_SPLIT_STEPS = 4
MIN_CHUNK_STEPS = 1


def plan_split_k(lanes: int, m: int, cin: int, cout: int,
                 sms: int) -> Tuple[int, int]:
    """(split, chunk) for K1/K4: Cin in ``split`` chunks of ``chunk``
    channels (a multiple of the 64-channel K-step), chunk ``s`` covering
    ``[s * chunk, min(cin, (s + 1) * chunk))``, no chunk empty.  Cin is
    cut only when the lanes x ceil(m/64) x ceil(cout/64) output tiles are
    fewer than ``sms`` and it spans at least MIN_SPLIT_STEPS K-steps; then
    into enough chunks that tiles x split reaches ``sms`` blocks, at most
    MAX_SPLIT, each of at least MIN_CHUNK_STEPS K-steps."""
    tiles = lanes * -(-m // K1_TILE) * -(-cout // K1_TILE)
    steps = max(1, -(-cin // K1_TILE))
    if tiles >= sms or steps < MIN_SPLIT_STEPS:
        return 1, steps * K1_TILE
    want = min(MAX_SPLIT, steps // MIN_CHUNK_STEPS, -(-sms // tiles))
    per = max(MIN_CHUNK_STEPS, -(-steps // want))
    return -(-steps // per), per * K1_TILE


@functools.lru_cache(maxsize=1024)
def _plan(lanes: int, m: int, cin: int, cout: int, dev: int
          ) -> Tuple[int, int]:
    """``plan_split_k`` for CUDA device ``dev``'s SM count."""
    return plan_split_k(lanes, m, cin, cout, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def _residual(r: torch.Tensor, shape, like: torch.Tensor, add_params):
    """Check the residual of a fused conv -> add against the output
    ``shape``; returns (r's pointer, its batch stride in bytes, ma, mb,
    zp_a, zp_b, zp_out) for the kernel."""
    _require_int8("r", r)
    if r.shape != tuple(shape) or not _same_device(r, like):
        raise ValueError(f"r is {tuple(r.shape)} on {r.device}, expected "
                         f"{tuple(shape)} on {like.device}")
    _, r_bs = _lanes("r", r)
    mult_a, mult_b, zp_a, zp_b, zp_add = add_params
    ma, mb = ref.qadd_multipliers(mult_a, mult_b)
    return (r.data_ptr(), r_bs, ma, mb, int(zp_a), int(zp_b), int(zp_add))


def _out_hw(h: int, w: int, k: int, stride: int, hpad, wpad):
    oh = (h + hpad[0] + hpad[1] - k) // stride + 1
    ow = (w + wpad[0] + wpad[1] - k) // stride + 1
    return oh, ow


def ring_spans(start: int, n: int, rows: int):
    """(ring row, window row, length) runs of window rows ``start + j``
    (j < n) mapped to ring rows ``(start + j) % rows``."""
    j = 0
    while j < n:
        pos = (start + j) % rows
        length = min(rows - pos, n - j)
        yield pos, j, length
        j += length


@dataclasses.dataclass(frozen=True)
class RingWindow:
    """A cascade ring's halo'd window left where it lies: rows ``(src + j)
    % ring_rows`` (j < n) of ``ring`` [lanes, ring_rows, ...], in window
    order.  ``shape`` is the window's, as if it had been gathered."""
    ring: torch.Tensor
    src: int
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.ring.shape[0], self.n, *self.ring.shape[2:])

    def gather(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The window in row order, in ``out`` or a new tensor: one copy
        per contiguous span of ring rows."""
        ring = self.ring
        if out is None:
            out = torch.empty(self.shape, dtype=ring.dtype,
                              device=ring.device)
        for pos, j, length in ring_spans(self.src, self.n, ring.shape[1]):
            out[:, j:j + length] = ring[:, pos:pos + length]
        return out


def reads_in_place(x: RingWindow) -> bool:
    """Whether K2/K3 read ``x`` where it lies (on the card) rather than
    from a gathered copy (the plain versions on the CPU)."""
    return x.ring.is_cuda


def _ring(name: str, rows: int, src: int, n: Optional[int]
          ) -> Tuple[int, int]:
    """(the window's rows, its first ring row) of the window (src, n) of a
    ring of ``rows`` rows: ``src`` is any row of the stream (ring row
    ``src % rows``), ``n`` None is the whole of ``rows`` from row 0."""
    if n is None:
        if src:
            raise ValueError(f"{name}: src={src} needs the window's n")
        return rows, 0
    if src < 0 or n < 1:
        raise ValueError(f"{name}: ring window src={src}, n={n} is not a "
                         f"window of a ring")
    return n, src % rows


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


# K2's block (csrc/qdwconv.cu): DW_THREADS threads, one channel each of
# up to 4 output pixels along a row; ``cq`` threads across the channels
# (up to 128 channels), the rest over pixels.  A block is a chain of
# dependent steps on few warps, so more, shorter blocks pay until the
# grid has DW_BLOCKS_PER_SM blocks an SM (forced-plan device times on an
# H100, tools/kernel_times.py --ppt; PERF.md).
DW_THREADS = 128
DW_MAX_CHANNELS = 128
DW_BLOCKS_PER_SM = 2
DW_MAX_SMEM = 227 * 1024


def dw_tile(lanes: int, oh: int, ow: int, c: int, ppt: int
            ) -> Tuple[Tuple[int, int, int, int], int]:
    """K2's tile ``(cq, gx, gy, ppt)`` for ``ppt`` pixels a thread, and its
    grid's blocks: ``cq`` threads cover as many channels as C needs (a
    power of two, DW_MAX_CHANNELS at most), ``gx`` pixel groups go along
    the row first and the rest of the threads stack ``gy`` rows."""
    cq = min(DW_MAX_CHANNELS, _pow2(c))
    groups = DW_THREADS // cq
    gx = min(groups, _pow2(-(-ow // ppt)))
    gy = groups // gx
    blocks = lanes * -(-oh // gy) * -(-ow // (gx * ppt)) * -(-c // cq)
    return (cq, gx, gy, ppt), blocks


def plan_dw_tile(lanes: int, oh: int, ow: int, c: int,
                 sms: int) -> Tuple[int, int, int, int]:
    """K2's block tile ``(cq, gx, gy, ppt)`` (``dw_tile``) with ``ppt`` the
    largest of 4, 2, 1 whose grid reaches DW_BLOCKS_PER_SM blocks an SM of
    ``sms``, 1 where none does."""
    for ppt in (4, 2, 1):
        tile, blocks = dw_tile(lanes, oh, ow, c, ppt)
        if blocks >= DW_BLOCKS_PER_SM * sms:
            break
    return tile


def dw_smem(cq: int, gx: int, gy: int, ppt: int, k: int,
            stride: int) -> int:
    """Bytes of K2's shared memory: the input tile with its halo
    (csrc/qdwconv.cu; the scalar path stages none)."""
    return ((gy - 1) * stride + k) * ((gx * ppt - 1) * stride + k) * cq


def load_width(c: int, *addresses: int) -> int:
    """Bytes K2 moves per copy from or to an NHWC tensor of ``c`` channels
    whose pointer and lane stride (bytes) are ``addresses``: 16
    (``cp.async`` of 16 bytes) where ``c`` and all of them are multiples
    of 16, 4 where they are multiples of 4, else 1 (the scalar path).  A
    pixel's channels then lie in whole, aligned copies, rows and lanes
    included."""
    for a in addresses:
        c |= a
    return 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1


# K3/K5's block (csrc/qconv.cuh): QC_BM output pixels x an N tile of
# 8/16/32/64 channels (the smallest that holds Cout, 64 at most), K in
# 32-deep steps of int8 mma.sync.  Its shared memory holds the block's
# input rows for one chunk of Cin, the chunk's weights and their offsets.
QC_BM = 64
QC_KSTEP = 32
QC_SMEM = 96 * 1024
QC_MAX_SMEM = 227 * 1024


def qconv_smem(oh: int, ow: int, k: int, stride: int, ck: int,
               bn: int) -> int:
    """Bytes of K3's shared memory for a Cin chunk of ``ck`` channels: the
    input patch of QC_BM consecutive output pixels at most (rows of
    ``cols * ck`` bytes rounded up to 16), the transposed weight tile
    (``bn`` rows of the padded K + 16) and one int offset per padded K."""
    rows = (min(oh, (QC_BM - 1) // ow + 2) - 1) * stride + k
    pitch = -(-((ow - 1) * stride + k) * ck // 16) * 16
    kpad = -(-k * k * ck // QC_KSTEP) * QC_KSTEP
    return rows * pitch + bn * (kpad + 16) + 4 * kpad


def plan_qconv(oh: int, ow: int, cin: int, cout: int, k: int,
               stride: int) -> Tuple[int, int]:
    """K3/K5's ``(bn, ck)``: the N tile (8, 16, 32 or 64 columns) and the
    Cin chunk whose shared memory fits QC_SMEM (Cin whole where it fits,
    else halved until it does)."""
    bn = next(b for b in (8, 16, 32, 64) if cout <= b or b == 64)
    ck = cin
    while ck > 1 and qconv_smem(oh, ow, k, stride, ck, bn) > QC_SMEM:
        ck = -(-ck // 2)
    if qconv_smem(oh, ow, k, stride, ck, bn) > QC_MAX_SMEM:
        raise ValueError(f"qconv: an output row of {ow} pixels at k={k}, "
                         f"stride {stride} needs more shared memory than a "
                         f"block has")
    return bn, ck


# ------------------------------------------------------------------ kernels
def qconv1x1(x: torch.Tensor, w: torch.Tensor, *, mult: float, zp_in: int,
             zp_out: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: x [..., H, W, Cin] int8, w [Cin, Cout] int8 -> [..., H, W, Cout]
    int8; the stride-1, unpadded 1x1 case of ``qconv2d`` with fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    xs, ws = x.shape, w.shape
    m, cin = xs[-3] * xs[-2], xs[-1]
    if len(ws) != 2 or ws[0] != cin:
        raise ValueError(f"w must be [Cin={cin}, Cout], got {tuple(ws)}")
    shape = (*xs[:-1], ws[1])
    if x.is_cpu:
        return _plain(ref.qconv1x1_ref(x, w, mult=mult, zp_in=zp_in,
                                       zp_out=zp_out), out)
    out = _destination(out, shape, x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        # ctypes rounds mult to float32 as np.float32 does (to nearest)
        _launch("qconv1x1", x, w, out, lanes, m, cin, ws[1], x_bs, o_bs,
                float(mult), zp_in, zp_out, split_k=(lanes, m, cin, ws[1]))
        qconv1x1.launches += 1
    return out


def _launch_qconv(name: str, x: torch.Tensor, w: torch.Tensor,
                  out: torch.Tensor, lanes: int, x_bs: int, o_bs: int,
                  h: int, src: int, cout: int, oh: int, ow: int, k: int,
                  stride: int, hpad, wpad, mult: float, zp_in: int,
                  zp_out: int, *res) -> None:
    """K3 or K5 over ``lanes`` lanes, with their tile plan."""
    rows, wd, cin = x.shape[-3:]
    bn, ck = _qconv_plan(oh, ow, cin, cout, k, stride)
    _launch(name, x, w, out, lanes, h, rows, src, wd, cin, cout, oh, ow, k,
            stride, hpad[0], wpad[0], x_bs, o_bs, float(np.float32(mult)),
            zp_in, zp_out, *res, bn, ck)


_qconv_plan = functools.lru_cache(maxsize=1024)(plan_qconv)


def qconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
          zp_in: int, zp_out: int, hpad: Tuple[int, int],
          wpad: Tuple[int, int], out: Optional[torch.Tensor] = None,
          src: int = 0, n: Optional[int] = None) -> torch.Tensor:
    """K3: x [..., H, W, Cin] int8, w [k, k, Cin, Cout] int8 ->
    [..., OH, OW, Cout] int8, explicit (before, after) pads, fused ReLU.
    With ``n``, x is a ring and the input its window (src, n)."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    rows, wd, cin = x.shape[-3:]
    h, src = _ring("qconv", rows, src, n)
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != cin:
        raise ValueError(f"w must be [k, k, Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    k, cout = w.shape[0], w.shape[3]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        qp = dict(stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                  hpad=hpad, wpad=wpad)
        return _plain(ref.qconv_ref(x, w, **qp) if n is None else
                      ref.qconv_ring_ref(x, w, src=src, n=h, **qp), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, cout), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch_qconv("qconv", x, w, out, lanes, x_bs, o_bs, h, src, cout,
                      oh, ow, k, stride, hpad, wpad, mult, zp_in, zp_out)
        qconv.launches += 1
    return out


def qdwconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
            zp_in: int, zp_out: int, hpad: Tuple[int, int],
            wpad: Tuple[int, int], out: Optional[torch.Tensor] = None,
            src: int = 0, n: Optional[int] = None) -> torch.Tensor:
    """K2: x [..., H, W, C] int8, w [k, k, C] int8 -> [..., OH, OW, C] int8
    (depthwise), explicit (before, after) pads, fused ReLU.  With ``n``,
    x is a ring and the input its window (src, n)."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    rows, wd, c = x.shape[-3:]
    h, src = _ring("qdwconv", rows, src, n)
    if w.dim() != 3 or w.shape[0] != w.shape[1] or w.shape[2] != c:
        raise ValueError(f"w must be [k, k, C={c}], got {tuple(w.shape)}")
    k = w.shape[0]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        qp = dict(stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                  hpad=hpad, wpad=wpad)
        return _plain(ref.qdwconv_ref(x, w, **qp) if n is None else
                      ref.qdwconv_ring_ref(x, w, src=src, n=h, **qp), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, c), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _require_cuda("qdwconv", x, w, out)
        plan = _dw_plan(lanes, oh, ow, c, k, stride, x.get_device())
        _launch("qdwconv", x, w, out, lanes, h, rows, src, wd, c, oh, ow, k,
                stride, hpad[0], wpad[0], x_bs, o_bs,
                float(np.float32(mult)), zp_in, zp_out,
                load_width(c, x.data_ptr(), x_bs), *plan)
        qdwconv.launches += 1
    return out


@functools.lru_cache(maxsize=1024)
def _dw_plan(lanes: int, oh: int, ow: int, c: int, k: int, stride: int,
             dev: int) -> Tuple[int, int, int, int]:
    """``plan_dw_tile`` for CUDA device ``dev``'s SM count, refused where
    its tile would not fit a block's shared memory."""
    plan = plan_dw_tile(lanes, oh, ow, c, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    smem = dw_smem(*plan, k, stride)
    if smem > DW_MAX_SMEM:
        raise ValueError(f"qdwconv: k={k} at stride {stride} needs {smem} B "
                         f"of shared memory a block")
    return plan


def qconv1x1_add(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, *,
                 mult: float, zp_in: int, zp_out: int,
                 add_params: Tuple[float, float, int, int, int],
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: K1, then the fixed-point ``qadd`` with the residual ``r`` [...,
    H, W, Cout] int8; ``add_params = (mult_a, mult_b, zp_a, zp_b,
    zp_out)``, leg *a* being the conv's output."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    xs, ws = x.shape, w.shape
    m, cin = xs[-3] * xs[-2], xs[-1]
    if len(ws) != 2 or ws[0] != cin:
        raise ValueError(f"w must be [Cin={cin}, Cout], got {tuple(ws)}")
    shape = (*xs[:-1], ws[1])
    res = _residual(r, shape, x, add_params)
    if x.is_cpu:
        return _plain(ref.qconv1x1_add_ref(
            x, w, r, mult=mult, zp_in=zp_in, zp_out=zp_out,
            add_params=add_params), out)
    out = _destination(out, shape, x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qconv1x1_add", x, w, out, lanes, m, cin, ws[1], x_bs, o_bs,
                float(mult), zp_in, zp_out, *res,
                split_k=(lanes, m, cin, ws[1]))
        qconv1x1_add.launches += 1
    return out


def qconv_add(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, *,
              stride: int, mult: float, zp_in: int, zp_out: int,
              hpad: Tuple[int, int], wpad: Tuple[int, int],
              add_params: Tuple[float, float, int, int, int],
              out: Optional[torch.Tensor] = None, src: int = 0,
              n: Optional[int] = None) -> torch.Tensor:
    """K5: K3, then the fixed-point ``qadd`` with the residual ``r`` [...,
    OH, OW, Cout] int8."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    rows, wd, cin = x.shape[-3:]
    h, src = _ring("qconv_add", rows, src, n)
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != cin:
        raise ValueError(f"w must be [k, k, Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    k, cout = w.shape[0], w.shape[3]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    shape = (*x.shape[:-3], oh, ow, cout)
    res = _residual(r, shape, x, add_params)
    if x.device.type == "cpu":
        qp = dict(stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                  hpad=hpad, wpad=wpad, add_params=add_params)
        return _plain(ref.qconv_add_ref(x, w, r, **qp) if n is None else
                      ref.qconv_add_ring_ref(x, w, r, src=src, n=h, **qp),
                      out)
    out = _destination(out, shape, x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch_qconv("qconv_add", x, w, out, lanes, x_bs, o_bs, h, src,
                      cout, oh, ow, k, stride, hpad, wpad, mult, zp_in,
                      zp_out, *res)
        qconv_add.launches += 1
    return out


qconv1x1.launches = 0
qconv.launches = 0
qdwconv.launches = 0
qconv1x1_add.launches = 0
qconv_add.launches = 0
KERNEL_WRAPPERS = {"qconv1x1": qconv1x1, "qdwconv": qdwconv, "qconv": qconv,
                   "qconv1x1_add": qconv1x1_add, "qconv_add": qconv_add}


def _gathered(x: Union[torch.Tensor, RingWindow]) -> torch.Tensor:
    return x.gather() if isinstance(x, RingWindow) else x


def _in_place(x: Union[torch.Tensor, RingWindow]):
    """(tensor, ``src``/``n`` keywords) for the K2/K3 wrappers: a ring
    window the kernel reads where it lies, else a tensor (a window off the
    card gathered)."""
    if isinstance(x, RingWindow) and reads_in_place(x):
        return x.ring, {"src": x.src, "n": x.n}
    return _gathered(x), {}


def _is_1x1(k: int, stride: int, hpad, wpad) -> bool:
    return (k == 1 and stride == 1 and hpad in (None, (0, 0))
            and wpad in (None, (0, 0)))


# ------------------------------------------------------ q-op drop-ins
def qconv_fused(x: Union[torch.Tensor, RingWindow], w: torch.Tensor, *,
                stride: int, mult: float, zp_in: int, zp_out: int,
                hpad: Optional[Tuple[int, int]] = None,
                wpad: Optional[Tuple[int, int]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qconv2d`` (w in the graph's (k, k, Cin, Cout) layout,
    SAME pads unless ``hpad``/``wpad`` override them), bit-identical.
    k=1, stride=1 and no pads go to K1, everything else to K3.  ``x`` may
    be a ``RingWindow``: K3 reads it in place, K1 a gathered copy."""
    hpad = None if hpad is None else tuple(hpad)
    wpad = None if wpad is None else tuple(wpad)
    k = w.shape[0]
    if _is_1x1(k, stride, hpad, wpad):
        return qconv1x1(_gathered(x), w.reshape(w.shape[2:]), mult=mult,
                        zp_in=zp_in, zp_out=zp_out, out=out)
    hp = _pads(x.shape[-3], k, stride) if hpad is None else hpad
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else wpad
    x, ring = _in_place(x)
    return qconv(x, w, stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                 hpad=hp, wpad=wp, out=out, **ring)


def qconv_add_fused(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, *,
                    stride: int, mult: float, zp_in: int, zp_out: int,
                    add_params: Tuple[float, float, int, int, int],
                    hpad: Optional[Tuple[int, int]] = None,
                    wpad: Optional[Tuple[int, int]] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for a ``qconv2d -> qadd`` chain (residual ``r`` is the add's
    second leg), bit-identical to the two q-ops run separately.  ``w`` is
    in the graph's (k, k, Cin, Cout) layout; ``add_params = (mult_a,
    mult_b, zp_a, zp_b, zp_out)`` in the qadd argument order.  k=1,
    stride=1 and no pads go to K4, everything else to K5."""
    hpad = None if hpad is None else tuple(hpad)
    wpad = None if wpad is None else tuple(wpad)
    add_params = tuple(add_params)
    k = w.shape[0]
    if _is_1x1(k, stride, hpad, wpad):
        return qconv1x1_add(x, w.reshape(w.shape[2:]), r, mult=mult,
                            zp_in=zp_in, zp_out=zp_out,
                            add_params=add_params, out=out)
    hp = _pads(x.shape[-3], k, stride) if hpad is None else hpad
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else wpad
    return qconv_add(x, w, r, stride=stride, mult=mult, zp_in=zp_in,
                     zp_out=zp_out, hpad=hp, wpad=wp, add_params=add_params,
                     out=out)


def qdwconv_fused(x: Union[torch.Tensor, RingWindow], w: torch.Tensor, *,
                  stride: int, mult: float, zp_in: int, zp_out: int,
                  hpad: Optional[Tuple[int, int]] = None,
                  wpad: Optional[Tuple[int, int]] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qdwconv2d`` (w in the graph's (k, k, C, 1) layout),
    bit-identical; always K2, which reads a ``RingWindow`` ``x`` in
    place."""
    k = w.shape[0]
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else \
        tuple(wpad)
    x, ring = _in_place(x)
    return qdwconv(x, w.reshape(k, w.shape[1], x.shape[-1]), stride=stride,
                   mult=mult, zp_in=zp_in, zp_out=zp_out, hpad=hp, wpad=wp,
                   out=out, **ring)


__all__ = ["qconv1x1", "qconv", "qdwconv", "qconv1x1_add", "qconv_add",
           "qconv_fused", "qdwconv_fused", "qconv_add_fused",
           "KERNEL_WRAPPERS", "plan_split_k", "RingWindow", "ring_spans",
           "reads_in_place", "plan_dw_tile", "dw_tile", "dw_smem",
           "load_width",
           "plan_qconv", "qconv_smem"]
