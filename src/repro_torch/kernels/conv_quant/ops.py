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
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            *args, split_k: Optional[Tuple[int, int, int, int]] = None
            ) -> None:
    """Launch kernel ``name`` on the current stream; ``split_k = (lanes,
    m, cin, cout)`` appends K1/K4's split-K plan (split, chunk)."""
    if not (x.is_cuda and w.is_cuda and out.is_cuda):
        raise ValueError(f"{name}: x, w and out must all be CUDA tensors")
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


def qconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
          zp_in: int, zp_out: int, hpad: Tuple[int, int],
          wpad: Tuple[int, int],
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: x [..., H, W, Cin] int8, w [k, k, Cin, Cout] int8 ->
    [..., OH, OW, Cout] int8, explicit (before, after) pads, fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, cin = x.shape[-3:]
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != cin:
        raise ValueError(f"w must be [k, k, Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    k, cout = w.shape[0], w.shape[3]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        return _plain(ref.qconv_ref(x, w, stride=stride, mult=mult,
                                    zp_in=zp_in, zp_out=zp_out, hpad=hpad,
                                    wpad=wpad), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, cout), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qconv", x, w, out, lanes, h, wd, cin, cout, oh, ow, k,
                stride, hpad[0], wpad[0], x_bs, o_bs,
                float(np.float32(mult)), zp_in, zp_out)
        qconv.launches += 1
    return out


def qdwconv(x: torch.Tensor, w: torch.Tensor, *, stride: int, mult: float,
            zp_in: int, zp_out: int, hpad: Tuple[int, int],
            wpad: Tuple[int, int],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: x [..., H, W, C] int8, w [k, k, C] int8 -> [..., OH, OW, C] int8
    (depthwise), explicit (before, after) pads, fused ReLU."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, c = x.shape[-3:]
    if w.dim() != 3 or w.shape[0] != w.shape[1] or w.shape[2] != c:
        raise ValueError(f"w must be [k, k, C={c}], got {tuple(w.shape)}")
    k = w.shape[0]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    if x.device.type == "cpu":
        return _plain(ref.qdwconv_ref(x, w, stride=stride, mult=mult,
                                      zp_in=zp_in, zp_out=zp_out, hpad=hpad,
                                      wpad=wpad), out)
    out = _destination(out, (*x.shape[:-3], oh, ow, c), x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qdwconv", x, w, out, lanes, h, wd, c, oh, ow, k, stride,
                hpad[0], wpad[0], x_bs, o_bs, float(np.float32(mult)),
                zp_in, zp_out)
        qdwconv.launches += 1
    return out


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
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: K3, then the fixed-point ``qadd`` with the residual ``r`` [...,
    OH, OW, Cout] int8."""
    _require_int8("x", x)
    _require_int8("w", w)
    lanes, x_bs = _lanes("x", x)
    h, wd, cin = x.shape[-3:]
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != cin:
        raise ValueError(f"w must be [k, k, Cin={cin}, Cout], got "
                         f"{tuple(w.shape)}")
    k, cout = w.shape[0], w.shape[3]
    oh, ow = _out_hw(h, wd, k, stride, hpad, wpad)
    shape = (*x.shape[:-3], oh, ow, cout)
    res = _residual(r, shape, x, add_params)
    if x.device.type == "cpu":
        return _plain(ref.qconv_add_ref(
            x, w, r, stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
            hpad=hpad, wpad=wpad, add_params=add_params), out)
    out = _destination(out, shape, x)
    _, o_bs = _lanes("out", out)
    if out.numel():
        _launch("qconv_add", x, w, out, lanes, h, wd, cin, cout, oh, ow, k,
                stride, hpad[0], wpad[0], x_bs, o_bs,
                float(np.float32(mult)), zp_in, zp_out, *res)
        qconv_add.launches += 1
    return out


qconv1x1.launches = 0
qconv.launches = 0
qdwconv.launches = 0
qconv1x1_add.launches = 0
qconv_add.launches = 0
KERNEL_WRAPPERS = {"qconv1x1": qconv1x1, "qdwconv": qdwconv, "qconv": qconv,
                   "qconv1x1_add": qconv1x1_add, "qconv_add": qconv_add}


def _is_1x1(k: int, stride: int, hpad, wpad) -> bool:
    return (k == 1 and stride == 1 and hpad in (None, (0, 0))
            and wpad in (None, (0, 0)))


# ------------------------------------------------------ q-op drop-ins
def qconv_fused(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                mult: float, zp_in: int, zp_out: int,
                hpad: Optional[Tuple[int, int]] = None,
                wpad: Optional[Tuple[int, int]] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qconv2d`` (w in the graph's (k, k, Cin, Cout) layout,
    SAME pads unless ``hpad``/``wpad`` override them), bit-identical.
    k=1, stride=1 and no pads go to K1, everything else to K3."""
    hpad = None if hpad is None else tuple(hpad)
    wpad = None if wpad is None else tuple(wpad)
    k = w.shape[0]
    if _is_1x1(k, stride, hpad, wpad):
        return qconv1x1(x, w.reshape(w.shape[2:]), mult=mult, zp_in=zp_in,
                        zp_out=zp_out, out=out)
    hp = _pads(x.shape[-3], k, stride) if hpad is None else hpad
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else wpad
    return qconv(x, w, stride=stride, mult=mult, zp_in=zp_in, zp_out=zp_out,
                 hpad=hp, wpad=wp, out=out)


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


def qdwconv_fused(x: torch.Tensor, w: torch.Tensor, *, stride: int,
                  mult: float, zp_in: int, zp_out: int,
                  hpad: Optional[Tuple[int, int]] = None,
                  wpad: Optional[Tuple[int, int]] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drop-in for ``qdwconv2d`` (w in the graph's (k, k, C, 1) layout),
    bit-identical; always K2."""
    k = w.shape[0]
    hp = _pads(x.shape[-3], k, stride) if hpad is None else tuple(hpad)
    wp = _pads(x.shape[-2], w.shape[1], stride) if wpad is None else \
        tuple(wpad)
    return qdwconv(x, w.reshape(k, w.shape[1], x.shape[-1]), stride=stride,
                   mult=mult, zp_in=zp_in, zp_out=zp_out, hpad=hp, wpad=wp,
                   out=out)


__all__ = ["qconv1x1", "qconv", "qdwconv", "qconv1x1_add", "qconv_add",
           "qconv_fused", "qdwconv_fused", "qconv_add_fused",
           "KERNEL_WRAPPERS", "plan_split_k"]
