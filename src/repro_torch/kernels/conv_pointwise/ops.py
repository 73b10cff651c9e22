"""Host wrapper of the float32 pointwise conv kernel K6, and
``conv1x1_fused``, the reference's name for it.

The device decides, not a knob (the reference's ``block_rows`` and
``interpret`` are gone): on a CUDA tensor the wrapper launches the Hopper
kernel or raises; on a CPU tensor it runs the plain version in ``ref.py``.
No path falls back from a failed build or launch to the plain version.

Tensors are NHWC with an optional leading batch dimension; one call over
``B`` lanes is one launch.  The kernel reads and writes arena views in
place: every lane's [H, W, C] block must be contiguous, and the lanes may
lie any number of elements apart (the batch stride is passed to the
kernel).  ``out`` (optional) is the destination view.  ``conv1x1.launches``
counts kernel launches and nothing else.

The kernel's tile shape and its split of Cin over a cluster of blocks come
from ``plan_split_k``, cached per shape and device; the blocks add their
partials through distributed shared memory, so nothing is allocated for
it.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.conv_quant.ops import _current_stream, _lanes

from . import ref
from .build import CONV_POINTWISE

# K6's tiles (csrc/conv1x1.cu): TILE_ROWS x TILE_COLS outputs, 4 x TILE_ROWS
# threads, Cin in K-steps of K_STEP channels.  The 64-row tile where its
# blocks alone reach BIG_TILE_BLOCKS per SM; else the 16-row tile, and
# where its blocks stay under SPLIT_BELOW_BLOCKS per SM, Cin is cut into
# enough chunks (at most MAX_SPLIT: a portable cluster) that the blocks
# reach SPLIT_TARGET_BLOCKS per SM, only when Cin spans MIN_SPLIT_STEPS
# K-steps, each chunk but the last keeping MIN_CHUNK_STEPS.  The thresholds
# come from forced device times on an H100 (tools/kernel_times.py
# --splits; PERF.md): at one lane the 16-row tile was as fast or faster at
# every MobileNet pointwise shape, at four lanes the 64-row one from ~2
# blocks per SM; a split paid below 2 blocks per SM, best near 4.
TILE_ROWS = (64, 16)
TILE_COLS = 64
K_STEP = 16
MAX_SPLIT = 8
BIG_TILE_BLOCKS = 2
SPLIT_BELOW_BLOCKS = 2
SPLIT_TARGET_BLOCKS = 4
MIN_SPLIT_STEPS = 4
MIN_CHUNK_STEPS = 2


def plan_split_k(lanes: int, m: int, cin: int, cout: int,
                 sms: int) -> Tuple[int, int, int]:
    """(tile rows, split, chunk) for K6: output tiles of ``tile rows`` x
    TILE_COLS, Cin in ``split`` chunks of ``chunk`` channels (a multiple
    of K_STEP), chunk ``s`` covering ``[s * chunk, min(cin, (s + 1) *
    chunk))``, no chunk empty."""
    cols = -(-cout // TILE_COLS)
    steps = max(1, -(-cin // K_STEP))
    big, small = TILE_ROWS
    if lanes * -(-m // big) * cols >= BIG_TILE_BLOCKS * sms:
        return big, 1, steps * K_STEP
    blocks = lanes * -(-m // small) * cols
    if blocks >= SPLIT_BELOW_BLOCKS * sms or steps < MIN_SPLIT_STEPS:
        return small, 1, steps * K_STEP
    want = min(MAX_SPLIT, steps // MIN_CHUNK_STEPS,
               -(-SPLIT_TARGET_BLOCKS * sms // blocks))
    per = max(MIN_CHUNK_STEPS, -(-steps // want))
    return small, -(-steps // per), per * K_STEP


@functools.lru_cache(maxsize=1024)
def _plan(lanes: int, m: int, cin: int, cout: int, dev: int
          ) -> Tuple[int, int, int]:
    """``plan_split_k`` for CUDA device ``dev``'s SM count."""
    return plan_split_k(lanes, m, cin, cout, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None, *, relu: bool = True,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: x [..., H, W, Cin] float, w [Cin, Cout], b [Cout] or None ->
    [..., H, W, Cout]; the fused pointwise conv + bias + ReLU."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        # an integer input would be silently truncated instead of
        # requantized: int8 convs go through the fused int8 kernels
        raise TypeError(
            f"conv1x1 is the float kernel (got x dtype "
            f"{getattr(x, 'dtype', type(x))}); quantized convs route "
            f"through repro_torch.kernels.qconv_fused, which requantizes "
            f"exactly")
    lanes, x_bs = _lanes("x", x)
    xs, ws = x.shape, w.shape
    h, wd, cin = xs[-3:]
    if len(ws) != 2 or ws[0] != cin:
        raise ValueError(f"w must be [Cin={cin}, Cout], got {tuple(ws)}")
    cout = ws[1]
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"b must be [Cout={cout}], got {tuple(b.shape)}")
    shape = (*xs[:-1], cout)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"out is {tuple(out.shape)}, expected {shape}")
    if x.is_cpu:
        y = ref.conv1x1_ref(x, w, b, relu=relu)
        if out is None:
            return y
        out.copy_(y)
        return out
    for name, t in (("x", x), ("w", w), ("b", b), ("out", out)):
        if t is not None and (t.dtype != torch.float32 or not t.is_cuda):
            raise ValueError(f"conv1x1: {name} must be a float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if not w.is_contiguous() or (b is not None and not b.is_contiguous()):
        raise ValueError("conv1x1: w and b must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _, o_bs = _lanes("out", out)
    if out.numel():
        dev = x.get_device()
        m = h * wd
        CONV_POINTWISE.launch(
            "conv1x1", x.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), lanes, m,
            cin, cout, x_bs, o_bs, int(relu), *_plan(lanes, m, cin, cout, dev),
            dev, _current_stream(dev))
        conv1x1.launches += 1
    return out


conv1x1.launches = 0
# the reference's public name (``repro.kernels.conv1x1_fused``)
conv1x1_fused = conv1x1
KERNEL_WRAPPERS = {"conv1x1": conv1x1}

__all__ = ["KERNEL_WRAPPERS", "conv1x1", "conv1x1_fused", "plan_split_k"]
