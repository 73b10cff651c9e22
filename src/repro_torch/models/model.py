"""The decoder stacks of ``src/repro/models/model.py`` on PyTorch.

The port builds the reference's four layouts (``model_layout``), with
the same parameter names, shapes, scales and dtypes, the same decode cache
and the same prefill / greedy decode contract:

* ``"uniform"`` — dense, MoE and vision-language decoders (Llama, Qwen2,
  Phi-3, GLM-4, Granite-MoE, Phi-3.5-MoE, InternVL2): one stack of
  attention blocks over stacked per-layer parameters ``[L, ...]``,
  ``moe.moe_ffn`` in place of the SwiGLU FFN for MoE; a VLM's patch
  embeddings (``batch["patches"]`` through ``vis_proj``) come before the
  token rows and take positions like them;
* ``"encdec"`` — Whisper: a non-causal encoder stack (``params
  ["encoder"]``) over the frame embeddings (``batch["frames"]`` through
  ``frame_proj``), and a decoder stack whose blocks add a cross-attention
  sub-block over the encoder's keys and values, which prefill computes
  once per layer into the cache (``ck``/``cv``) and every decode step
  reads;
* ``"zamba"`` — the Zamba2 hybrid: groups of Mamba2 layers
  (``params["mamba"]``, stacked ``[groups·per_group, ...]``), each group
  followed by one weight-shared attention block
  (``params["shared_attn"]``, unstacked) with its own K/V cache layer;
* ``"xlstm"`` — groups of mLSTM layers closed by one sLSTM layer
  (``params["mlstm"]``, ``params["slstm"]``).

The modality front ends are stubs, as in the reference: frames and patches
arrive as embeddings.  The recurrences are ``ssm.py``'s, in plain PyTorch
on either device, as the reference computes them in ``jnp``.  The
reference's scans over layers and groups are loops here; the traced form
of the decode step wraps the layer stack in one functional operator —
``torch.ops.repro_torch.decode_layers`` for the uniform and encoder-decoder
stacks, ``torch.ops.repro_torch.decode_recurrent_layers`` for the other
two — the counterpart of the reference's outer scan equation, so that the
paper's reordering (``serving.ServingEngine.analyse_decode_schedule``)
sees the layer stack as one operator, as the reference's jaxpr does.

The device decides the attention, as it does for the CNN kernels: on CUDA
tensors prefill runs the flash-attention kernel K7 (causal, and
non-causal for Whisper's encoder and cross attention) and each decode step
the decode-attention kernel K8 (over the self cache's valid prefix, and
over all ``encoder_seq`` rows of the cross cache); on CPU tensors the
same calls go to the plain ``layers.chunked_attention`` /
``layers.decode_attention``, as the reference's model does.  The kernels
are the same computation as the reference's jnp attention
(``src/repro/models/layers.py:7-9``, ``:135``), but for one reference
fault the port does not copy: its chunked attention gives weight to the
zero keys that pad a ragged last chunk when ``causal=False`` (ROADMAP R6;
Whisper's 1 500 frames in chunks of 512); the port's masks them.

A sliding window ``W`` runs on both routes: K7 takes it as a launch
argument for causal self-attention (not for Whisper's encoder or cross
attention, as the CPU path), and the decode cache is a ring of ``Sc =
min(cache_len, W)`` slots holding position ``p`` at slot ``p % Sc``, so
the valid slots for the token at ``pos`` are always the prefix ``0 ..
min(pos + 1, Sc) - 1`` that K8 takes as its lengths.  Here the port
departs from the reference (ROADMAP R8): the reference's prefill keeps a
prompt longer than the ring at slots ``0 .. Sc-1`` in order while its
decode step writes ``pos % Sc``, so for ``S > Sc`` with ``S % Sc != 0``
the step overwrites a position still inside the window; the port's
prefill writes the ring rule, and its decode steps equal the reference's
own windowed prefill.

The mesh code (``model.py:51-74``, ``:129-390``, ``:402-532``,
``:753-785``): ``param_specs`` / ``cache_specs`` give the reference's
partition specs (``sharding.P``), ``Model(cfg, mesh)`` runs on DTensors
placed by them, constrained where the reference constrains (``_shard``),
with mapped bodies (``sharding.local_map``) for the attention on each
rank's heads (K7 and K8 on the card), the sequence-sharded decode
attention (``_seqshard_decode_attn``), the recurrences on each rank's
heads and the MoE's expert-parallel path (``moe.moe_ffn``).

Training (``Model.loss_fn``, reference ``model.py:924-985``) runs the
whole depth through ``layers.chunked_attention`` on either device, with
the configured sliding window, as the reference trains through its jnp
chunked attention (``src/repro/models/layers.py:1-9``): K7 has no
backward, in the reference or here.  Its layer stack (``_seq_stack``)
takes no cache, checkpoints one layer (one group for Zamba2 and xLSTM) a
body with ``remat``, and indexes the stacked parameters by one
``unbind`` each: under autograd an index ``t[i]`` a layer would give
every layer's backward a zero tensor of the whole stack.

One departure from the reference: the decode step updates its cache in
place — the new token's K/V, ``kv_pos``, ``pos``, each layer's conv
window and recurrent state — where the reference returns a new one (a
copy per step would move the whole cache, 235 MB per request for
Llama-3.2-3B at 2048 positions).  ``pos`` and ``kv_pos`` lie on the
cache's device, and the step derives its cache slot, valid lengths and
RoPE angles from ``pos`` there: it makes no host read, so one captured
step can be replayed (``serving.ServingEngine``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ReproError

from . import ssm
from .sharding import (P, all_reduce, axis_rank, axis_sizes, distribute,
                       empty_like_spec, full, gathered, is_dtensor, local,
                       local_map, replicate, shard, spec_of)
from .layers import (NEG, apply_rope, chunked_attention,
                     decode_attention, rms_norm, rope_angles, swiglu)
from .moe import _bmm_f32, moe_ffn

Params = Dict[str, Any]

# the reference's architecture kinds (configs/base.py: ModelConfig.arch_type)
_KINDS = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


class UnsupportedConfigError(ReproError, NotImplementedError):
    """A model configuration the port does not build: an ``arch_type`` the
    reference does not have."""


def check_config(cfg: ModelConfig) -> None:
    """Raise ``UnsupportedConfigError`` unless ``cfg``'s ``arch_type`` is
    one of the reference's."""
    if cfg.arch_type not in _KINDS:
        raise UnsupportedConfigError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is none of {_KINDS}")


def _on_card(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """Whether ``x``'s layer runs the kernels K7/K8 (CUDA tensors) or the
    plain attention (CPU tensors)."""
    return x.is_cuda


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _device(device) -> torch.device:
    """``resolve_device``, and ``"meta"`` for shapes without storage."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# ----------------------------------------------------------------- layout
@dataclasses.dataclass(frozen=True)
class Layout:
    """How the stacked parameter groups tile the depth of the network."""
    kind: str                 # uniform | zamba | xlstm | encdec
    groups: int = 0           # hybrid groups
    per_group: int = 0        # inner layers per group


def model_layout(cfg: ModelConfig) -> Layout:
    if cfg.arch_type == "hybrid":
        return Layout("zamba", groups=cfg.num_layers // 6, per_group=6)
    if cfg.arch_type == "ssm":
        return Layout("xlstm", groups=cfg.num_layers // 6, per_group=6)
    if cfg.arch_type == "audio":
        return Layout("encdec")
    return Layout("uniform")


# the cache tensors each layout's layer stack updates, in the order the
# traced form's operator takes and returns them
STACK_STATE = {
    "uniform": ("k", "v"),
    "encdec": ("k", "v"),       # the cross cache ck/cv is read, not updated
    "zamba": ("conv_x", "conv_B", "conv_C", "state", "k", "v"),
    "xlstm": ("mstate", "sc", "sn", "sh", "sm"),
}
# the parameter trees each recurrent layout's stack reads
_STACK_TREES = {"zamba": ("mamba", "shared_attn"),
                "xlstm": ("mlstm", "slstm")}


# ------------------------------------------------------------------- init
class _Init:
    """Draws the reference's ``_init(key, shape, scale, dtype)`` values'
    distribution (``model.py:78-79``) on ``dev`` from ``generator``; on
    the meta device only shapes."""

    def __init__(self, dev: torch.device, generator, dtype: torch.dtype):
        self.dev, self.generator, self.dt = dev, generator, dtype

    def normal(self, shape, scale, dtype=None):
        dtype = dtype or self.dt
        if self.dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.dev)
        t = torch.randn(shape, generator=self.generator,
                        dtype=torch.float32, device=self.dev)
        return t.mul_(scale).to(dtype)

    def const(self, shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=self.dev)


def _attn_block_params(cfg: ModelConfig, init: _Init, n_layers: int,
                       cross: bool = False) -> Params:
    """An attention block with its FFN (``model.py:82-126``): stacked
    ``[n_layers, ...]``, or unstacked when ``n_layers`` is 0; ``cross``
    adds Whisper's cross-attention weights, H heads for its K/V too."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt, f32 = init.dt, torch.float32
    L = (n_layers,) if n_layers else ()
    s_in = 1.0 / math.sqrt(d)
    p = {
        "ln1": init.const(L + (d,), 1.0, f32),
        "wq": init.normal(L + (d, H, hd), s_in),
        "wk": init.normal(L + (d, K, hd), s_in),
        "wv": init.normal(L + (d, K, hd), s_in),
        "wo": init.normal(L + (H, hd, d), 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = init.const(L + (H, hd), 0.0, dt)
        p["bk"] = init.const(L + (K, hd), 0.0, dt)
        p["bv"] = init.const(L + (K, hd), 0.0, dt)
    if cross:
        p.update({
            "ln_x": init.const(L + (d,), 1.0, f32),
            "wq_x": init.normal(L + (d, H, hd), s_in),
            "wk_x": init.normal(L + (d, H, hd), s_in),
            "wv_x": init.normal(L + (d, H, hd), s_in),
            "wo_x": init.normal(L + (H, hd, d), 1.0 / math.sqrt(H * hd)),
        })
    ff = cfg.d_ff
    if cfg.is_moe:
        E = cfg.num_experts
        p.update({
            "ln2": init.const(L + (d,), 1.0, f32),
            "router": init.normal(L + (d, E), s_in, f32),
            "we_g": init.normal(L + (E, d, ff), s_in),
            "we_u": init.normal(L + (E, d, ff), s_in),
            "we_d": init.normal(L + (E, ff, d), 1.0 / math.sqrt(ff)),
        })
    elif ff:
        p.update({
            "ln2": init.const(L + (d,), 1.0, f32),
            "wg": init.normal(L + (d, ff), s_in),
            "wu": init.normal(L + (d, ff), s_in),
            "wdn": init.normal(L + (ff, d), 1.0 / math.sqrt(ff)),
        })
    return p


def _mamba_block_params(cfg: ModelConfig, init: _Init,
                        n_layers: int) -> Params:
    """Mamba2 layers, stacked (``model.py:166-189``)."""
    d, N = cfg.d_model, cfg.ssm_state
    H, Ph, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_width
    f32 = torch.float32
    L = (n_layers,)
    s = 1.0 / math.sqrt(d)
    return {
        "ln": init.const(L + (d,), 1.0, f32),
        "w_x": init.normal(L + (d, H, Ph), s),
        "w_z": init.normal(L + (d, H, Ph), s),
        "w_B": init.normal(L + (d, N), s),
        "w_C": init.normal(L + (d, N), s),
        "w_dt": init.normal(L + (d, H), s),
        "conv_x": init.normal(L + (W, H, Ph), 0.5, f32),
        "conv_B": init.normal(L + (W, N), 0.5, f32),
        "conv_C": init.normal(L + (W, N), 0.5, f32),
        "A_log": init.const(L + (H,), 0.0, f32),
        "D": init.const(L + (H,), 1.0, f32),
        "dt_bias": init.const(L + (H,), 0.0, f32),
        "out_norm": init.const(L + (H, Ph), 1.0, f32),
        "w_out": init.normal(L + (H, Ph, d), 1.0 / math.sqrt(H * Ph)),
    }


def _xlstm_block_params(cfg: ModelConfig, init: _Init, n_layers: int,
                        kind: str) -> Params:
    """mLSTM or sLSTM layers, stacked (``model.py:213-240``)."""
    d, H = cfg.d_model, cfg.num_heads
    Ph = d // H
    f32 = torch.float32
    L = (n_layers,)
    s = 1.0 / math.sqrt(d)
    if kind == "mlstm":
        return {
            "ln": init.const(L + (d,), 1.0, f32),
            "w_q": init.normal(L + (d, H, Ph), s),
            "w_k": init.normal(L + (d, H, Ph), s),
            "w_v": init.normal(L + (d, H, Ph), s),
            "w_ig": init.normal(L + (d, H), s, f32),
            "w_fg": init.normal(L + (d, H), s, f32),
            "fg_bias": init.const(L + (H,), 3.0, f32),
            "out_norm": init.const(L + (H, Ph), 1.0, f32),
            "w_o": init.normal(L + (H, Ph, d), 1.0 / math.sqrt(d)),
        }
    return {   # slstm
        "ln": init.const(L + (d,), 1.0, f32),
        "w_in": init.normal(L + (d, 4, H, Ph), s),
        "r": init.normal(L + (4, H, Ph, Ph), 1.0 / math.sqrt(Ph), f32),
        "b": init.const(L + (4, H, Ph), 0.0, f32),
        "w_o": init.normal(L + (d, d), s),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, mesh=None) -> Params:
    """Random parameters with the reference's names, shapes, scales and
    dtypes (``model.py:78-240``, ``:285-316``), drawn on ``device`` (None:
    the card; ``"meta"``: shapes only) from ``generator`` (None: a new one
    on that device seeded with 0).  Values differ from the reference's:
    the two packages' generators differ.  With a ``mesh`` every rank
    draws the whole tree from the same seed and keeps its pieces:
    DTensors placed by ``param_specs``."""
    if mesh is not None:
        return shard_params(init_params(cfg, generator, device), cfg, mesh)
    check_config(cfg)
    dev = _device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    init = _Init(dev, generator, _dtype(cfg))
    d, V = cfg.d_model, cfg.padded_vocab
    lay = model_layout(cfg)
    p: Params = {"embed": init.normal((V, d), 1.0),
                 "final_norm": init.const((d,), 1.0, torch.float32)}
    if not cfg.tie_embeddings:
        p["head"] = init.normal((d, V), 1.0 / math.sqrt(d))
    if lay.kind == "zamba":
        p["mamba"] = _mamba_block_params(cfg, init,
                                         lay.groups * lay.per_group)
        p["shared_attn"] = _attn_block_params(cfg, init, 0)
    elif lay.kind == "xlstm":
        p["mlstm"] = _xlstm_block_params(
            cfg, init, lay.groups * (lay.per_group - 1), "mlstm")
        p["slstm"] = _xlstm_block_params(cfg, init, lay.groups, "slstm")
    elif lay.kind == "encdec":
        p["encoder"] = _attn_block_params(cfg, init, cfg.encoder_layers)
        p["blocks"] = _attn_block_params(cfg, init, cfg.num_layers,
                                         cross=True)
    else:
        p["blocks"] = _attn_block_params(cfg, init, cfg.num_layers)
    fd = cfg.frontend_dim
    if cfg.num_patch_tokens:
        p["vis_proj"] = init.normal((fd, d), 1.0 / math.sqrt(fd))
    if lay.kind == "encdec":
        p["frame_proj"] = init.normal((fd, d), 1.0 / math.sqrt(fd))
    return p


# ------------------------------------------------------------------ mesh
def _tp(cfg: ModelConfig, mesh, n: int) -> Optional[str]:
    """'model' when n divides evenly over the tensor-parallel axis
    (``model.py:57-61``)."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return None
    return "model" if n % sizes["model"] == 0 else None


DP = ("data",)   # batch axes; the launcher extends this with "pod"


def resolve_kv_mode(cfg: ModelConfig, mesh) -> str:
    """Decode-cache sharding mode (``model.py:67-74``, ModelConfig.kv_mode):
    "heads" shards the cache's KV heads over "model" (replicated where they
    do not divide it), "sequence" its rows."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        return "heads"
    if cfg.kv_mode != "auto":
        return cfg.kv_mode
    return "heads" if cfg.num_kv_heads % sizes["model"] == 0 \
        else "sequence"


def _attn_block_specs(cfg: ModelConfig, mesh, n_layers: int,
                      cross: bool = False) -> Params:
    """``model.py:129-163``."""
    tpH = _tp(cfg, mesh, cfg.num_heads)
    tpK = _tp(cfg, mesh, cfg.num_kv_heads)
    L = (None,) if n_layers else ()
    p = {
        "ln1": P(*L, None),
        "wq": P(*L, "data", tpH, None),
        "wk": P(*L, "data", tpK, None),
        "wv": P(*L, "data", tpK, None),
        "wo": P(*L, tpH, None, "data"),
    }
    if cfg.qkv_bias:
        p["bq"] = P(*L, tpH, None)
        p["bk"] = P(*L, tpK, None)
        p["bv"] = P(*L, tpK, None)
    if cross:
        p.update({"ln_x": P(*L, None),
                  "wq_x": P(*L, "data", tpH, None),
                  "wk_x": P(*L, "data", tpH, None),
                  "wv_x": P(*L, "data", tpH, None),
                  "wo_x": P(*L, tpH, None, "data")})
    if cfg.is_moe:
        p.update({"ln2": P(*L, None),
                  "router": P(*L, None, None),
                  "we_g": P(*L, "model", "data", None),
                  "we_u": P(*L, "model", "data", None),
                  "we_d": P(*L, "model", None, "data")})
    elif cfg.d_ff:
        tpF = _tp(cfg, mesh, cfg.d_ff)
        p.update({"ln2": P(*L, None),
                  "wg": P(*L, "data", tpF),
                  "wu": P(*L, "data", tpF),
                  "wdn": P(*L, tpF, "data")})
    return p


def _mamba_block_specs(cfg: ModelConfig, mesh, n_layers: int) -> Params:
    """``model.py:192-210``."""
    tpH = _tp(cfg, mesh, cfg.ssm_heads)
    L = (None,)
    return {
        "ln": P(*L, None),
        "w_x": P(*L, "data", tpH, None),
        "w_z": P(*L, "data", tpH, None),
        "w_B": P(*L, "data", None),
        "w_C": P(*L, "data", None),
        "w_dt": P(*L, "data", tpH),
        "conv_x": P(*L, None, tpH, None),
        "conv_B": P(*L, None, None),
        "conv_C": P(*L, None, None),
        "A_log": P(*L, tpH),
        "D": P(*L, tpH),
        "dt_bias": P(*L, tpH),
        "out_norm": P(*L, tpH, None),
        "w_out": P(*L, tpH, None, "data"),
    }


def _xlstm_block_specs(cfg: ModelConfig, mesh, n_layers: int,
                       kind: str) -> Params:
    """``model.py:243-260``."""
    tpH = _tp(cfg, mesh, cfg.num_heads)
    L = (None,)
    if kind == "mlstm":
        return {"ln": P(*L, None),
                "w_q": P(*L, "data", tpH, None),
                "w_k": P(*L, "data", tpH, None),
                "w_v": P(*L, "data", tpH, None),
                "w_ig": P(*L, "data", tpH),
                "w_fg": P(*L, "data", tpH),
                "fg_bias": P(*L, tpH),
                "out_norm": P(*L, tpH, None),
                "w_o": P(*L, tpH, None, "data")}
    return {"ln": P(*L, None),
            "w_in": P(*L, "data", None, tpH, None),
            "r": P(*L, None, tpH, None, None),
            "b": P(*L, None, tpH, None),
            "w_o": P(*L, "data", None)}


def param_specs(cfg: ModelConfig, mesh) -> Params:
    """The partition spec of every parameter (``model.py:319-372``): a tree
    like ``init_params``'.  ``act_shard="cp"`` keeps the weights off the
    "model" axis (but the experts and the router); ``moe_fsdp=False``
    keeps the experts off "data"; without a mesh every spec is ``P()``."""
    lay = model_layout(cfg)
    tpV = _tp(cfg, mesh, cfg.padded_vocab)
    p: Params = {"embed": P(tpV, "data"), "final_norm": P(None)}
    if not cfg.tie_embeddings:
        p["head"] = P("data", tpV)
    if lay.kind == "uniform":
        p["blocks"] = _attn_block_specs(cfg, mesh, cfg.num_layers)
    elif lay.kind == "zamba":
        p["mamba"] = _mamba_block_specs(cfg, mesh, lay.groups * lay.per_group)
        p["shared_attn"] = _attn_block_specs(cfg, mesh, 0)
    elif lay.kind == "xlstm":
        p["mlstm"] = _xlstm_block_specs(
            cfg, mesh, lay.groups * (lay.per_group - 1), "mlstm")
        p["slstm"] = _xlstm_block_specs(cfg, mesh, lay.groups, "slstm")
    elif lay.kind == "encdec":
        p["encoder"] = _attn_block_specs(cfg, mesh, cfg.encoder_layers)
        p["blocks"] = _attn_block_specs(cfg, mesh, cfg.num_layers, cross=True)
    if cfg.num_patch_tokens:
        p["vis_proj"] = P(None, "data")
    if cfg.arch_type == "audio":
        p["frame_proj"] = P(None, "data")
    if cfg.act_shard == "cp":
        def strip(spec):
            return P(*(None if ax == "model" else ax for ax in spec))
        for blk in ("blocks", "encoder", "mamba", "shared_attn", "mlstm",
                    "slstm"):
            if blk in p:
                p[blk] = {k: (v if k.startswith("we_") or k == "router"
                              else strip(v)) for k, v in p[blk].items()}
        p["embed"] = strip(p["embed"])
        if "head" in p:
            p["head"] = strip(p["head"])
    if not cfg.moe_fsdp and "blocks" in p:
        for k in ("we_g", "we_u", "we_d"):
            if k in p["blocks"]:
                p["blocks"][k] = P(*("model" if ax == "model" else None
                                     for ax in p["blocks"][k]))
    if mesh is None:
        p = _tree_map_specs(lambda _: P(), p)
    return p


def _tree_map_specs(fn, tree):
    return {k: _tree_map_specs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch axes, "pod" and "data" (``model.py:375-378``)."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _dp_for(mesh, batch: int) -> Tuple[str, ...]:
    """Batch axes, but only when the batch divides them (long_500k has
    global_batch=1 -> replicate instead of sharding over data;
    ``model.py:381-390``)."""
    dp = _dp_axes(mesh)
    if not dp:
        return ()
    sizes = axis_sizes(mesh)
    return dp if batch % math.prod(sizes[a] for a in dp) == 0 else ()


def _shard(x, mesh, *spec):
    """The reference's ``with_sharding_constraint`` (``model.py:51-54``):
    ``x`` redistributed to ``spec`` on ``mesh``; the identity without
    one."""
    return shard(x, mesh, P(*spec))


def cache_specs(cfg: ModelConfig, mesh, batch_size: int = 0) -> Params:
    """The partition spec of every decode-cache tensor (``model.py:
    753-785``): the batch over ``_dp_for`` (all batch axes when
    ``batch_size`` is 0), K/V over "model" by heads or, in "sequence"
    mode, by rows."""
    if mesh is None:
        return {k: P() for k in init_cache(cfg, 1, 8, device="meta")}
    dp = _dp_for(mesh, batch_size) if batch_size else _dp_axes(mesh)
    tpK = _tp(cfg, mesh, cfg.num_kv_heads)
    tpH = _tp(cfg, mesh, cfg.num_heads)
    tpHs = _tp(cfg, mesh, cfg.ssm_heads)
    lay = model_layout(cfg)
    c: Params = {"pos": P()}
    if lay.kind in ("uniform", "encdec", "zamba"):
        if resolve_kv_mode(cfg, mesh) == "sequence":
            c["k"] = P(None, dp, "model", None, None)
            c["v"] = P(None, dp, "model", None, None)
        else:
            c["k"] = P(None, dp, None, tpK, None)
            c["v"] = P(None, dp, None, tpK, None)
        c["kv_pos"] = P(None)
    if lay.kind == "encdec":
        c["ck"] = P(None, dp, None, tpH, None)
        c["cv"] = P(None, dp, None, tpH, None)
    if lay.kind == "zamba":
        c["conv_x"] = P(None, dp, None, tpHs)
        c["conv_B"] = P(None, dp, None, None)
        c["conv_C"] = P(None, dp, None, None)
        c["state"] = P(None, dp, tpHs, None, None)
    if lay.kind == "xlstm":
        c["mstate"] = P(None, dp, tpH, None, None)
        for k in ("sc", "sn", "sh", "sm"):
            c[k] = P(None, dp, tpH, None)
    return c


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """A parameter tree every rank holds whole, as DTensors placed by
    ``param_specs(cfg, mesh)`` (each rank keeps its pieces; nothing is
    sent)."""
    def place(tree, specs):
        return {k: place(v, specs[k]) if isinstance(v, dict)
                else distribute(v.detach(), mesh, specs[k])
                for k, v in tree.items()}
    return place(params, param_specs(cfg, mesh))


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None, mesh=None) -> Params:
    """Zeroed decode cache (``model.py:713-750``), all on ``device`` (None:
    the card).  ``pos`` (int32 scalar); with attention ``k``/``v``
    [layers, B, Sc, K, hd] (one layer per shared-attention application
    for Zamba2) and ``kv_pos`` ([Sc] int32, -1 = empty), ``Sc`` being
    ``cache_len`` or the sliding window if smaller; Whisper's cross cache
    ``ck``/``cv`` [L, B, encoder_seq, H, hd]; Zamba2's conv windows
    ``conv_x``/``conv_B``/``conv_C`` [n, B, W-1, C] in the model dtype and
    SSM ``state`` [n, B, H, N, P] float32; xLSTM's ``mstate`` [n, B, H,
    P, P+1] and ``sc``/``sn``/``sh``/``sm`` [groups, B, H, P], float32
    and zero (the reference's, although a prefill starts the sLSTM from
    (0, 1, 0, -10)).  With a ``mesh``, DTensors placed by
    ``cache_specs(cfg, mesh, batch_size)``, each rank's pieces made in
    place."""
    check_config(cfg)
    dev = _device(device)
    if mesh is not None:
        specs = cache_specs(cfg, mesh, batch_size)
        return {k: empty_like_spec(t.shape, mesh, specs[k], dtype=t.dtype,
                                   device=dev, fill=-1 if k == "kv_pos"
                                   else 0)
                for k, t in init_cache(cfg, batch_size, cache_len,
                                       device="meta").items()}
    lay = model_layout(cfg)
    B, dt, f32 = batch_size, _dtype(cfg), torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    c: Params = {"pos": zeros((), torch.int32)}
    if lay.kind in ("uniform", "encdec", "zamba"):
        Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        layers = lay.groups if lay.kind == "zamba" else cfg.num_layers
        shape = (layers, B, Sc, cfg.num_kv_heads, cfg.head_dim_)
        c["k"], c["v"] = zeros(shape, dt), zeros(shape, dt)
        c["kv_pos"] = torch.full((Sc,), -1, dtype=torch.int32, device=dev)
    if lay.kind == "encdec":
        shape = (cfg.num_layers, B, cfg.encoder_seq, cfg.num_heads,
                 cfg.head_dim_)
        c["ck"], c["cv"] = zeros(shape, dt), zeros(shape, dt)
    if lay.kind == "zamba":
        n = lay.groups * lay.per_group
        H, Ph, N, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
            cfg.conv_width
        c["conv_x"] = zeros((n, B, W - 1, H * Ph), dt)
        c["conv_B"] = zeros((n, B, W - 1, N), dt)
        c["conv_C"] = zeros((n, B, W - 1, N), dt)
        c["state"] = zeros((n, B, H, N, Ph), f32)
    if lay.kind == "xlstm":
        g, per, H = lay.groups, lay.per_group, cfg.num_heads
        Ph = cfg.d_model // H
        c["mstate"] = zeros((g * (per - 1), B, H, Ph, Ph + 1), f32)
        for name in ("sc", "sn", "sh", "sm"):
            c[name] = zeros((g, B, H, Ph), f32)
    return c


def decode_lengths(pos: int, cache_slots: int) -> int:
    """The valid prefix of the cache for the token at ``pos``.  Without a
    sliding window slots ``0 .. min(pos, Sc-1)`` hold positions ``<= pos``
    (the prompt from slot 0, then one slot per step, the last slot
    overwritten once the cache is full), which is exactly the reference's
    mask ``(kv_pos >= 0) & (kv_pos <= pos)`` (``model.py:1043-1049``).
    With a window W the ring of ``Sc = min(cache_len, W)`` slots holds
    position ``p`` at slot ``p % Sc`` (prefill and decode alike), so the
    same prefix is exactly the windowed mask ``... & (kv_pos > pos - W)``.
    ``decode_step`` computes the same on the device from a tensor ``pos``."""
    return min(pos + 1, cache_slots)


# ------------------------------------------------------------------ mixers
def _layer(blocks: Params, i: int) -> Params:
    return {name: t[i] for name, t in blocks.items()}


def _layers(blocks: Params) -> List[Params]:
    """Every layer's parameters of the stacked ``blocks``, one ``unbind``
    a tensor (the views of ``_layer`` without its per-layer backward)."""
    names = list(blocks)
    return [dict(zip(names, ts))
            for ts in zip(*(blocks[n].unbind(0) for n in names))]


def _on_rows(x, ws) -> bool:
    """Whether ``fn(x, *ws)`` runs on each rank's rows (``_rowwise``):
    DTensor ``x`` [B, S, ...] is split along its rows S and nowhere past
    them, and the weights ``ws`` are whole once gathered over the batch
    axes — context parallel's activations and weights.  DTensor (torch
    2.11) refuses to flatten [B, S] with S split, which a product over
    it does."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x) or not any(
            isinstance(p, Shard) and p.dim % x.ndim == 1
            for p in x.placements):
        return False
    mesh = x.device_mesh
    return all(e is None for e in tuple(_spec(x, mesh))[2:]) and not any(
        e for w in ws for e in gathered(w, mesh))


def _rowwise(fn, x, ws, shape):
    """``fn(x, *ws)`` on each rank's rows of ``x`` (``_on_rows``), the
    weights gathered whole; the result, of global ``shape``, split as
    ``x`` over its batch and rows."""
    mesh = x.device_mesh
    xs = _spec(x, mesh)
    out = P(*tuple(xs)[:2], *([None] * (len(shape) - 2)))
    return local_map(fn, mesh, (xs, *(gathered(w, mesh) for w in ws)), out,
                     shapes=shape)(x, *ws)


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., d] @ w [d, *out] -> [..., *out] (the reference's
    ``einsum("bsd,d...->bs...")``)."""
    if _on_rows(h, (w,)):
        return _rowwise(_proj, h, (w,), h.shape[:-1] + w.shape[1:])
    d = w.shape[0]
    return (h @ w.reshape(d, -1)).reshape(h.shape[:-1] + w.shape[1:])


def _proj_qkv(cfg: ModelConfig, p: Params, h: torch.Tensor):
    """h [B,S,d] -> q [B,S,H,hd], k and v [B,S,K,hd]."""
    q, k, v = _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out [..., H, hd] @ wo [H, hd, d] -> [..., d]."""
    if _on_rows(out, (wo,)):
        return _rowwise(_out_proj, out, (wo,), out.shape[:-2] + wo.shape[-1:])
    lead = out.shape[:-2]
    return out.reshape(lead + (-1,)) @ wo.reshape(-1, wo.shape[-1])


def _reduced(y, mesh):
    """``y`` with its partial sums over a mesh axis added up (an
    all-reduce: where the reference's GSPMD reduces a head- or
    expert-sharded product); shards stay as they are."""
    if mesh is None or not is_dtensor(y):
        return y
    from torch.distributed.tensor import Partial, Replicate
    pl = tuple(Replicate() if isinstance(p, Partial) else p
               for p in y.placements)
    return y if pl == tuple(y.placements) else y.redistribute(mesh, pl)


def _partial(mesh, dp: Tuple[str, ...], split: bool):
    """The placements of a mapped body's [B, ...] result: batch over
    ``dp``, and over "model" a partial sum where the body ran on a share
    of the heads (``split``), else replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Shard(0) if a in dp else
                 (Partial() if a == "model" and split else Replicate())
                 for a in mesh.mesh_dim_names)


def _spec(t, mesh) -> Optional[P]:
    """A DTensor's own spec (a mapped body reads it as it lies); None for
    any other value."""
    return spec_of(t.placements, mesh, t.ndim) if is_dtensor(t) else None


def _map_block(mesh, fn, p: Params, args, out_specs):
    """``fn(p, *args)`` on each rank's pieces (``sharding.local_map``): the
    block's weights all-gathered over the batch axes first (``gathered``,
    the reference's FSDP), every other DTensor argument read as it lies,
    plain values passed as they are."""
    names = sorted(p)
    specs = tuple(gathered(p[n], mesh) for n in names) + \
        tuple(_spec(a, mesh) for a in args)

    def body(*xs):
        return fn(dict(zip(names, xs[:len(names)])), *xs[len(names):])
    return local_map(body, mesh, specs, out_specs)(
        *(p[n] for n in names), *args)


def _model_rank(mesh) -> int:
    return axis_rank(mesh, "model") if "model" in axis_sizes(mesh) else 0


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, mesh=None):
    """The FFN sub-block (``model.py:441-454``): returns (x, aux), the MoE
    load-balance loss (a float32 0-d tensor) or 0.0 without experts.
    Only training reads aux.  On a mesh the SwiGLU's ``wdn`` product is a
    partial sum over "model" (its ff axis is split there), added up
    before the residual; the MoE runs expert-parallel."""
    aux = 0.0
    if cfg.is_moe:
        h = rms_norm(x, p["ln2"])
        y, aux = moe_ffn(h, p["router"], p["we_g"], p["we_u"], p["we_d"],
                         k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor, mesh=mesh,
                         dp_axes=_dp_for(mesh, x.shape[0]))
        x = x + y
    elif cfg.d_ff:
        h = rms_norm(x, p["ln2"])
        ws = (p["wg"], p["wu"], p["wdn"])
        x = x + (_rowwise(swiglu, h, ws, h.shape) if _on_rows(h, ws)
                 else _reduced(swiglu(h, *ws), mesh))
    return x, aux


def _kv_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            head_lo: int, groups: int):
    """The keys and values that query heads ``head_lo .. head_lo + H_loc``
    (``q`` [..., H_loc, hd]) read, GQA's ``groups`` query heads a KV
    head, from ``k``/``v`` [..., K_in, hd]: as they are where they hold
    exactly those heads' share (no mesh, or both sharded alike), else
    the KV heads of those query heads out of all K (a rank holding a
    share of the query heads but every KV head)."""
    H_loc, K_in = q.shape[-2], k.shape[-2]
    if K_in * groups == H_loc:
        return k, v
    if H_loc % groups == 0:
        lo = head_lo // groups
        sel = slice(lo, lo + H_loc // groups)
        return k[..., sel, :].contiguous(), v[..., sel, :].contiguous()
    idx = (head_lo + torch.arange(H_loc, device=k.device)) // groups
    return k.index_select(-2, idx), v.index_select(-2, idx)


def _attend_seq(cfg: ModelConfig, q, k, v, rope, *, causal: bool,
                window: int, card: bool, q_offset: int = 0,
                head_lo: int = 0):
    """Attention of a full sequence (the part of ``attn_mixer_seq`` a
    mapped body runs on a rank's heads or query rows): RoPE on ``q``
    (positions ``q_offset ..``) and ``k`` unless ``rope`` is None (cross
    attention), then K7 on the card, the chunked path on the CPU and in
    training.  Causal rows at ``q_offset`` read the keys up to their last
    position: K7 aligns its queries with the last keys it is given, so it
    takes ``k[:, :q_offset + Sq]``.  Returns (out, k, v), k roped."""
    Sq, Skv = q.shape[1], k.shape[1]
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos[q_offset:q_offset + Sq],
                       sin[q_offset:q_offset + Sq])
        k = apply_rope(k, cos, sin)
    kk, vv = _kv_for(q, k, v, head_lo, cfg.num_heads // cfg.num_kv_heads)
    if card:
        n = q_offset + Sq if causal else Skv
        out = kernels.flash_attention(q, kk[:, :n], vv[:, :n],
                                      causal=causal, window=window)
    elif rope is None:
        out = chunked_attention(q, kk, vv, causal=False,
                                chunk=cfg.attn_chunk)
    else:
        dev = q.device
        out = chunked_attention(
            q, kk, vv, causal=causal, chunk=cfg.attn_chunk,
            q_positions=torch.arange(q_offset, q_offset + Sq, device=dev),
            kv_positions=torch.arange(Skv, device=dev),
            sliding_window=window)
    return out, k, v


def attn_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   rope: Tuple[torch.Tensor, torch.Tensor], *,
                   causal: bool = True, cross_kv=None,
                   want_kv: bool = False, train: bool = False, mesh=None):
    """Full-sequence attention block at positions ``0..S-1`` (prefill and
    training; Whisper's encoder with ``causal=False``, without a window,
    as the reference's ``model.py:817``), ``rope`` the (cos, sin) of those
    positions.  ``cross_kv`` = (ck, cv) [B, Senc, H, hd], the encoder's
    keys and values of this layer, adds the cross-attention sub-block:
    non-causal, no RoPE (``model.py:429-435``).  The configured sliding
    window bounds the causal self-attention only (``model.py:425-427``).
    Returns (x, (k, v) or None, aux of ``_ffn``).  K7 on the card, the
    chunked path on the CPU; ``train=True`` takes the chunked path on
    either device.

    On a ``mesh`` the reference's constraints (``model.py:402-438``):
    heads over "model" and the batch over ``_dp_for`` (tensor parallel),
    or with ``act_shard="cp"`` the queries' rows over "model" and K/V
    whole (context parallel; rows split as ``torch.chunk`` splits them);
    the attention runs on each rank's share in a mapped body;
    the ``wo`` product, a partial sum over the heads, is added up
    before the residual; the block's output is constrained to the batch
    (and the rows under cp)."""
    S = x.shape[1]
    card = not train and _on_card(cfg, x)
    window = cfg.sliding_window if causal else 0
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    dp = _dp_for(mesh, x.shape[0])
    cp = mesh is not None and cfg.act_shard == "cp" and S > 1
    if mesh is None:
        out, k, v = _attend_seq(cfg, q, k, v, rope, causal=causal,
                                window=window, card=card)
    else:
        tpH = _tp(cfg, mesh, cfg.num_heads)
        tpK = _tp(cfg, mesh, cfg.num_kv_heads)
        qs = P(dp, "model", None, None) if cp else P(dp, None, tpH, None)
        ks = P(dp, None, None, None) if cp else P(dp, None, tpK, None)
        q, k, v = _shard(q, mesh, *qs), _shard(k, mesh, *ks), \
            _shard(v, mesh, *ks)

        def body(q, k, v, cos, sin):
            r = _model_rank(mesh)
            rows = -(-k.shape[1] // axis_sizes(mesh)["model"])
            out, k, v = _attend_seq(
                cfg, q, k, v, (cos, sin), causal=causal, window=window,
                card=card, q_offset=r * rows if cp else 0,
                head_lo=r * q.shape[2] if tpH and not cp else 0)
            return (out, k, v) if want_kv else out
        res = local_map(body, mesh, (qs, ks, ks, None, None),
                        [qs, ks, ks] if want_kv else qs,
                        shapes=[q.shape, k.shape, v.shape] if want_kv
                        else q.shape)(q, k, v, *rope)
        out, k, v = res if want_kv else (res, k, v)
    x = x + _reduced(_out_proj(out, p["wo"]), mesh)
    if cross_kv is not None:
        ck, cv = cross_kv
        qx = _proj(rms_norm(x, p["ln_x"]), p["wq_x"])
        if mesh is None:
            out = _attend_seq(cfg, qx, ck, cv, None, causal=False, window=0,
                              card=card)[0]
        else:
            xs = P(dp, None, _tp(cfg, mesh, cfg.num_heads), None)
            out = local_map(
                lambda q, k, v: _attend_seq(cfg, q, k, v, None, causal=False,
                                            window=0, card=card)[0],
                mesh, (xs, xs, xs), xs)(qx, ck, cv)
        x = x + _reduced(_out_proj(out, p["wo_x"]), mesh)
    x, aux = _ffn(cfg, p, x, mesh)
    x = _shard(x, mesh, dp, "model" if cp else None, None)
    return x, ((k, v) if want_kv else None), aux


def _attend_step(cfg: ModelConfig, q, k, v, k_cache, v_cache, slot, cos,
                 sin, lengths, length_mask, *, card: bool, head_lo: int = 0):
    """The decode step's attention on (a rank's share of) the heads:
    RoPE, this token's K/V written in place into the cache's slot
    ``slot``, then K8 over the first ``lengths[b]`` slots on the card or
    the plain path over ``length_mask`` on the CPU."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    kk, vv = _kv_for(q, k_cache, v_cache, head_lo,
                     cfg.num_heads // cfg.num_kv_heads)
    if card:
        return kernels.decode_attention(q[:, 0], kk, vv, lengths)[:, None]
    return decode_attention(q, kk, vv, length_mask=length_mask)


def _attend_cross_step(q, ck, cv, valid, *, card: bool):
    """Cross attention of one token over all the encoder's rows."""
    if card:
        return kernels.decode_attention(q[:, 0], ck, cv, valid)[:, None]
    return decode_attention(q, ck, cv, length_mask=valid)


def _seqshard_decode_attn(cfg: ModelConfig, mesh, q, k_cache, v_cache,
                          length_mask, k_new, v_new, slot, rope):
    """Flash-decoding over a sequence-sharded KV cache (``model.py:
    457-532``): each "model" rank owns ``Sc / tp`` cache rows, writes
    this token's row if the slot falls in its range (read the row, blend,
    write it back: the reference's row-granular update), computes a
    partial softmax over its rows with bf16 operands and float32
    accumulation, and the partials merge by a max and two sums over
    "model".  Plain PyTorch on either device, as the reference computes
    it in jnp, outside its kernels.  ``q`` [B,1,H,hd], ``k_new``/
    ``v_new`` [B,1,K,hd] before RoPE, caches [B,Sc,K,hd] (rows over
    "model"), ``length_mask`` [B,Sc] of the whole cache, ``slot`` the
    global [1] slot.  Returns out [B,1,H,hd]."""
    dp = _dp_for(mesh, q.shape[0])
    tp = axis_sizes(mesh)["model"]
    Sc = k_cache.shape[1]
    Sc_loc = Sc // tp
    scale = cfg.head_dim_ ** -0.5

    def body(qb, kc, vc, mk, kn, vn, slot_, cos, sin):
        i = _model_rank(mesh)
        qb, kn = apply_rope(qb, cos, sin), apply_rope(kn, cos, sin)
        ls = slot_ - i * Sc_loc
        ok = (ls >= 0) & (ls < Sc_loc)
        lsc = ls.clamp(0, Sc_loc - 1)
        for c, new in ((kc, kn), (vc, vn)):
            row = c.index_select(1, lsc)
            c.index_copy_(1, lsc, torch.where(ok, new.to(c.dtype), row))
        B, S_loc, K, hd = kc.shape
        H = qb.shape[2]
        g = H // K
        qg = (qb.float() * scale).to(kc.dtype).reshape(B * K, g, hd)
        kt = kc.permute(0, 2, 3, 1).reshape(B * K, hd, S_loc)
        sc = _bmm_f32(qg, kt).reshape(B, K, g, S_loc)
        m1 = mk[:, None, None, :]
        sc = sc.masked_fill(~m1, NEG)
        m = sc.amax(-1)
        pr = torch.exp(sc - m[..., None]).masked_fill(~m1, 0.0)
        den = pr.sum(-1)
        vt = vc.permute(0, 2, 1, 3).reshape(B * K, S_loc, hd)
        acc = _bmm_f32(pr.to(kc.dtype).reshape(B * K, g, S_loc),
                       vt).reshape(B, K, g, hd)
        m_g = all_reduce(m, "max", mesh, "model")
        corr = torch.exp(m - m_g)
        acc = all_reduce(acc * corr[..., None], "sum", mesh, "model")
        den = all_reduce(den * corr, "sum", mesh, "model")
        out = (acc / torch.clamp_min(den[..., None], 1e-30))
        return out.reshape(B, 1, H, hd).to(qb.dtype)

    rep = P(dp, None, None, None)
    cs = P(dp, "model", None, None)
    mask = distribute(length_mask, mesh, P(dp, "model"))
    return local_map(body, mesh,
                     (rep, cs, cs, P(dp, "model"), rep, rep, None, None,
                      None), rep)(
        _shard(q, mesh, *rep), k_cache, v_cache, mask,
        _shard(k_new, mesh, *rep), _shard(v_new, mesh, *rep), slot, *rope)


def attn_mixer_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    slot: torch.Tensor,
                    rope: Tuple[torch.Tensor, torch.Tensor], *,
                    lengths: Optional[torch.Tensor] = None,
                    length_mask: Optional[torch.Tensor] = None,
                    cross_kv=None, mesh=None,
                    kv_mode: str = "heads") -> torch.Tensor:
    """Single-token decode block: x [B,1,d]; caches [B,Sc,K,hd], into whose
    slot ``slot`` (a [1] int64 tensor on their device) this token's K/V are
    written in place.  On the card K8 attends over the first ``lengths[b]``
    slots; on the CPU the plain path over ``length_mask`` [B,Sc].
    ``cross_kv`` = (ck, cv, valid): this layer's encoder keys and values
    [B,Senc,H,hd], read only, and the rows to attend in the same form —
    lengths on the card, a mask on the CPU, all ``Senc`` rows
    (``model.py:557-563``).  Returns the new x.

    On a ``mesh``, with ``kv_mode`` "heads" each rank attends with its
    share of the heads over its share of the cache's KV heads (K8 on
    the card); with "sequence" ``_seqshard_decode_attn`` runs over the
    rows each rank holds (``length_mask`` given on either device)."""
    card = _on_card(cfg, x)
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    cos, sin = rope
    dp = _dp_for(mesh, x.shape[0])
    tpH = _tp(cfg, mesh, cfg.num_heads)
    if mesh is None:
        out = _attend_step(cfg, q, k, v, k_cache, v_cache, slot, cos, sin,
                           lengths, length_mask, card=card)
    elif kv_mode == "sequence":
        out = _seqshard_decode_attn(cfg, mesh, q, k_cache, v_cache,
                                    length_mask, k, v, slot, rope)
    else:
        tpK = _tp(cfg, mesh, cfg.num_kv_heads)
        qs, ks = P(dp, None, tpH, None), P(dp, None, tpK, None)
        valid = lengths if card else length_mask
        vs = P(dp) if card else P(dp, None)

        def body(q, k, v, kc, vc, valid, slot, cos, sin):
            return _attend_step(
                cfg, q, k, v, kc, vc, slot, cos, sin,
                valid if card else None, None if card else valid,
                card=card, head_lo=_model_rank(mesh) * q.shape[2]
                if tpH else 0)
        out = local_map(body, mesh, (qs, ks, ks, ks, ks, vs, None, None,
                                     None), qs)(
            _shard(q, mesh, *qs), _shard(k, mesh, *ks), _shard(v, mesh, *ks),
            k_cache, v_cache, distribute(valid, mesh, vs), slot, cos, sin)
    x = x + _reduced(_out_proj(out, p["wo"]), mesh)
    if cross_kv is not None:
        ck, cv, valid = cross_kv
        qx = _proj(rms_norm(x, p["ln_x"]), p["wq_x"])
        if mesh is None:
            out = _attend_cross_step(qx, ck, cv, valid, card=card)
        else:
            xs = P(dp, None, tpH, None)
            vs = P(dp) if card else P(dp, None)
            out = local_map(
                lambda q, k, v, m: _attend_cross_step(q, k, v, m, card=card),
                mesh, (xs, xs, xs, vs), xs)(
                _shard(qx, mesh, *xs), ck, cv, distribute(valid, mesh, vs))
        x = x + _reduced(_out_proj(out, p["wo_x"]), mesh)
    return _ffn(cfg, p, x, mesh)[0]


def _head_rms(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm: y [B,S,H,P] (or [B,H,P]), scale [H,P]."""
    dt = y.dtype
    y = y.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return (y * scale).to(dt)


def _mixer(mesh, fn, p: Params, x: torch.Tensor, states=(), out_state=(),
           split: bool = False):
    """``fn(p, x, *states) -> (out, *new states)`` of a recurrent layer,
    and x + out.  Without a mesh it runs as it is; on one it runs on
    each rank's share of the heads (``split``: they divide "model"), its
    weights gathered over the batch axes, ``out`` a partial sum over the
    heads added up before the residual, and ``out_state`` the specs of
    the new states it returns (none in training, where every result
    must be split for the gradients' placement)."""
    if mesh is None:
        out, *new = fn(p, x, *states)
        return (x + out, *new)
    dp = _dp_for(mesh, x.shape[0])
    res = _map_block(mesh, fn, p, (x,) + tuple(states),
                     [_partial(mesh, dp, split), *out_state])
    out, *new = res
    return (x + _reduced(out, mesh), *new)


def _mamba_pre(cfg: ModelConfig, p: Params, h: torch.Tensor, conv_caches):
    """Projections and causal convs (``model.py:576-594``).  h [B,S,d] ->
    (xh [B,S,H,P], z, Bv, Cv, log decay [B,S,H], dt, new conv caches);
    H from ``w_x`` (a rank's share of the heads on a mesh)."""
    B, S, _ = h.shape
    H, Ph = p["w_x"].shape[-2:]
    xh = _proj(h, p["w_x"]).reshape(B, S, H * Ph)
    z = _proj(h, p["w_z"])
    Bv, Cv = h @ p["w_B"], h @ p["w_C"]
    dt_pre = h @ p["w_dt"]
    cx, cb, cc = conv_caches
    xh, cx = ssm.causal_conv1d(xh, p["conv_x"].reshape(-1, H * Ph), cx)
    Bv, cb = ssm.causal_conv1d(Bv, p["conv_B"], cb)
    Cv, cc = ssm.causal_conv1d(Cv, p["conv_C"], cc)
    xh = xh.reshape(B, S, H, Ph)
    dt = F.softplus(dt_pre.float() + p["dt_bias"])
    ld = dt * -torch.exp(p["A_log"])          # [B,S,H], <= 0
    return xh, z, Bv, Cv, ld, dt, (cx, cb, cc)


def _mamba_out(p: Params, dtype, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The D skip on the post-conv ``xh``, the ``silu(z)`` gate, the head
    norm and the output projection (added to the residual by the
    caller)."""
    y = y + p["D"][:, None] * xh.float()
    y = y * F.silu(z.float())
    y = _head_rms(y, p["out_norm"])
    return _out_proj(y.to(dtype), p["w_out"])


def _tp_ssm(cfg: ModelConfig, mesh) -> bool:
    return _tp(cfg, mesh, cfg.ssm_heads) is not None


def _state_specs(cfg: ModelConfig, mesh, B: int, names) -> List[P]:
    """The specs of a layer's cache states (``cache_specs`` without the
    layer axis)."""
    specs = cache_specs(cfg, mesh, batch_size=B)
    return [P(*specs[n][1:]) for n in names]


def mamba_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    state_in=None, conv_in=None, mesh=None,
                    want_state: bool = True):
    """A Mamba2 layer over a sequence (``model.py:597-615``).  Returns
    (x, ((conv_x, conv_B, conv_C) windows, state [B,H,N,P])), the states
    None without ``want_state`` (training)."""
    N = cfg.ssm_state

    def fn(p, x):
        B, S, _ = x.shape
        h = rms_norm(x, p["ln"])
        conv0 = conv_in if conv_in is not None else (None, None, None)
        xh, z, Bv, Cv, ld, dt, convs = _mamba_pre(cfg, p, h, conv0)
        H = xh.shape[2]
        qh = Cv[:, :, None, :].expand(B, S, H, N)
        kh = Bv[:, :, None, :].expand(B, S, H, N)
        y, state = ssm.chunked_linear_attention(
            qh, kh, xh, ld, dt, chunk=cfg.ssm_chunk, state_in=state_in)
        out = _mamba_out(p, x.dtype, y, xh, z)
        return (out, *convs, state) if want_state else (out,)
    names = ("conv_x", "conv_B", "conv_C", "state")
    out_state = _state_specs(cfg, mesh, x.shape[0], names) \
        if mesh is not None and want_state else []
    x, *st = _mixer(mesh, fn, p, x, (), out_state, _tp_ssm(cfg, mesh))
    return x, ((tuple(st[:3]), st[3]) if want_state else None)


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, cache: torch.Tensor):
    """x_t [B,1,C]; w [W,C]; cache [B,W-1,C] -> (silu(y) [B,1,C], the
    window shifted by one)."""
    xc = torch.cat([cache, x_t], 1)                       # [B,W,C]
    y = torch.einsum("bwc,wc->bc", xc.float(), w.float())[:, None]
    return F.silu(y).to(x_t.dtype), xc[:, 1:]


def _mamba_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: torch.Tensor, convs):
    """A Mamba2 layer on one token (``model.py:626-649``), on the heads of
    ``w_x``.  Returns (out, added to the residual by the caller, (new
    state, new conv windows))."""
    B = x.shape[0]
    H, Ph = p["w_x"].shape[-2:]
    N = cfg.ssm_state
    h = rms_norm(x, p["ln"])                               # [B,1,d]
    xh = _proj(h, p["w_x"]).reshape(B, 1, H * Ph)
    z = _proj(h[:, 0], p["w_z"])
    Bv, Cv = h @ p["w_B"], h @ p["w_C"]
    dt_pre = h[:, 0] @ p["w_dt"]
    cx, cb, cc = convs
    xh, cx = _conv_step(xh, p["conv_x"].reshape(-1, H * Ph), cx)
    Bv, cb = _conv_step(Bv, p["conv_B"], cb)
    Cv, cc = _conv_step(Cv, p["conv_C"], cc)
    xh = xh.reshape(B, H, Ph)
    dt = F.softplus(dt_pre.float() + p["dt_bias"])
    ld = dt * -torch.exp(p["A_log"])
    qh = Cv[:, 0, None, :].expand(B, H, N)
    kh = Bv[:, 0, None, :].expand(B, H, N)
    y, state = ssm.linear_attention_step(state, qh, kh, xh, ld, dt)
    return _mamba_out(p, x.dtype, y, xh, z)[:, None], (state, (cx, cb, cc))


def _mlstm_pre(cfg: ModelConfig, p: Params, h: torch.Tensor):
    """q, k, v [..., H, P] and the gates log σ(f), σ(i) [..., H] float32.
    The gate weights are float32: ``h`` is widened exactly, as the
    reference's einsum promotes it."""
    Ph = cfg.d_model // cfg.num_heads
    q = _proj(h, p["w_q"]) * (Ph ** -0.5)
    k = _proj(h, p["w_k"]) * (Ph ** -0.5)
    v = _proj(h, p["w_v"])
    ig = torch.sigmoid(h.float() @ p["w_ig"])
    fg = -F.softplus(-(h.float() @ p["w_fg"] + p["fg_bias"]))
    return q, k, v, fg, ig


def mlstm_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    state_in=None, mesh=None, want_state: bool = True):
    """An mLSTM layer over a sequence (``model.py:652-669``).  Returns
    (x, state [B,H,P,P+1]), the state None without ``want_state``."""
    def fn(p, x):
        h = rms_norm(x, p["ln"])
        q, k, v, fg, ig = _mlstm_pre(cfg, p, h)
        y, state = ssm.chunked_linear_attention(
            q, k, v, fg, ig, chunk=cfg.ssm_chunk, normalize=True,
            state_in=state_in)
        y = _head_rms(y, p["out_norm"])
        out = _out_proj(y.to(x.dtype), p["w_o"])
        return (out, state) if want_state else (out,)
    out_state = _state_specs(cfg, mesh, x.shape[0], ("mstate",)) \
        if mesh is not None and want_state else []
    x, *st = _mixer(mesh, fn, p, x, (), out_state,
                    _tp(cfg, mesh, cfg.num_heads) is not None)
    return x, (st[0] if want_state else None)


def _mlstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: torch.Tensor):
    """An mLSTM layer on one token (``model.py:672-688``): (out, added to
    the residual by the caller, new state)."""
    h = rms_norm(x, p["ln"])[:, 0]
    q, k, v, fg, ig = _mlstm_pre(cfg, p, h)
    y, state = ssm.linear_attention_step(state, q, k, v, fg, ig,
                                         normalize=True)
    y = _head_rms(y, p["out_norm"])
    return _out_proj(y.to(x.dtype), p["w_o"])[:, None], state


def _slstm(cfg: ModelConfig, p: Params, x: torch.Tensor, state_in,
           head_lo: int = 0):
    """An sLSTM layer's output (before the residual) and state, on the
    heads of ``w_in`` (``head_lo ..`` of them: the rows of ``w_o`` they
    read)."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"])
    gates = (_proj(h, p["w_in"]) + p["b"]).float()
    hs, state = ssm.slstm_scan(gates, p["r"], state_in)
    H_loc, Ph = hs.shape[-2:]
    w_o = p["w_o"][head_lo * Ph:(head_lo + H_loc) * Ph]
    return hs.reshape(B, S, H_loc * Ph).to(x.dtype) @ w_o, state


def slstm_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    state_in=None, mesh=None, want_state: bool = True):
    """An sLSTM layer over a sequence (``model.py:691-699``); the decode
    step is the same on one token from the cached state."""
    split = _tp(cfg, mesh, cfg.num_heads) is not None

    def fn(p, x, *st):
        lo = _model_rank(mesh) * p["r"].shape[1] if split else 0
        out, state = _slstm(cfg, p, x, st or None, lo)
        return (out, *state) if want_state else (out,)
    names = ("sc", "sn", "sh", "sm")
    out_state = _state_specs(cfg, mesh, x.shape[0], names) \
        if mesh is not None and want_state else []
    x, *st = _mixer(mesh, fn, p, x, tuple(state_in or ()), out_state, split)
    return x, (tuple(st) if want_state else None)


# ------------------------------------------------------ decode layer stacks
def decode_layers(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor,
                  rope: Tuple[torch.Tensor, torch.Tensor],
                  lengths: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor],
                  cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  mesh=None) -> torch.Tensor:
    """The uniform or encoder-decoder decode step's layer stack:
    ``attn_mixer_step`` of every layer over the stacked ``blocks`` and
    caches ``k``/``v`` [L, B, Sc, K, hd], which it updates in place;
    ``cross`` = (ck, cv) [L, B, Senc, H, hd], Whisper's cross cache, is
    read whole by every step.  Returns the new x."""
    valid = None
    if cross is not None:       # made on the device: a replay copies nothing
        B, Senc = cross[0].shape[1:3]
        valid = torch.full((B,), Senc, dtype=torch.int32, device=x.device) \
            if _on_card(cfg, x) else \
            torch.ones((B, Senc), dtype=torch.bool, device=x.device)
    kv_mode = resolve_kv_mode(cfg, mesh)
    for i in range(cfg.num_layers):
        ckv = None if cross is None else (cross[0][i], cross[1][i], valid)
        try:
            x = attn_mixer_step(cfg, _layer(blocks, i), x, k[i], v[i], slot,
                                rope, lengths=lengths, length_mask=mask,
                                cross_kv=ckv, mesh=mesh, kv_mode=kv_mode)
        except Exception as e:
            e.add_note(f"decode layer {i}")
            raise
    return x


def _recurrent_step(mesh, step, p: Params, x: torch.Tensor, bufs,
                    split: bool) -> torch.Tensor:
    """``step(p, x, *bufs) -> (out, new states)`` of one recurrent layer,
    its new states written into ``bufs`` (the layer's cache tensors) in
    place; returns x + out (``_mixer``: on a mesh each rank writes the
    states of its share of the heads)."""
    def fn(p, x, *bufs):
        out, new = step(p, x, *bufs)
        for buf, val in zip(bufs, new):
            buf.copy_(val)
        return (out,)
    return _mixer(mesh, fn, p, x, tuple(bufs), [], split)[0]


def decode_recurrent_layers(cfg: ModelConfig, trees: Params,
                            x: torch.Tensor, cache: Params, attn,
                            mesh=None) -> torch.Tensor:
    """The Zamba2 or xLSTM decode step's layer stack over the parameter
    ``trees`` (``mamba``/``shared_attn`` or ``mlstm``/``slstm``) and the
    cache tensors of ``STACK_STATE``, which it updates in place: each
    layer's conv windows (shifted by one) and recurrent state, and the
    shared attention's K/V slot.  ``attn`` is (slot, rope, lengths, mask)
    of the shared attention, None for xLSTM.  Returns the new x
    (``model.py:1080-1145``)."""
    lay = model_layout(cfg)
    # Zamba2: per_group Mamba2 layers a group; xLSTM: per_group - 1 mLSTM
    inner = lay.per_group - (lay.kind == "xlstm")
    split_h = _tp(cfg, mesh, cfg.num_heads) is not None

    def mamba(p, x, cx, cb, cc, st):
        out, (st, convs) = _mamba_step(cfg, p, x, st, (cx, cb, cc))
        return out, (*convs, st)

    def mlstm(p, x, st):
        out, st = _mlstm_step(cfg, p, x, st)
        return out, (st,)

    def slstm(p, x, *st):
        lo = _model_rank(mesh) * p["r"].shape[1] if split_h else 0
        return _slstm(cfg, p, x, st, lo)

    for gi in range(lay.groups):
        for j in range(inner):
            i = gi * inner + j
            try:
                if lay.kind == "zamba":
                    x = _recurrent_step(
                        mesh, mamba, _layer(trees["mamba"], i), x,
                        [cache[n][i] for n in ("conv_x", "conv_B", "conv_C",
                                               "state")],
                        _tp_ssm(cfg, mesh))
                else:
                    x = _recurrent_step(mesh, mlstm,
                                        _layer(trees["mlstm"], i), x,
                                        [cache["mstate"][i]], split_h)
            except Exception as e:
                e.add_note(f"decode layer {i} ({lay.kind} group {gi})")
                raise
        try:
            if lay.kind == "zamba":
                slot, rope, lengths, mask = attn
                x = attn_mixer_step(cfg, trees["shared_attn"], x,
                                    cache["k"][gi], cache["v"][gi], slot,
                                    rope, lengths=lengths, length_mask=mask,
                                    mesh=mesh,
                                    kv_mode=resolve_kv_mode(cfg, mesh))
            else:
                x = _recurrent_step(
                    mesh, slstm, _layer(trees["slstm"], gi), x,
                    [cache[n][gi] for n in ("sc", "sn", "sh", "sm")],
                    split_h)
        except Exception as e:
            e.add_note(f"decode group {gi} ({lay.kind} closing block)")
            raise
    return x


# (config, block names, sharded) of each model the layer-stack operators
# have run; an operator's schema takes tensors and scalars, so it gets an
# index here
_STACKS: List[Tuple[ModelConfig, Tuple[str, ...], bool]] = []


def _stack_key(cfg: ModelConfig, names: Tuple[str, ...],
               sharded: bool = False) -> int:
    entry = (cfg, names, sharded)
    if entry not in _STACKS:
        _STACKS.append(entry)
    return _STACKS.index(entry)


def _stack(stack: int) -> Tuple[ModelConfig, Tuple[str, ...]]:
    """The config and names registered under ``stack``.  A sharded stack's
    operator is one that ran on each rank's pieces without the collectives
    of its layers: it is traced on fake tensors (``launch/dryrun.py``'s
    rolled pass) and never computed."""
    cfg, names, sharded = _STACKS[stack]
    if sharded:
        raise UnsupportedConfigError(
            f"{cfg.name}: the traced decode step on a mesh is for fake "
            f"tensors only; decode with traced=False")
    return cfg, names


@torch.library.custom_op("repro_torch::decode_layers", mutates_args=())
def _decode_layers_op(blocks: List[torch.Tensor], x: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      mask: Optional[torch.Tensor],
                      ck: Optional[torch.Tensor], cv: Optional[torch.Tensor],
                      stack: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_layers`` as one functional operator (the reference's scan
    equation, ``model.py:1061-1077``): it updates copies of the caches and
    returns ``(x, k_new, v_new)``; Whisper's cross cache ``ck``/``cv``
    comes in and is not returned, as the reference's scan takes it as
    ``xs``.  ``blocks`` are the stacked block tensors in the order of the
    names registered under ``stack``."""
    cfg, names = _stack(stack)
    k, v = k.clone(), v.clone()
    x = decode_layers(cfg, dict(zip(names, blocks)), x, k, v, slot,
                      (cos, sin), lengths, mask,
                      None if ck is None else (ck, cv))
    return x, k, v


@_decode_layers_op.register_fake
def _(blocks, x, k, v, slot, cos, sin, lengths, mask, ck, cv, stack):
    return torch.empty_like(x), torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op("repro_torch::decode_recurrent_layers",
                         mutates_args=())
def _decode_recurrent_op(blocks: List[torch.Tensor], x: torch.Tensor,
                         caches: List[torch.Tensor],
                         slot: Optional[torch.Tensor],
                         cos: Optional[torch.Tensor],
                         sin: Optional[torch.Tensor],
                         lengths: Optional[torch.Tensor],
                         mask: Optional[torch.Tensor], stack: int
                         ) -> List[torch.Tensor]:
    """``decode_recurrent_layers`` as one functional operator (the
    reference's outer scan equation, ``model.py:1108-1109``,
    ``:1138-1140``): it updates copies of ``caches`` (the layout's
    ``STACK_STATE`` tensors, in that order) and returns ``[x, *new
    caches]``.  ``blocks`` are the parameter trees' tensors in the order
    of the ``tree.name`` names registered under ``stack``; ``slot``,
    ``cos``, ``sin`` and one of ``lengths``/``mask`` are the shared
    attention's (None for xLSTM)."""
    cfg, names = _stack(stack)
    state = STACK_STATE[model_layout(cfg).kind]
    cache = {n: t.clone() for n, t in zip(state, caches)}
    x = decode_recurrent_layers(
        cfg, _unflatten(dict(zip(names, blocks))), x, cache,
        None if slot is None else (slot, (cos, sin), lengths, mask))
    return [x] + [cache[n] for n in state]


@_decode_recurrent_op.register_fake
def _(blocks, x, caches, slot, cos, sin, lengths, mask, stack):
    return [torch.empty_like(x)] + [torch.empty_like(c) for c in caches]


def _flatten(params: Params, trees: Tuple[str, ...]) -> Dict[str, Any]:
    """``{"tree.name": tensor}`` of the parameter trees ``trees``."""
    return {f"{t}.{n}": v for t in trees for n, v in params[t].items()}


def _unflatten(flat: Dict[str, Any]) -> Params:
    out: Params = {}
    for key, v in flat.items():
        tree, name = key.split(".", 1)
        out.setdefault(tree, {})[name] = v
    return out


# ------------------------------------------------------------------- model
class Model:
    """Prefill and greedy-decode entry points of a dense, MoE,
    vision-language, encoder-decoder (Whisper), Zamba2 or xLSTM decoder.
    They take the parameters explicitly and run where the parameters
    are.

    With a ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and
    "pod" for two pods) the parameters are DTensors placed by
    ``param_specs`` (``init_params(..., mesh=)``), the caches by
    ``cache_specs`` (``init_cache(..., mesh=)``), and the entry points
    run SPMD on every rank: DTensor ops where the reference lets GSPMD
    place the work, ``_shard`` where it constrains it, mapped bodies
    (``sharding.local_map``) where it runs ``shard_map`` or where an op
    has no DTensor rule (the attention, K7 and K8 on each rank's heads,
    the recurrences, the cache writes).  Logits come back as DTensors
    (``sharding.full`` gathers them); the decode step runs its layer
    loop (its traced form on a mesh is for the dry-run's fake
    tensors)."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        check_config(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.layout = model_layout(cfg)
        # the cache tensors the decode step's layer stack updates
        self.stack_state = STACK_STATE[self.layout.kind]

    def _dp(self, batch: int) -> Tuple[str, ...]:
        return _dp_for(self.mesh, batch)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [B,d] -> float32 logits over the logical vocab."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].t() if cfg.tie_embeddings else params["head"]
        logits = (x @ head).float()
        if self.mesh is not None:   # the vocab slice reads every shard
            logits = _shard(logits, self.mesh, self._dp(x.shape[0]), None)
        return logits[:, :cfg.vocab_size]

    def _embed_rows(self, params: Params, tokens) -> torch.Tensor:
        """The embedding rows of ``tokens``; on a mesh a lookup into the
        vocab- and d-sharded table, replicated (the reduction of the
        vocab shards' masked rows), then constrained to the batch
        (``model.py:798-807``)."""
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device)
        x = F.embedding(replicate(tokens, self.mesh), embed)
        if self.mesh is not None:
            x = _shard(x, self.mesh, *P())
        return x

    def _embed(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """The token rows [B,S,d] of ``batch["tokens"]``, after a VLM's patch
        rows, ``batch["patches"]`` cast to the model dtype before the
        product with ``vis_proj`` as the reference casts them
        (``model.py:798-807``)."""
        x = self._embed_rows(params, batch["tokens"])
        if self.cfg.num_patch_tokens:
            w = params["vis_proj"]
            patches = torch.as_tensor(batch["patches"], device=w.device)
            vis = replicate(patches.to(x.dtype), self.mesh) @ w
            if self.mesh is not None:
                vis = _shard(vis, self.mesh, *P())
            x = torch.cat([vis, x], 1)
        return _shard(x, self.mesh, self._dp(x.shape[0]), None, None)

    def _encoder(self, params: Params, frames,
                 train: bool = False) -> torch.Tensor:
        """Whisper's encoder on the stub frame embeddings [B, Senc,
        frontend_dim] (``model.py:809-823``): ``frame_proj``, then every
        encoder block non-causal with RoPE at positions ``0..Senc-1``
        (``train``: ``attn_mixer_seq``'s training route; not checkpointed,
        as the reference's is not)."""
        cfg, mesh = self.cfg, self.mesh
        w = params["frame_proj"]
        f = torch.as_tensor(frames, device=w.device).to(w.dtype)
        x = replicate(f, mesh) @ w
        x = _shard(x, mesh, self._dp(x.shape[0]), None, None)
        rope = rope_angles(torch.arange(x.shape[1], device=x.device),
                           cfg.head_dim_, cfg.rope_theta)
        for i, p in enumerate(_layers(params["encoder"])
                              [:cfg.encoder_layers]):
            try:
                x, _, _ = attn_mixer_seq(cfg, p, x, rope, causal=False,
                                         train=train, mesh=mesh)
            except Exception as e:
                e.add_note(f"encoder layer {i}")
                raise
        return x

    def _cross_spec(self, B: int) -> P:
        return P(self._dp(B), None, _tp(self.cfg, self.mesh,
                                        self.cfg.num_heads), None)

    def _cross_kv_all(self, params: Params, enc: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor) -> None:
        """Every decoder layer's cross K/V of the encoder output ``enc``
        into ``ck``/``cv`` [L, B, Senc, H, hd] (``model.py:825-830``)."""
        bl = params["blocks"]
        spec = self._cross_spec(enc.shape[0])
        for i in range(self.cfg.num_layers):
            for buf, w in ((ck, bl["wk_x"][i]), (cv, bl["wv_x"][i])):
                val = _shard(_proj(enc, w), self.mesh, *spec)
                if self.mesh is None:
                    buf[i] = val
                else:
                    buf[i].copy_(val)

    def _cross_kv_stack(self, params: Params, enc: torch.Tensor):
        """Every decoder layer's cross K/V of the encoder output ``enc`` as
        new tensors (ck, cv) [L, B, Senc, H, hd], through which gradients
        pass (``model.py:825-830``; prefill writes them into its cache
        instead, ``_cross_kv_all``)."""
        bl = params["blocks"]
        spec = self._cross_spec(enc.shape[0])
        return tuple(torch.stack([_shard(_proj(enc, w), self.mesh, *spec)
                                  for w in bl[n].unbind(0)])
                     for n in ("wk_x", "wv_x"))

    def _seq_stack(self, params: Params, x: torch.Tensor,
                   rope: Tuple[torch.Tensor, torch.Tensor], *,
                   cross_kv=None, remat: bool = False):
        """The whole depth on a full sequence, without a cache
        (``model.py:832-921``): the uniform and encoder-decoder stacks one
        body a layer (``cross_kv`` = (ck, cv) of ``_cross_kv_stack``),
        Zamba2 one body a group (its Mamba2 layers, then the shared
        attention block), xLSTM one body a group (its mLSTM layers, then
        the sLSTM).  ``remat`` checkpoints each body
        (``torch.utils.checkpoint``, non-reentrant): its activations are
        recomputed by the backward, on the same route.  Returns (x, aux):
        the MoE load-balance losses summed over the layers in order, a
        float32 0-d tensor."""
        cfg, lay, mesh = self.cfg, self.layout, self.mesh
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def run(body, *args):
            if remat:
                # no body draws a random number (the reference has no
                # dropout), and stashing the CUDA generator's state reads
                # its seed and offset, which a graph capture refuses
                return checkpoint(body, *args, use_reentrant=False,
                                  preserve_rng_state=False)
            return body(*args)

        def attend(p, x, ckv=None):
            x, _, a = attn_mixer_seq(cfg, p, x, rope, cross_kv=ckv,
                                     train=True, mesh=mesh)
            return x, a

        if lay.kind in ("uniform", "encdec"):
            blocks = _layers(params["blocks"])[:cfg.num_layers]
            cross = [None] * len(blocks) if cross_kv is None else \
                list(zip(cross_kv[0].unbind(0), cross_kv[1].unbind(0)))
            for p, ckv in zip(blocks, cross):
                x, a = run(attend, p, x, ckv)
                aux = aux + a
            return x, aux
        per = lay.per_group - (lay.kind == "xlstm")
        if lay.kind == "zamba":
            inner, mix = _layers(params["mamba"]), mamba_mixer_seq
            closing, close = [params["shared_attn"]] * lay.groups, attend
        else:
            inner, mix = _layers(params["mlstm"]), mlstm_mixer_seq
            closing = _layers(params["slstm"])

            def close(p, x):
                return slstm_mixer_seq(cfg, p, x, mesh=mesh,
                                       want_state=False)[0], 0.0

        def group(ps, pc, x):
            for p in ps:
                x, _ = mix(cfg, p, x, mesh=mesh, want_state=False)
            return close(pc, x)

        for gi in range(lay.groups):
            x, a = run(group, inner[gi * per:(gi + 1) * per], closing[gi], x)
            aux = aux + a
        return x, aux

    def _chunked_ce(self, params: Params, x: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
        """Mean masked cross-entropy of ``x`` [B,S,d] against ``labels``
        [B,S] without the [B,S,V] logits (``model.py:924-959``): chunks of
        ``chunk`` rows, each chunk's logits the product in the model
        dtype, widened to float32, the padded vocab rows ``-1e30``,
        ``logsumexp - gold``, masked.  Each chunk is checkpointed, so one
        chunk's float32 logits are live at a time, in the backward too.
        Chunk sums and the count add in chunk order, as the reference's
        scan adds them.  The reference pads S to whole chunks (its scan
        needs equal steps) and its pad rows add masked zeros; here the
        last chunk is ragged instead, so a short sequence does not form
        the logits of a whole chunk.

        On a mesh a chunk's logits are constrained as the reference's
        (batch over ``_dp_for``, vocab over "model"); the loss of each
        rank's rows is a mapped body over its batch rows and the whole
        vocab, its sums partial over the batch axes."""
        cfg, mesh = self.cfg, self.mesh
        head = params["embed"].t() if cfg.tie_embeddings else params["head"]
        B, S = x.shape[:2]
        n = -(-S // chunk)
        vmask = torch.arange(cfg.padded_vocab, device=x.device) \
            >= cfg.vocab_size

        def nll_local(logits, li, mi):
            logits = logits.masked_fill(vmask, NEG)
            gold = logits.gather(-1, li[..., None].long())[..., 0]
            return ((torch.logsumexp(logits, -1) - gold) * mi).sum()

        if mesh is None:
            def nll(xi, li, mi, head):
                return nll_local((xi @ head).float(), li, mi)
        else:
            from torch.distributed.tensor import Partial, Replicate
            dp = self._dp(B)
            rows = P(dp, None, None)
            mapped = local_map(nll_local, mesh,
                               (rows, P(dp, None), P(dp, None)),
                               tuple(Partial() if a in dp else Replicate()
                                     for a in mesh.mesh_dim_names))

            def nll(xi, li, mi, head):
                logits = _shard((xi @ head).float(), mesh, dp, None,
                                _tp(cfg, mesh, cfg.padded_vocab))
                return _reduced(mapped(_shard(logits, mesh, *rows), li, mi),
                                mesh)
            counts = mask
            labels = distribute(labels, mesh, P(dp, None))
            mask = distribute(mask, mesh, P(dp, None))
        tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(n):
            sl = slice(c * chunk, (c + 1) * chunk)
            # no random number drawn: nothing to stash (see _seq_stack)
            tot = tot + checkpoint(nll, x[:, sl], labels[:, sl], mask[:, sl],
                                   head, use_reentrant=False,
                                   preserve_rng_state=False)
            cnt = cnt + (mask if mesh is None else counts)[:, sl].sum()
        if mesh is not None:
            tot = full(tot)
        return tot / torch.clamp_min(cnt, 1.0)

    def loss_fn(self, params: Params, batch: Dict[str, Any],
                remat: bool = True):
        """Next-token LM loss plus 0.01 × the MoE load-balance loss
        (``model.py:962-985``) of ``batch["tokens"]`` [B,S] (after a VLM's
        ``patches``; over Whisper's encoder output of ``frames``): the
        patch rows are not predicted, the last token predicts nothing.
        Returns (loss, {"ce", "aux"}), float32 0-d tensors (on a mesh the
        same on every rank); every step from the embedding to the loss is
        differentiable."""
        cfg = self.cfg
        x = self._embed(params, batch)
        rope = rope_angles(torch.arange(x.shape[1], device=x.device),
                           cfg.head_dim_, cfg.rope_theta)
        cross = None
        if self.layout.kind == "encdec":
            enc = self._encoder(params, batch["frames"], train=True)
            cross = self._cross_kv_stack(params, enc)
        x, aux = self._seq_stack(params, x, rope, cross_kv=cross,
                                 remat=remat)
        x = rms_norm(x, params["final_norm"])
        tokens = torch.as_tensor(batch["tokens"], device=x.device)
        x_text = x[:, -tokens.shape[1]:]          # skip the patch rows
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
        ce = self._chunked_ce(params, x_text[:, :-1], labels, mask)
        aux = full(aux)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def _write_kv(self, buf: torch.Tensor, t: torch.Tensor,
                  slots: torch.Tensor, first: int, host_slots) -> None:
        """Prefill's rows ``first ..`` of ``t`` [B,S,K,hd] into the cache
        layer ``buf`` [B,Sc,K,hd] at ``slots`` (``host_slots`` the same
        on the host).  On a mesh each rank writes its pieces: its batch
        rows and heads, or under the "sequence" mode the slots in its
        range of rows (every head), chosen on the host."""
        mesh = self.mesh
        if mesh is None:
            buf.index_copy_(1, slots, t[:, first:].to(buf.dtype))
            return
        import numpy as np
        cs = _spec(buf, mesh)
        seq = resolve_kv_mode(self.cfg, mesh) == "sequence"
        ts = P(cs[0], None, *cs[2:])

        def body(c, t):
            lo = _model_rank(mesh) * c.shape[1] if seq else 0
            inr = (host_slots >= lo) & (host_slots < lo + c.shape[1])
            if inr.any():
                dst = torch.as_tensor(host_slots[inr] - lo, device=c.device)
                rows = torch.as_tensor(first + np.flatnonzero(inr),
                                       device=c.device)
                c.index_copy_(1, dst, t.index_select(1, rows).to(c.dtype))
            return c
        local_map(body, mesh, (cs, ts), cs)(buf, _shard(t, mesh, *ts))

    def prefill(self, params: Params, batch: Dict[str, Any],
                cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` [B,S] (after a VLM's
        ``batch["patches"]``; over Whisper's encoder output of
        ``batch["frames"]``), build the decode cache (``cache_len`` K/V
        slots, default S; positions count the patch rows), return
        (last-token logits [B,vocab] float32, cache).  A prompt longer
        than the cache's ``Sc`` slots keeps its last ``Sc`` positions:
        with a sliding window at slot ``p % Sc``, the ring rule of the
        decode step (ROADMAP R8: the reference writes them at ``0 ..
        Sc-1``, which its step's ring then contradicts), without one in
        order from slot 0, as the reference.  On a mesh the cache is
        placed by ``cache_specs``."""
        cfg, lay, mesh = self.cfg, self.layout, self.mesh
        x = self._embed(params, batch)
        B, S, _ = x.shape
        cache = init_cache(cfg, B, cache_len or S, device=x.device,
                           mesh=mesh)
        local(cache["pos"]).fill_(S)
        cross = None
        if lay.kind == "encdec":             # model.py:999-1003
            enc = self._encoder(params, batch["frames"])
            self._cross_kv_all(params, enc, cache["ck"], cache["cv"])
            cross = (cache["ck"], cache["cv"])
            del enc
        if "k" in cache:
            Sc = cache["k"].shape[2]
            keep = min(S, Sc)     # S > Sc keeps the last Sc positions
            kept = torch.arange(S - keep, S, device=x.device)
            slots = kept % Sc if cfg.sliding_window else kept - (S - keep)
            host_slots = None
            if mesh is not None:
                import numpy as np
                host = np.arange(S - keep, S)
                host_slots = host % Sc if cfg.sliding_window \
                    else host - (S - keep)
            local(cache["kv_pos"]).index_copy_(0, slots,
                                               kept.to(torch.int32))
            rope = rope_angles(torch.arange(S, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)

        def attend(p, x, i, cross_kv=None):
            x, (k, v), _ = attn_mixer_seq(cfg, p, x, rope, cross_kv=cross_kv,
                                          want_kv=True, mesh=mesh)
            self._write_kv(cache["k"][i], k, slots, S - keep, host_slots)
            self._write_kv(cache["v"][i], v, slots, S - keep, host_slots)
            return x

        def store(name, i, val):
            if mesh is None:
                cache[name][i] = val
            else:
                cache[name][i].copy_(val)

        if lay.kind in ("uniform", "encdec"):
            for i in range(cfg.num_layers):
                x = attend(_layer(params["blocks"], i), x, i,
                           None if cross is None
                           else (cross[0][i], cross[1][i]))
        elif lay.kind == "zamba":            # model.py:859-889
            for gi in range(lay.groups):
                for j in range(lay.per_group):
                    i = gi * lay.per_group + j
                    x, (convs, st) = mamba_mixer_seq(
                        cfg, _layer(params["mamba"], i), x, mesh=mesh)
                    for name, val in zip(("conv_x", "conv_B", "conv_C"),
                                         convs):
                        store(name, i, val)
                    store("state", i, st)
                x = attend(params["shared_attn"], x, gi)
        else:                                # xlstm, model.py:891-919
            per = lay.per_group - 1
            for gi in range(lay.groups):
                for j in range(per):
                    i = gi * per + j
                    x, st = mlstm_mixer_seq(cfg, _layer(params["mlstm"], i),
                                            x, mesh=mesh)
                    store("mstate", i, st)
                x, sstate = slstm_mixer_seq(cfg, _layer(params["slstm"], gi),
                                            x, mesh=mesh)
                for name, val in zip(("sc", "sn", "sh", "sm"), sstate):
                    store(name, gi, val)
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor, *, traced: bool = False):
        """One token for every sequence of the batch: tokens [B] ->
        (logits [B,vocab] float32, cache).  Updates ``cache`` in place —
        this token's K/V and ``kv_pos`` where the layout attends, every
        layer's conv window and recurrent state, and ``pos`` — and returns
        it.  Every index comes from ``cache["pos"]`` on its device (the
        reference's ``model.py:1037-1052``): no host read, so a captured
        step replays.

        ``traced=True`` is the form ``make_fx`` traces: the layer stack
        runs as one functional operator (``repro_torch::decode_layers``,
        or ``repro_torch::decode_recurrent_layers`` for Zamba2 and xLSTM),
        and the returned cache is a new dict whose ``stack_state`` tensors
        are that operator's new ones (``kv_pos`` and ``pos`` are still
        updated in place), as the reference's step returns a new cache.
        Whisper's cross cache ``ck``/``cv`` is read, never written.  On a
        mesh the operator runs on each rank's pieces and only on fake
        tensors (the dry-run's rolled pass, ``models/runtime.py``)."""
        cfg, kind, mesh = self.cfg, self.layout.kind, self.mesh
        x = self._embed_rows(params, torch.as_tensor(tokens)[:, None])
        B = x.shape[0]
        x = _shard(x, mesh, self._dp(B), None, None)
        pos = local(cache["pos"])
        attn = None
        card = _on_card(cfg, x)
        if "k" in cache:
            kv_pos = local(cache["kv_pos"])
            Sc = cache["k"].shape[2]
            slot = (pos % Sc if cfg.sliding_window
                    else pos.clamp(max=Sc - 1)).reshape(1).long()
            kv_pos.index_copy_(0, slot, pos.reshape(1))
            lengths = mask = None
            if card and resolve_kv_mode(cfg, mesh) == "heads":
                # decode_lengths(pos, Sc) for every row
                lengths = (pos + 1).clamp(max=Sc).expand(B).contiguous()
            else:
                mask1 = (kv_pos >= 0) & (kv_pos <= pos)
                if cfg.sliding_window:    # not &=: functionalize refuses it
                    mask1 = mask1 & (kv_pos > pos - cfg.sliding_window)
                mask = mask1[None].expand(B, Sc)
            rope = rope_angles(pos[None], cfg.head_dim_, cfg.rope_theta)
            attn = (slot, rope, lengths, mask)
        if kind in ("uniform", "encdec"):
            blocks = params["blocks"]
            cross = (cache["ck"], cache["cv"]) if kind == "encdec" else None
            if traced:
                names = tuple(sorted(blocks))
                args = ([blocks[n] for n in names], x, cache["k"],
                        cache["v"], slot, *rope, lengths, mask,
                        *(cross or (None, None)))
                op = torch.ops.repro_torch.decode_layers
                x, k, v = self._op(op, args, _stack_key(
                    cfg, names, mesh is not None), [x, cache["k"],
                                                    cache["v"]])
                cache = dict(cache, k=k, v=v)
            else:
                x = decode_layers(cfg, blocks, x, cache["k"], cache["v"],
                                  slot, rope, lengths, mask, cross, mesh)
        elif traced:
            flat = _flatten(params, _STACK_TREES[kind])
            names = tuple(sorted(flat))
            slot, (cos, sin), lengths, mask = attn or (None, (None, None),
                                                       None, None)
            state = [cache[n] for n in self.stack_state]
            op = torch.ops.repro_torch.decode_recurrent_layers
            x, *new = self._op(op, ([flat[n] for n in names], x, state,
                                    slot, cos, sin, lengths, mask),
                               _stack_key(cfg, names, mesh is not None),
                               [x] + state)
            cache = dict(cache, **dict(zip(self.stack_state, new)))
        else:
            x = decode_recurrent_layers(cfg, params, x, cache, attn, mesh)
        pos.add_(1)
        return self._logits(params, x[:, 0]), cache

    def _op(self, op, args, stack: int, outs):
        """A layer-stack operator; on a mesh on each rank's pieces, its
        results placed as ``outs`` lie."""
        if self.mesh is None:
            return op(*args, stack)
        mesh = self.mesh
        flat, spec = torch.utils._pytree.tree_flatten(list(args))
        specs = [_spec(a, mesh) for a in flat]

        def body(*xs):
            return op(*torch.utils._pytree.tree_unflatten(list(xs), spec),
                      stack)
        res = local_map(body, mesh, tuple(specs),
                        [_spec(o, mesh) for o in outs])(*flat)
        return list(res)


__all__ = ["DP", "Layout", "Model", "STACK_STATE", "UnsupportedConfigError",
           "attn_mixer_seq", "attn_mixer_step", "cache_specs", "check_config",
           "decode_layers", "decode_lengths", "decode_recurrent_layers",
           "init_cache", "init_params", "mamba_mixer_seq",
           "mlstm_mixer_seq",
           "model_layout", "param_specs", "resolve_kv_mode", "shard_params",
           "slstm_mixer_seq"]
