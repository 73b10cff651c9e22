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
own windowed prefill.  The mesh and sharding code come with sharded
serving.

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
from .layers import (NEG, apply_rope, chunked_attention,
                     decode_attention, rms_norm, rope_angles, swiglu)
from .moe import moe_ffn

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
                device=None) -> Params:
    """Random parameters with the reference's names, shapes, scales and
    dtypes (``model.py:78-240``, ``:285-316``), drawn on ``device`` (None:
    the card; ``"meta"``: shapes only) from ``generator`` (None: a new one
    on that device seeded with 0).  Values differ from the reference's:
    the two packages' generators differ."""
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


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None) -> Params:
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
    (0, 1, 0, -10))."""
    check_config(cfg)
    dev = _device(device)
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


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., d] @ w [d, *out] -> [..., *out] (the reference's
    ``einsum("bsd,d...->bs...")``)."""
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
    lead = out.shape[:-2]
    return out.reshape(lead + (-1,)) @ wo.reshape(-1, wo.shape[-1])


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The FFN sub-block (``model.py:441-454``): returns (x, aux), the MoE
    load-balance loss (a float32 0-d tensor) or 0.0 without experts.
    Only training reads aux."""
    aux = 0.0
    if cfg.is_moe:
        h = rms_norm(x, p["ln2"])
        y, aux = moe_ffn(h, p["router"], p["we_g"], p["we_u"], p["we_d"],
                         k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
        x = x + y
    elif cfg.d_ff:
        h = rms_norm(x, p["ln2"])
        x = x + swiglu(h, p["wg"], p["wu"], p["wdn"])
    return x, aux


def attn_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   rope: Tuple[torch.Tensor, torch.Tensor], *,
                   causal: bool = True, cross_kv=None,
                   want_kv: bool = False, train: bool = False):
    """Full-sequence attention block at positions ``0..S-1`` (prefill and
    training; Whisper's encoder with ``causal=False``, without a window,
    as the reference's ``model.py:817``), ``rope`` the (cos, sin) of those
    positions.  ``cross_kv`` = (ck, cv) [B, Senc, H, hd], the encoder's
    keys and values of this layer, adds the cross-attention sub-block:
    non-causal, no RoPE (``model.py:429-435``).  The configured sliding
    window bounds the causal self-attention only (``model.py:425-427``).
    Returns (x, (k, v) or None, aux of ``_ffn``).  K7 on the card, the
    chunked path on the CPU; ``train=True`` takes the chunked path on
    either device."""
    S = x.shape[1]
    card = not train and _on_card(cfg, x)
    window = cfg.sliding_window if causal else 0
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if card:
        out = kernels.flash_attention(q, k, v, causal=causal, window=window)
    else:
        positions = torch.arange(S, device=x.device)
        out = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk,
                                q_positions=positions,
                                kv_positions=positions,
                                sliding_window=window)
    x = x + _out_proj(out, p["wo"])
    if cross_kv is not None:
        ck, cv = cross_kv
        qx = _proj(rms_norm(x, p["ln_x"]), p["wq_x"])
        if card:
            out = kernels.flash_attention(qx, ck, cv, causal=False)
        else:
            out = chunked_attention(qx, ck, cv, causal=False,
                                    chunk=cfg.attn_chunk)
        x = x + _out_proj(out, p["wo_x"])
    x, aux = _ffn(cfg, p, x)
    return x, ((k, v) if want_kv else None), aux


def attn_mixer_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    slot: torch.Tensor,
                    rope: Tuple[torch.Tensor, torch.Tensor], *,
                    lengths: Optional[torch.Tensor] = None,
                    length_mask: Optional[torch.Tensor] = None,
                    cross_kv=None) -> torch.Tensor:
    """Single-token decode block: x [B,1,d]; caches [B,Sc,K,hd], into whose
    slot ``slot`` (a [1] int64 tensor on their device) this token's K/V are
    written in place.  On the card K8 attends over the first ``lengths[b]``
    slots; on the CPU the plain path over ``length_mask`` [B,Sc].
    ``cross_kv`` = (ck, cv, valid): this layer's encoder keys and values
    [B,Senc,H,hd], read only, and the rows to attend in the same form —
    lengths on the card, a mask on the CPU, all ``Senc`` rows
    (``model.py:557-563``).  Returns the new x."""
    card = _on_card(cfg, x)
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    if card:
        out = kernels.decode_attention(q[:, 0], k_cache, v_cache,
                                       lengths)[:, None]
    else:
        out = decode_attention(q, k_cache, v_cache, length_mask=length_mask)
    x = x + _out_proj(out, p["wo"])
    if cross_kv is not None:
        ck, cv, valid = cross_kv
        qx = _proj(rms_norm(x, p["ln_x"]), p["wq_x"])
        if card:
            out = kernels.decode_attention(qx[:, 0], ck, cv, valid)[:, None]
        else:
            out = decode_attention(qx, ck, cv, length_mask=valid)
        x = x + _out_proj(out, p["wo_x"])
    return _ffn(cfg, p, x)[0]


def _head_rms(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm: y [B,S,H,P] (or [B,H,P]), scale [H,P]."""
    dt = y.dtype
    y = y.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    return (y * scale).to(dt)


def _mamba_pre(cfg: ModelConfig, p: Params, h: torch.Tensor, conv_caches):
    """Projections and causal convs (``model.py:576-594``).  h [B,S,d] ->
    (xh [B,S,H,P], z, Bv, Cv, log decay [B,S,H], dt, new conv caches)."""
    B, S, _ = h.shape
    H, Ph = cfg.ssm_heads, cfg.ssm_head_dim
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


def _mamba_out(p: Params, x: torch.Tensor, y: torch.Tensor,
               xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The D skip on the post-conv ``xh``, the ``silu(z)`` gate, the head
    norm and the output projection, added to the residual ``x``."""
    y = y + p["D"][:, None] * xh.float()
    y = y * F.silu(z.float())
    y = _head_rms(y, p["out_norm"])
    return x + _out_proj(y.to(x.dtype), p["w_out"])


def mamba_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    state_in=None, conv_in=None):
    """A Mamba2 layer over a sequence (``model.py:597-615``).  Returns
    (x, ((conv_x, conv_B, conv_C) windows, state [B,H,N,P]))."""
    B, S, _ = x.shape
    H, N = cfg.ssm_heads, cfg.ssm_state
    h = rms_norm(x, p["ln"])
    conv0 = conv_in if conv_in is not None else (None, None, None)
    xh, z, Bv, Cv, ld, dt, convs = _mamba_pre(cfg, p, h, conv0)
    qh = Cv[:, :, None, :].expand(B, S, H, N)
    kh = Bv[:, :, None, :].expand(B, S, H, N)
    y, state = ssm.chunked_linear_attention(
        qh, kh, xh, ld, dt, chunk=cfg.ssm_chunk, state_in=state_in)
    return _mamba_out(p, x, y, xh, z), (convs, state)


def _conv_step(x_t: torch.Tensor, w: torch.Tensor, cache: torch.Tensor):
    """x_t [B,1,C]; w [W,C]; cache [B,W-1,C] -> (silu(y) [B,1,C], the
    window shifted by one)."""
    xc = torch.cat([cache, x_t], 1)                       # [B,W,C]
    y = torch.einsum("bwc,wc->bc", xc.float(), w.float())[:, None]
    return F.silu(y).to(x_t.dtype), xc[:, 1:]


def mamba_mixer_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: torch.Tensor, convs):
    """A Mamba2 layer on one token (``model.py:626-649``).  Returns (x,
    (new state, new conv windows))."""
    B = x.shape[0]
    H, Ph, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
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
    x = _mamba_out(p, x[:, 0], y, xh, z)[:, None]
    return x, (state, (cx, cb, cc))


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
                    state_in=None):
    """An mLSTM layer over a sequence (``model.py:652-669``).  Returns
    (x, state [B,H,P,P+1])."""
    h = rms_norm(x, p["ln"])
    q, k, v, fg, ig = _mlstm_pre(cfg, p, h)
    y, state = ssm.chunked_linear_attention(
        q, k, v, fg, ig, chunk=cfg.ssm_chunk, normalize=True,
        state_in=state_in)
    y = _head_rms(y, p["out_norm"])
    return x + _out_proj(y.to(x.dtype), p["w_o"]), state


def mlstm_mixer_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     state: torch.Tensor):
    """An mLSTM layer on one token (``model.py:672-688``)."""
    h = rms_norm(x, p["ln"])[:, 0]
    q, k, v, fg, ig = _mlstm_pre(cfg, p, h)
    y, state = ssm.linear_attention_step(state, q, k, v, fg, ig,
                                         normalize=True)
    y = _head_rms(y, p["out_norm"])
    return x + _out_proj(y.to(x.dtype), p["w_o"])[:, None], state


def slstm_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                    state_in=None):
    """An sLSTM layer over a sequence (``model.py:691-699``); the decode
    step is the same on one token from the cached state."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"])
    gates = (_proj(h, p["w_in"]) + p["b"]).float()
    hs, state = ssm.slstm_scan(gates, p["r"], state_in)
    return x + hs.reshape(B, S, d).to(x.dtype) @ p["w_o"], state


# ------------------------------------------------------ decode layer stacks
def decode_layers(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor,
                  rope: Tuple[torch.Tensor, torch.Tensor],
                  lengths: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor],
                  cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> torch.Tensor:
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
    for i in range(cfg.num_layers):
        ckv = None if cross is None else (cross[0][i], cross[1][i], valid)
        try:
            x = attn_mixer_step(cfg, _layer(blocks, i), x, k[i], v[i], slot,
                                rope, lengths=lengths, length_mask=mask,
                                cross_kv=ckv)
        except Exception as e:
            e.add_note(f"decode layer {i}")
            raise
    return x


def decode_recurrent_layers(cfg: ModelConfig, trees: Params,
                            x: torch.Tensor, cache: Params, attn
                            ) -> torch.Tensor:
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
    for gi in range(lay.groups):
        for j in range(inner):
            i = gi * inner + j
            try:
                if lay.kind == "zamba":
                    convs = tuple(cache[n][i]
                                  for n in ("conv_x", "conv_B", "conv_C"))
                    x, (st, new) = mamba_mixer_step(
                        cfg, _layer(trees["mamba"], i), x,
                        cache["state"][i], convs)
                    for buf, val in zip(convs, new):
                        buf.copy_(val)
                    cache["state"][i].copy_(st)
                else:
                    x, st = mlstm_mixer_step(cfg, _layer(trees["mlstm"], i),
                                             x, cache["mstate"][i])
                    cache["mstate"][i].copy_(st)
            except Exception as e:
                e.add_note(f"decode layer {i} ({lay.kind} group {gi})")
                raise
        try:
            if lay.kind == "zamba":
                slot, rope, lengths, mask = attn
                x = attn_mixer_step(cfg, trees["shared_attn"], x,
                                    cache["k"][gi], cache["v"][gi], slot,
                                    rope, lengths=lengths, length_mask=mask)
            else:
                names = ("sc", "sn", "sh", "sm")
                bufs = [cache[n][gi] for n in names]
                x, new = slstm_mixer_seq(cfg, _layer(trees["slstm"], gi), x,
                                         state_in=tuple(bufs))
                for buf, val in zip(bufs, new):
                    buf.copy_(val)
        except Exception as e:
            e.add_note(f"decode group {gi} ({lay.kind} closing block)")
            raise
    return x


# (config, block names) of each model the layer-stack operators have run;
# an operator's schema takes tensors and scalars, so it gets an index here
_STACKS: List[Tuple[ModelConfig, Tuple[str, ...]]] = []


def _stack_key(cfg: ModelConfig, names: Tuple[str, ...]) -> int:
    entry = (cfg, names)
    if entry not in _STACKS:
        _STACKS.append(entry)
    return _STACKS.index(entry)


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
    cfg, names = _STACKS[stack]
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
    cfg, names = _STACKS[stack]
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
    are."""

    def __init__(self, cfg: ModelConfig):
        check_config(cfg)
        self.cfg = cfg
        self.layout = model_layout(cfg)
        # the cache tensors the decode step's layer stack updates
        self.stack_state = STACK_STATE[self.layout.kind]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [B,d] -> float32 logits over the logical vocab."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].t() if cfg.tie_embeddings else params["head"]
        return (x @ head).float()[:, :cfg.vocab_size]

    def _embed(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """The token rows [B,S,d] of ``batch["tokens"]``, after a VLM's patch
        rows, ``batch["patches"]`` cast to the model dtype before the
        product with ``vis_proj`` as the reference casts them
        (``model.py:798-807``)."""
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        x = F.embedding(tokens, embed)
        if self.cfg.num_patch_tokens:
            patches = torch.as_tensor(batch["patches"], device=embed.device)
            x = torch.cat([patches.to(x.dtype) @ params["vis_proj"], x], 1)
        return x

    def _encoder(self, params: Params, frames,
                 train: bool = False) -> torch.Tensor:
        """Whisper's encoder on the stub frame embeddings [B, Senc,
        frontend_dim] (``model.py:809-823``): ``frame_proj``, then every
        encoder block non-causal with RoPE at positions ``0..Senc-1``
        (``train``: ``attn_mixer_seq``'s training route; not checkpointed,
        as the reference's is not)."""
        cfg = self.cfg
        w = params["frame_proj"]
        x = torch.as_tensor(frames, device=w.device).to(w.dtype) @ w
        rope = rope_angles(torch.arange(x.shape[1], device=x.device),
                           cfg.head_dim_, cfg.rope_theta)
        for i, p in enumerate(_layers(params["encoder"])
                              [:cfg.encoder_layers]):
            try:
                x, _, _ = attn_mixer_seq(cfg, p, x, rope, causal=False,
                                         train=train)
            except Exception as e:
                e.add_note(f"encoder layer {i}")
                raise
        return x

    def _cross_kv_all(self, params: Params, enc: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor) -> None:
        """Every decoder layer's cross K/V of the encoder output ``enc``
        into ``ck``/``cv`` [L, B, Senc, H, hd] (``model.py:825-830``)."""
        bl = params["blocks"]
        for i in range(self.cfg.num_layers):
            ck[i] = _proj(enc, bl["wk_x"][i])
            cv[i] = _proj(enc, bl["wv_x"][i])

    def _cross_kv_stack(self, params: Params, enc: torch.Tensor):
        """Every decoder layer's cross K/V of the encoder output ``enc`` as
        new tensors (ck, cv) [L, B, Senc, H, hd], through which gradients
        pass (``model.py:825-830``; prefill writes them into its cache
        instead, ``_cross_kv_all``)."""
        bl = params["blocks"]
        return tuple(torch.stack([_proj(enc, w) for w in bl[n].unbind(0)])
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
        cfg, lay = self.cfg, self.layout
        aux = x.new_zeros((), dtype=torch.float32)

        def run(body, *args):
            if remat:
                return checkpoint(body, *args, use_reentrant=False)
            return body(*args)

        def attend(p, x, ckv=None):
            x, _, a = attn_mixer_seq(cfg, p, x, rope, cross_kv=ckv,
                                     train=True)
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
                return slstm_mixer_seq(cfg, p, x)[0], 0.0

        def group(ps, pc, x):
            for p in ps:
                x, _ = mix(cfg, p, x)
            return close(pc, x)

        for gi in range(lay.groups):
            x, a = run(group, inner[gi * per:(gi + 1) * per], closing[gi], x)
            aux = aux + a
        return x, aux

    def _chunked_ce(self, params: Params, x: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 1024) -> torch.Tensor:
        """Mean masked cross-entropy of ``x`` [B,S,d] against ``labels``
        [B,S] without the [B,S,V] logits (``model.py:924-959``): S padded
        to whole chunks of ``chunk`` rows, each chunk's logits the product
        in the model dtype, widened to float32, the padded vocab rows
        ``-1e30``, ``logsumexp - gold``, masked.  Each chunk is
        checkpointed, so one chunk's float32 logits are live at a time,
        in the backward too.  Chunk sums and the count add in chunk order,
        as the reference's scan adds them."""
        cfg = self.cfg
        head = params["embed"].t() if cfg.tie_embeddings else params["head"]
        S = x.shape[1]
        n = -(-S // chunk)
        pad = n * chunk - S
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad))
            mask = F.pad(mask, (0, pad))
        vmask = torch.arange(cfg.padded_vocab, device=x.device) \
            >= cfg.vocab_size

        def nll(xi, li, mi, head):
            logits = (xi @ head).float().masked_fill(vmask, NEG)
            gold = logits.gather(-1, li[..., None].long())[..., 0]
            return ((torch.logsumexp(logits, -1) - gold) * mi).sum()

        tot = cnt = x.new_zeros((), dtype=torch.float32)
        for c in range(n):
            sl = slice(c * chunk, (c + 1) * chunk)
            tot = tot + checkpoint(nll, x[:, sl], labels[:, sl],
                                   mask[:, sl], head, use_reentrant=False)
            cnt = cnt + mask[:, sl].sum()
        return tot / torch.clamp_min(cnt, 1.0)

    def loss_fn(self, params: Params, batch: Dict[str, Any],
                remat: bool = True):
        """Next-token LM loss plus 0.01 × the MoE load-balance loss
        (``model.py:962-985``) of ``batch["tokens"]`` [B,S] (after a VLM's
        ``patches``; over Whisper's encoder output of ``frames``): the
        patch rows are not predicted, the last token predicts nothing.
        Returns (loss, {"ce", "aux"}), float32 0-d tensors; every step
        from the embedding to the loss is differentiable."""
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
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

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
        order from slot 0, as the reference."""
        cfg, lay = self.cfg, self.layout
        x = self._embed(params, batch)
        B, S, _ = x.shape
        cache = init_cache(cfg, B, cache_len or S, device=x.device)
        cache["pos"].fill_(S)
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
            cache["kv_pos"].index_copy_(0, slots, kept.to(torch.int32))
            rope = rope_angles(torch.arange(S, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)

        def attend(p, x, i, cross_kv=None):
            x, (k, v), _ = attn_mixer_seq(cfg, p, x, rope, cross_kv=cross_kv,
                                          want_kv=True)
            for name, t in (("k", k), ("v", v)):
                cache[name][i].index_copy_(
                    1, slots, t[:, S - keep:].to(cache[name].dtype))
            return x

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
                        cfg, _layer(params["mamba"], i), x)
                    for name, val in zip(("conv_x", "conv_B", "conv_C"),
                                         convs):
                        cache[name][i] = val
                    cache["state"][i] = st
                x = attend(params["shared_attn"], x, gi)
        else:                                # xlstm, model.py:891-919
            per = lay.per_group - 1
            for gi in range(lay.groups):
                for j in range(per):
                    i = gi * per + j
                    x, st = mlstm_mixer_seq(cfg, _layer(params["mlstm"], i),
                                            x)
                    cache["mstate"][i] = st
                x, sstate = slstm_mixer_seq(cfg, _layer(params["slstm"], gi),
                                            x)
                for name, val in zip(("sc", "sn", "sh", "sm"), sstate):
                    cache[name][gi] = val
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
        Whisper's cross cache ``ck``/``cv`` is read, never written."""
        cfg, kind = self.cfg, self.layout.kind
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device)
        x = F.embedding(tokens[:, None], embed)
        B = x.shape[0]
        pos = cache["pos"]
        attn = None
        if "k" in cache:
            kv_pos = cache["kv_pos"]
            Sc = cache["k"].shape[2]
            slot = (pos % Sc if cfg.sliding_window
                    else pos.clamp(max=Sc - 1)).reshape(1).long()
            kv_pos.index_copy_(0, slot, pos.reshape(1))
            lengths = mask = None
            if _on_card(cfg, x):
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
                x, k, v = torch.ops.repro_torch.decode_layers(
                    [blocks[n] for n in names], x, cache["k"], cache["v"],
                    slot, *rope, lengths, mask, *(cross or (None, None)),
                    _stack_key(cfg, names))
                cache = dict(cache, k=k, v=v)
            else:
                x = decode_layers(cfg, blocks, x, cache["k"], cache["v"],
                                  slot, rope, lengths, mask, cross)
        elif traced:
            flat = _flatten(params, _STACK_TREES[kind])
            names = tuple(sorted(flat))
            slot, (cos, sin), lengths, mask = attn or (None, (None, None),
                                                       None, None)
            x, *new = torch.ops.repro_torch.decode_recurrent_layers(
                [flat[n] for n in names], x,
                [cache[n] for n in self.stack_state], slot, cos, sin,
                lengths, mask, _stack_key(cfg, names))
            cache = dict(cache, **dict(zip(self.stack_state, new)))
        else:
            x = decode_recurrent_layers(cfg, params, x, cache, attn)
        pos.add_(1)
        return self._logits(params, x[:, 0]), cache


__all__ = ["Layout", "Model", "STACK_STATE", "UnsupportedConfigError",
           "attn_mixer_seq", "attn_mixer_step", "check_config",
           "decode_layers", "decode_lengths", "decode_recurrent_layers",
           "init_cache", "init_params", "mamba_mixer_seq",
           "mamba_mixer_step", "mlstm_mixer_seq", "mlstm_mixer_step",
           "model_layout", "slstm_mixer_seq"]
