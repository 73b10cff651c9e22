"""The decoder stacks of ``src/repro/models/model.py`` on PyTorch.

The port builds three of the reference's layouts (``model_layout``), with
the same parameter names, shapes, scales and dtypes, the same decode cache
and the same prefill / greedy decode contract:

* ``"uniform"`` — dense and MoE decoders (Llama, Qwen2, Phi-3, GLM-4,
  Granite-MoE, Phi-3.5-MoE): one stack of attention blocks over stacked
  per-layer parameters ``[L, ...]``, ``moe.moe_ffn`` in place of the
  SwiGLU FFN for MoE;
* ``"zamba"`` — the Zamba2 hybrid: groups of Mamba2 layers
  (``params["mamba"]``, stacked ``[groups·per_group, ...]``), each group
  followed by one weight-shared attention block
  (``params["shared_attn"]``, unstacked) with its own K/V cache layer;
* ``"xlstm"`` — groups of mLSTM layers closed by one sLSTM layer
  (``params["mlstm"]``, ``params["slstm"]``).

The recurrences are ``ssm.py``'s, in plain PyTorch on either device, as
the reference computes them in ``jnp``.  The reference's scans over
layers and groups are loops here; the traced form of the decode step
wraps the layer stack in one functional operator —
``torch.ops.repro_torch.decode_layers`` for the uniform stack,
``torch.ops.repro_torch.decode_recurrent_layers`` for the other two — the
counterpart of the reference's outer scan equation, so that the paper's
reordering (``serving.ServingEngine.analyse_decode_schedule``) sees the
layer stack as one operator, as the reference's jaxpr does.

The device decides the attention, as it does for the CNN kernels: on CUDA
tensors prefill runs the flash-attention kernel K7 and each decode step the
decode-attention kernel K8 (``repro_torch.kernels``); on CPU tensors the
same calls go to the plain ``layers.chunked_attention`` /
``layers.decode_attention``, as the reference's model does.  The kernels
are the same computation as the reference's jnp attention
(``src/repro/models/layers.py:7-9``, ``:135``).

Configurations outside this slice raise ``UnsupportedConfigError`` naming
the ROADMAP item that brings them: Whisper and the VLM, and a sliding
window on the card (the CPU path has it).  The mesh and sharding code and
``loss_fn`` come with training and sharded serving.

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

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ReproError

from . import ssm
from .layers import (apply_rope, chunked_attention, decode_attention,
                     rms_norm, rope_angles, swiglu)
from .moe import moe_ffn

Params = Dict[str, Any]

# where each configuration outside this slice comes in (ROADMAP.md Queue 1)
_LATER = {
    "audio": "ROADMAP Queue 1 item 10 (Whisper and the VLM)",
    "vlm": "ROADMAP Queue 1 item 10 (Whisper and the VLM)",
}
_WINDOW_ON_CARD = "ROADMAP Queue 1 item 16 (sliding-window attention on " \
    "the card)"


class UnsupportedConfigError(ReproError, NotImplementedError):
    """A model configuration this slice of the port does not build; the
    message names the ROADMAP item that brings it."""


def check_config(cfg: ModelConfig) -> None:
    """Raise ``UnsupportedConfigError`` unless ``cfg`` is a dense, MoE,
    hybrid (Zamba2) or xLSTM decoder without patch tokens or an
    encoder."""
    kind = cfg.arch_type
    if kind not in ("dense", "moe", "hybrid", "ssm") \
            or cfg.num_patch_tokens or cfg.encoder_layers:
        later = _LATER.get(kind, _LATER["vlm"])
        raise UnsupportedConfigError(
            f"{cfg.name}: arch_type {kind!r} is not in the port yet; it "
            f"comes with {later}")


def _on_card(cfg: ModelConfig, x: torch.Tensor) -> bool:
    if not x.is_cuda:
        return False
    if cfg.sliding_window:
        raise UnsupportedConfigError(
            f"{cfg.name}: sliding_window={cfg.sliding_window} runs only on "
            f"the CPU path so far; on the card it comes with "
            f"{_WINDOW_ON_CARD}")
    return True


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


def _attn_block_params(cfg: ModelConfig, init: _Init,
                       n_layers: int) -> Params:
    """An attention block with its FFN (``model.py:82-126``): stacked
    ``[n_layers, ...]``, or unstacked when ``n_layers`` is 0."""
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
    dtypes (``model.py:78-240``, ``:285-317``), drawn on ``device`` (None:
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
    else:
        p["blocks"] = _attn_block_params(cfg, init, cfg.num_layers)
    return p


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None) -> Params:
    """Zeroed decode cache (``model.py:713-750``), all on ``device`` (None:
    the card).  ``pos`` (int32 scalar); with attention ``k``/``v``
    [layers, B, Sc, K, hd] (one layer per shared-attention application
    for Zamba2) and ``kv_pos`` ([Sc] int32, -1 = empty), ``Sc`` being
    ``cache_len`` or the sliding window if smaller; Zamba2's conv windows
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
    if lay.kind in ("uniform", "zamba"):
        Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        layers = lay.groups if lay.kind == "zamba" else cfg.num_layers
        shape = (layers, B, Sc, cfg.num_kv_heads, cfg.head_dim_)
        c["k"], c["v"] = zeros(shape, dt), zeros(shape, dt)
        c["kv_pos"] = torch.full((Sc,), -1, dtype=torch.int32, device=dev)
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
    """The valid prefix of the cache for the token at ``pos``, without a
    sliding window: slots ``0 .. min(pos, Sc-1)`` hold positions ``<= pos``
    (the prompt from slot 0, then one slot per step, the last slot
    overwritten once the cache is full), which is exactly the reference's
    mask ``(kv_pos >= 0) & (kv_pos <= pos)`` (``model.py:1043-1049``).
    ``decode_step`` computes the same on the device from a tensor ``pos``."""
    return min(pos + 1, cache_slots)


# ------------------------------------------------------------------ mixers
def _layer(blocks: Params, i: int) -> Params:
    return {name: t[i] for name, t in blocks.items()}


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


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.is_moe:      # the load-balance loss matters only to training
        h = rms_norm(x, p["ln2"])
        y, _ = moe_ffn(h, p["router"], p["we_g"], p["we_u"], p["we_d"],
                       k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor)
        x = x + y
    elif cfg.d_ff:
        h = rms_norm(x, p["ln2"])
        x = x + swiglu(h, p["wg"], p["wu"], p["wdn"])
    return x


def attn_mixer_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   rope: Tuple[torch.Tensor, torch.Tensor], *,
                   want_kv: bool = False):
    """Full-sequence causal attention block at positions ``0..S-1``
    (prefill), ``rope`` the (cos, sin) of those positions.  Returns
    (x, (k, v) or None).  K7 on the card, the chunked path on the CPU."""
    S = x.shape[1]
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    if _on_card(cfg, x):
        out = kernels.flash_attention(q, k, v, causal=True)
    else:
        positions = torch.arange(S, device=x.device)
        out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                q_positions=positions,
                                kv_positions=positions,
                                sliding_window=cfg.sliding_window)
    x = x + _out_proj(out, p["wo"])
    return _ffn(cfg, p, x), ((k, v) if want_kv else None)


def attn_mixer_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    slot: torch.Tensor,
                    rope: Tuple[torch.Tensor, torch.Tensor], *,
                    lengths: Optional[torch.Tensor] = None,
                    length_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Single-token decode block: x [B,1,d]; caches [B,Sc,K,hd], into whose
    slot ``slot`` (a [1] int64 tensor on their device) this token's K/V are
    written in place.  On the card K8 attends over the first ``lengths[b]``
    slots; on the CPU the plain path over ``length_mask`` [B,Sc].  Returns
    the new x."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _proj_qkv(cfg, p, h)
    q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    if _on_card(cfg, x):
        out = kernels.decode_attention(q[:, 0], k_cache, v_cache,
                                       lengths)[:, None]
    else:
        out = decode_attention(q, k_cache, v_cache, length_mask=length_mask)
    x = x + _out_proj(out, p["wo"])
    return _ffn(cfg, p, x)


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
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The uniform decode step's layer stack: ``attn_mixer_step`` of every
    layer over the stacked ``blocks`` and caches ``k``/``v`` [L, B, Sc,
    K, hd], which it updates in place.  Returns the new x."""
    for i in range(cfg.num_layers):
        try:
            x = attn_mixer_step(cfg, _layer(blocks, i), x, k[i], v[i], slot,
                                rope, lengths=lengths, length_mask=mask)
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
                      mask: Optional[torch.Tensor], stack: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_layers`` as one functional operator (the reference's scan
    equation, ``model.py:1061-1075``): it updates copies of the caches and
    returns ``(x, k_new, v_new)``.  ``blocks`` are the stacked block
    tensors in the order of the names registered under ``stack``."""
    cfg, names = _STACKS[stack]
    k, v = k.clone(), v.clone()
    x = decode_layers(cfg, dict(zip(names, blocks)), x, k, v, slot,
                      (cos, sin), lengths, mask)
    return x, k, v


@_decode_layers_op.register_fake
def _(blocks, x, k, v, slot, cos, sin, lengths, mask, stack):
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
    """Prefill and greedy-decode entry points of a dense, MoE, Zamba2 or
    xLSTM decoder.  They take the parameters explicitly and run where the
    parameters are."""

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

    def prefill(self, params: Params, batch: Dict[str, Any],
                cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` [B,S], build the decode cache
        (``cache_len`` K/V slots, default S), return (last-token logits
        [B,vocab] float32, cache)."""
        cfg, lay = self.cfg, self.layout
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        x = F.embedding(tokens, embed)
        B, S, _ = x.shape
        cache = init_cache(cfg, B, cache_len or S, device=x.device)
        cache["pos"].fill_(S)
        if "k" in cache:
            Sc = cache["k"].shape[2]
            keep = min(S, Sc)     # S > Sc keeps the last Sc positions
            cache["kv_pos"][:keep] = torch.arange(
                S - keep, S, dtype=torch.int32, device=x.device)
            rope = rope_angles(torch.arange(S, device=x.device),
                               cfg.head_dim_, cfg.rope_theta)

        def attend(p, x, i):
            x, (k, v) = attn_mixer_seq(cfg, p, x, rope, want_kv=True)
            cache["k"][i, :, :keep] = k[:, S - keep:]
            cache["v"][i, :, :keep] = v[:, S - keep:]
            return x

        if lay.kind == "uniform":
            for i in range(cfg.num_layers):
                x = attend(_layer(params["blocks"], i), x, i)
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
        updated in place), as the reference's step returns a new cache."""
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
                if cfg.sliding_window:
                    mask1 &= kv_pos > pos - cfg.sliding_window
                mask = mask1[None].expand(B, Sc)
            rope = rope_angles(pos[None], cfg.head_dim_, cfg.rope_theta)
            attn = (slot, rope, lengths, mask)
        if kind == "uniform":
            blocks = params["blocks"]
            if traced:
                names = tuple(sorted(blocks))
                x, k, v = torch.ops.repro_torch.decode_layers(
                    [blocks[n] for n in names], x, cache["k"], cache["v"],
                    slot, *rope, lengths, mask, _stack_key(cfg, names))
                cache = dict(cache, k=k, v=v)
            else:
                x = decode_layers(cfg, blocks, x, cache["k"], cache["v"],
                                  slot, rope, lengths, mask)
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
