"""The dense decoder stack of ``src/repro/models/model.py`` on PyTorch.

The port builds the reference's ``"uniform"`` layout for dense decoders
(Llama, Qwen2, Phi-3, GLM-4): one stack of attention blocks over stacked
per-layer parameters ``[L, ...]``, with the same parameter names, shapes,
scales and dtypes, the same decode cache and the same prefill / greedy
decode contract.  The scan over layers is a loop over layers
(``decode_layers``); the traced form of the decode step wraps that loop
in one functional operator, ``torch.ops.repro_torch.decode_layers``, the
counterpart of the reference's scan equation, so that the paper's
reordering (``serving.ServingEngine.analyse_decode_schedule``) sees the
layer stack as one operator, as the reference's jaxpr does.

The device decides the attention, as it does for the CNN kernels: on CUDA
tensors prefill runs the flash-attention kernel K7 and each decode step the
decode-attention kernel K8 (``repro_torch.kernels``); on CPU tensors the
same calls go to the plain ``layers.chunked_attention`` /
``layers.decode_attention``, as the reference's model does.  The kernels
are the same computation as the reference's jnp attention
(``src/repro/models/layers.py:7-9``, ``:135``).

MoE decoders (Granite-MoE, Phi-3.5-MoE) are the same stack with
``moe.moe_ffn`` in place of the SwiGLU FFN.  Configurations outside this
slice raise ``UnsupportedConfigError`` naming the ROADMAP item that brings
them: the Zamba2 hybrid, xLSTM, Whisper and the VLM, and a sliding window
on the card (the CPU path has it).  The mesh and sharding code and
``loss_fn`` come with training and sharded serving.

One departure from the reference: the decode step updates its cache in
place — the new token's K/V, ``kv_pos`` and ``pos`` — where the reference
returns a new one (a copy per step would move the whole cache, 235 MB per
request for Llama-3.2-3B at 2048 positions).  ``pos`` and ``kv_pos`` lie
on the cache's device, and the step derives its cache slot, valid lengths
and RoPE angles from ``pos`` there: it makes no host read, so one
captured step can be replayed (``serving.ServingEngine``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import ReproError

from .layers import (apply_rope, chunked_attention, decode_attention,
                     rms_norm, rope_angles, swiglu)
from .moe import moe_ffn

Params = Dict[str, Any]

# where each configuration outside this slice comes in (ROADMAP.md Queue 1)
_LATER = {
    "hybrid": "ROADMAP Queue 1 item 9 (the Zamba2 hybrid and xLSTM, "
              "models/ssm.py)",
    "ssm": "ROADMAP Queue 1 item 9 (the Zamba2 hybrid and xLSTM, "
           "models/ssm.py)",
    "audio": "ROADMAP Queue 1 item 10 (Whisper and the VLM)",
    "vlm": "ROADMAP Queue 1 item 10 (Whisper and the VLM)",
}
_WINDOW_ON_CARD = "ROADMAP Queue 1 item 16 (sliding-window attention on " \
    "the card)"


class UnsupportedConfigError(ReproError, NotImplementedError):
    """A model configuration this slice of the port does not build; the
    message names the ROADMAP item that brings it."""


def check_config(cfg: ModelConfig) -> None:
    """Raise ``UnsupportedConfigError`` unless ``cfg`` is a dense or MoE
    decoder without patch tokens or an encoder."""
    kind = cfg.arch_type
    if kind not in ("dense", "moe") or cfg.num_patch_tokens \
            or cfg.encoder_layers:
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


# ------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """Random parameters with the reference's names, shapes, scales and
    dtypes (``model.py:78-126``, ``:285-317``), drawn on ``device`` (None:
    the card; ``"meta"``: shapes only) from ``generator`` (None: a new one
    on that device seeded with 0).  Values differ from the reference's:
    the two packages' generators differ."""
    check_config(cfg)
    dev = _device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = _dtype(cfg)

    def normal(shape, scale, dtype=dt):
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dtype)

    def const(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    d, V = cfg.d_model, cfg.padded_vocab
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    L = (cfg.num_layers,)
    s_in = 1.0 / math.sqrt(d)
    p: Params = {"embed": normal((V, d), 1.0),
                 "final_norm": const((d,), 1.0, torch.float32)}
    if not cfg.tie_embeddings:
        p["head"] = normal((d, V), s_in)
    blocks = {
        "ln1": const(L + (d,), 1.0, torch.float32),
        "wq": normal(L + (d, H, hd), s_in),
        "wk": normal(L + (d, K, hd), s_in),
        "wv": normal(L + (d, K, hd), s_in),
        "wo": normal(L + (H, hd, d), 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        blocks["bq"] = const(L + (H, hd), 0.0, dt)
        blocks["bk"] = const(L + (K, hd), 0.0, dt)
        blocks["bv"] = const(L + (K, hd), 0.0, dt)
    if cfg.is_moe:
        ff, E = cfg.d_ff, cfg.num_experts
        blocks.update({
            "ln2": const(L + (d,), 1.0, torch.float32),
            "router": normal(L + (d, E), s_in, torch.float32),
            "we_g": normal(L + (E, d, ff), s_in),
            "we_u": normal(L + (E, d, ff), s_in),
            "we_d": normal(L + (E, ff, d), 1.0 / math.sqrt(ff)),
        })
    elif cfg.d_ff:
        ff = cfg.d_ff
        blocks.update({
            "ln2": const(L + (d,), 1.0, torch.float32),
            "wg": normal(L + (d, ff), s_in),
            "wu": normal(L + (d, ff), s_in),
            "wdn": normal(L + (ff, d), 1.0 / math.sqrt(ff)),
        })
    p["blocks"] = blocks
    return p


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               device=None) -> Params:
    """Zeroed decode cache (``model.py:713-750``, the uniform part), all on
    ``device`` (None: the card): ``k``/``v`` [L, B, Sc, K, hd], ``pos``
    (int32 scalar) and ``kv_pos`` ([Sc] int32, -1 = empty).  ``Sc`` is
    ``cache_len``, or the sliding window if smaller."""
    check_config(cfg)
    dev = _device(device)
    Sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    shape = (cfg.num_layers, batch_size, Sc, cfg.num_kv_heads,
             cfg.head_dim_)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "kv_pos": torch.full((Sc,), -1, dtype=torch.int32, device=dev)}


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


def _proj_qkv(cfg: ModelConfig, p: Params, h: torch.Tensor):
    """h [B,S,d] -> q [B,S,H,hd], k and v [B,S,K,hd]."""
    B, S, d = h.shape

    def proj(w):
        return (h @ w.reshape(d, -1)).reshape(B, S, w.shape[1], w.shape[2])

    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out [B,S,H,hd] @ wo [H,hd,d] -> [B,S,d]."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


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


def decode_layers(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, slot: torch.Tensor,
                  rope: Tuple[torch.Tensor, torch.Tensor],
                  lengths: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The decode step's layer stack: ``attn_mixer_step`` of every layer
    over the stacked ``blocks`` and caches ``k``/``v`` [L, B, Sc, K, hd],
    which it updates in place.  Returns the new x."""
    for i in range(cfg.num_layers):
        try:
            x = attn_mixer_step(cfg, _layer(blocks, i), x, k[i], v[i], slot,
                                rope, lengths=lengths, length_mask=mask)
        except Exception as e:
            e.add_note(f"decode layer {i}")
            raise
    return x


# (config, block names) of each model the layer-stack operator has run;
# the operator's schema takes tensors and scalars, so it gets an index here
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


# ------------------------------------------------------------------- model
class Model:
    """Prefill and greedy-decode entry points of a dense or MoE decoder.
    They take the parameters explicitly and run where the parameters
    are."""

    def __init__(self, cfg: ModelConfig):
        check_config(cfg)
        self.cfg = cfg

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x [B,d] -> float32 logits over the logical vocab."""
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].t() if cfg.tie_embeddings else params["head"]
        return (x @ head).float()[:, :cfg.vocab_size]

    def prefill(self, params: Params, batch: Dict[str, Any],
                cache_len: Optional[int] = None):
        """Run the prompt ``batch["tokens"]`` [B,S], build the decode cache
        (``cache_len`` slots, default S), return (last-token logits
        [B,vocab] float32, cache)."""
        cfg = self.cfg
        embed = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=embed.device)
        x = F.embedding(tokens, embed)
        B, S, _ = x.shape
        L = cfg.num_layers
        Sc = min(cache_len or S, cfg.sliding_window) if cfg.sliding_window \
            else (cache_len or S)
        positions = torch.arange(S, device=x.device)
        rope = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
        shape = (L, B, Sc, cfg.num_kv_heads, cfg.head_dim_)
        k_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
        v_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
        keep = min(S, Sc)     # S > Sc keeps the last Sc positions
        for i in range(L):
            x, (k, v) = attn_mixer_seq(cfg, _layer(params["blocks"], i), x,
                                       rope, want_kv=True)
            k_all[i, :, :keep] = k[:, S - keep:]
            v_all[i, :, :keep] = v[:, S - keep:]
        kv_pos = torch.full((Sc,), -1, dtype=torch.int32, device=x.device)
        kv_pos[:keep] = torch.arange(S - keep, S, dtype=torch.int32,
                                     device=x.device)
        cache = {"pos": torch.full((), S, dtype=torch.int32,
                                   device=x.device),
                 "k": k_all, "v": v_all, "kv_pos": kv_pos}
        return self._logits(params, x[:, -1]), cache

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor, *, traced: bool = False):
        """One token for every sequence of the batch: tokens [B] ->
        (logits [B,vocab] float32, cache).  Updates ``cache`` in place —
        this token's K/V, ``kv_pos`` and ``pos`` — and returns it.  Every
        index comes from ``cache["pos"]`` on its device (the reference's
        ``model.py:1037-1052``): no host read, so a captured step
        replays.

        ``traced=True`` is the form ``make_fx`` traces: the layer stack
        runs as the one functional operator ``repro_torch::decode_layers``,
        and the returned cache is a new dict whose ``k``/``v`` are that
        operator's new tensors (``kv_pos`` and ``pos`` are still updated
        in place), as the reference's step returns a new cache."""
        cfg = self.cfg
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device)
        x = F.embedding(tokens[:, None], embed)
        B = x.shape[0]
        pos, kv_pos = cache["pos"], cache["kv_pos"]
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
        blocks = params["blocks"]
        if traced:
            names = tuple(sorted(blocks))
            x, k, v = torch.ops.repro_torch.decode_layers(
                [blocks[n] for n in names], x, cache["k"], cache["v"], slot,
                *rope, lengths, mask, _stack_key(cfg, names))
            cache = dict(cache, k=k, v=v)
        else:
            x = decode_layers(cfg, blocks, x, cache["k"], cache["v"], slot,
                              rope, lengths, mask)
        pos.add_(1)
        return self._logits(params, x[:, 0]), cache


__all__ = ["Model", "UnsupportedConfigError", "attn_mixer_seq",
           "attn_mixer_step", "check_config", "decode_layers",
           "decode_lengths", "init_cache", "init_params"]
