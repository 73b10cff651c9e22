"""The plain version of the decode-attention kernel K8
(``repro_torch.kernels.decode_attention``) and the port's
``models.layers.decode_attention``, against the JAX package's Pallas
``decode_attention`` in interpret mode (as ``tests/test_kernels.py`` runs
it), its pure-jnp ``decode_attention_ref`` and the model's jnp
``decode_attention``.  Inputs come from numpy with a fixed seed.
Tolerances are ``tests/test_kernels.py``'s: 2e-5 in float32, 2e-2 in
bfloat16.  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against this plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_attention_ref
from repro.models.layers import decode_attention as jax_layers_decode

import repro_torch.kernels as kernels
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import layers

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, S, H, K, D, dtype, seed=0):
    """(torch q, k_cache, v_cache), (jax ...) holding the same values."""
    torch_dt, jax_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, D), (B, S, K, D), (B, S, K, D))]
    return ([torch.as_tensor(a).to(torch_dt) for a in arrs],
            [jnp.asarray(a).astype(jax_dt) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,lengths", [
    (2, 64, 4, 4, 32, (33, 64)),       # MHA; a middle length and S
    (3, 64, 8, 2, 32, (1, 64, 17)),    # GQA 4:1; length 1
    (2, 96, 6, 2, 64, (96, 50)),       # GQA 3:1, as Llama-3.2-3B
])
def test_plain_matches_the_pallas_kernel_and_ref(B, S, H, K, D, lengths,
                                                 dtype):
    (q, kc, vc), (jq, jkc, jvc) = _inputs(B, S, H, K, D, dtype)
    tol = DTYPES[dtype][2]
    got = kernels.decode_attention(q, kc, vc,
                                   torch.tensor(lengths, dtype=torch.int32))
    assert got.dtype == q.dtype and tuple(got.shape) == (B, H, D)
    jl = jnp.asarray(lengths, jnp.int32)
    pallas = jax_decode_attention(jq, jkc, jvc, jl, bs=32, interpret=True)
    plain = jax_decode_attention_ref(jq, jkc, jvc, jl)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)


def test_single_valid_row_is_that_rows_value():
    """length 1 attends to row 0 only (tests/test_kernels.py's edge case)."""
    (q, kc, vc), _ = _inputs(1, 40, 2, 2, 16, "float32", seed=4)
    got = ops.decode_attention(q, kc, vc, torch.tensor([1], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), vc[:, 0].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D", [(2, 24, 6, 2, 16), (1, 33, 8, 2, 32)])
def test_layers_decode_attention_matches_the_models(B, S, H, K, D, dtype):
    """The model's CPU decode path against the reference model's, with a
    prefix mask (what the dense model makes) and with an arbitrary mask
    (a sliding window's); the prefix case also equals the kernel's plain
    version at those lengths."""
    (q, kc, vc), (jq, jkc, jvc) = _inputs(B, S, H, K, D, dtype, seed=6)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(8)
    lengths = rng.integers(1, S + 1, B)
    prefix = np.arange(S)[None] < lengths[:, None]
    scattered = rng.random((B, S)) < 0.5
    scattered[:, 0] = True
    for mask in (prefix, scattered):
        got = layers.decode_attention(q[:, None], kc, vc,
                                      length_mask=torch.as_tensor(mask))
        want = jax_layers_decode(jq[:, None], jkc, jvc,
                                 length_mask=jnp.asarray(mask))
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    got = layers.decode_attention(q[:, None], kc, vc,
                                  length_mask=torch.as_tensor(prefix))[:, 0]
    plain = ops.decode_attention(q, kc, vc,
                                 torch.as_tensor(lengths, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)


def test_ref_masks_with_the_kernels_value():
    """The plain version masks with -1e30, as both TPU kernels do."""
    assert ref.NEG_INF == -1e30
    (q, kc, vc), _ = _inputs(2, 16, 4, 2, 8, "float32", seed=9)
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q, kc, vc, lengths),
                       ref.decode_attention_ref(q, kc, vc, lengths))
    assert ops.KERNEL_WRAPPERS == {"decode_attention": ops.decode_attention}
    assert kernels.decode_attention is ops.decode_attention


def test_a_non_cpu_call_launches_or_raises(monkeypatch):
    """Off the CPU the wrapper never runs the plain version: a tensor that
    is not on CUDA is refused, and a launch that cannot build raises."""
    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ref, "decode_attention_ref", no_fallback)
    q = torch.empty((2, 4, 8), device="meta")
    kc = torch.empty((2, 16, 2, 8), device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.decode_attention(q, kc, kc, lengths)
    monkeypatch.setattr(ops, "cuda_operands", lambda *a: 0)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        ops.decode_attention(q, kc, kc, lengths)
    assert "fell back" not in str(err.value)
    assert ops.decode_attention.launches == 0


def test_wrapper_checks_shapes():
    q = torch.zeros((2, 6, 8))
    kc = torch.zeros((2, 16, 4, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.decode_attention(q, kc, kc, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention(q, torch.zeros((2, 16, 2, 8)),
                             torch.zeros((2, 16, 2, 8)),
                             torch.ones(3, dtype=torch.int32))


# ------------------------------------ K8's split over the sequence (flash-
# decoding): the planner and the arithmetic of the split and the merge
H100_SMS = 132
# chip_smoke.py's bounds on K8: float32 within F32_ATTN * max|want|; bf16
# within one bf16 ulp of want plus BF16_ATTN_ABS * max|want| (both compute
# in float32 from the same inputs and round once)
F32_ATTN, BF16_ATTN_ABS = 2e-5, 1e-6


def split_merge_emulation(q, k_cache, v_cache, lengths, split):
    """K8's float32 arithmetic on the card (``csrc/decode_attention.cu``):
    block p of ``split`` takes rows [p·c, min(len, (p + 1)·c)) of the valid
    prefix, c = ceil(len / split), and keeps per query head m (its largest
    score, -1e30 if its share is empty), l = Σ exp(s − m) and acc =
    Σ exp(s − m)·v; the blocks merge in block order, rescaled to the common
    max; out = acc / max(l, 1e-30) in q's dtype."""
    B, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    groups = H // K
    qs = q.float() * D ** -0.5
    out = torch.empty((B, H, D), dtype=torch.float32)
    for b in range(B):
        n = min(int(lengths[b]), S)
        c = -(-n // split)
        for h in range(H):
            k = k_cache[b, :, h // groups].float()
            v = v_cache[b, :, h // groups].float()
            parts = []
            for p in range(split):
                lo, hi = min(n, p * c), min(n, (p + 1) * c)
                if lo >= hi:
                    parts.append((torch.tensor(-1e30), torch.tensor(0.0),
                                  torch.zeros(D)))
                    continue
                s = k[lo:hi] @ qs[b, h]
                m = s.max()
                e = torch.exp(s - m)
                parts.append((m, e.sum(), e @ v[lo:hi]))
            mx = torch.stack([m for m, _, _ in parts]).max()
            den, num = torch.tensor(0.0), torch.zeros(D)
            for m, l, a in parts:
                w = torch.exp(m - mx)
                den, num = den + l * w, num + a * w
            out[b, h] = num / torch.clamp_min(den, 1e-30)
    return out.to(q.dtype)


def _within_k8_bound(got, want):
    g, w = got.float(), want.float()
    wmax = float(w.abs().max())
    if got.dtype == torch.float32:
        bound = F32_ATTN * wmax
    else:
        wa = w.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        bound = torch.ldexp(torch.ones_like(wa), torch.frexp(wa)[1] - 8) \
            + BF16_ATTN_ABS * wmax
    return bool(((g - w).abs() <= bound).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,lengths,split", [
    (1, 64, 8, 8, 32, (1,), 8),          # length 1, the largest split; GQA 1
    (2, 64, 12, 4, 32, (3, 7), 8),       # lengths below the split; GQA 3
    (2, 48, 8, 2, 16, (48, 17), 4),      # length = S; GQA 4
    (3, 40, 6, 2, 24, (40, 1, 9), 3),    # a ragged share; GQA 3
    (2, 33, 4, 1, 8, (33, 32), 1),       # no split
])
def test_k8_split_and_merge_matches_the_plain_version(B, S, H, K, D, lengths,
                                                      split, dtype):
    """Per-block (m, l, acc) over ceil(len / split)-row shares, merged in
    block order, equals ``decode_attention_ref`` within chip_smoke.py's
    bounds on K8; empty shares (lengths below the split) merge with weight
    0."""
    (q, kc, vc), _ = _inputs(B, S, H, K, D, dtype, seed=B * S + split)
    L = torch.tensor(lengths, dtype=torch.int32)
    want = ref.decode_attention_ref(q, kc, vc, L)
    got = split_merge_emulation(q, kc, vc, L, split)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert _within_k8_bound(got, want)


def test_k8_plan_split_reads_shapes_only():
    """The split is planned from (B, K, S, SMs): at most MAX_SPLIT, at
    least 1, no share of a full cache under MIN_SPLIT_ROWS rows, and while
    it is below both caps the blocks reach BLOCKS_PER_SM per SM.  The long
    mix (B 4, 8 kv heads, 2 048 rows) splits 8 ways on an H100; the short
    mix's 96-row cache is not split."""
    assert ops.plan_split(4, 8, 2048, H100_SMS) == 8
    assert ops.plan_split(4, 8, 96, H100_SMS) == 1
    for batch in (1, 2, 4, 16, 64):
        for kv_heads in (1, 2, 8):
            for seq in (1, 17, 96, 128, 255, 256, 1024, 2048, 8192):
                for sms in (1, 8, 132):
                    split = ops.plan_split(batch, kv_heads, seq, sms)
                    assert 1 <= split <= ops.MAX_SPLIT
                    assert split == 1 or seq // split >= ops.MIN_SPLIT_ROWS
                    if split < min(ops.MAX_SPLIT,
                                   seq // ops.MIN_SPLIT_ROWS):
                        assert batch * kv_heads * split >= \
                            ops.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("es,d,pointers,strides,want", [
    (2, 128, (0, 256), (2048 * 8 * 128, 8 * 128, 128) * 2, True),
    (2, 40, (64, 1024), (96 * 4 * 40, 4 * 40, 40) * 2, True),     # 80 B rows
    (2, 128, (2, 256), (2048 * 8 * 128, 8 * 128, 128) * 2, False),  # base
    (2, 36, (0, 0), (36, 36, 36) * 2, False),                   # 72 B rows
    (4, 36, (0, 0), (36 * 4, 36, 36) * 2, True),                # 144 B rows
    (2, 64, (0, 0), (2055 * 64 + 1, 64, 64) * 2, False),        # a stride
])
def test_k8_takes_16_byte_loads_only_where_aligned(es, d, pointers, strides,
                                                   want):
    """The wrapper's choice of the kernel's load path: 16-byte loads only
    where both cache pointers, every stride and a row's bytes are
    multiples of 16; the scalar path otherwise (misaligned arena views)."""
    assert ops.vector_loads(es, d, pointers, strides) is want
