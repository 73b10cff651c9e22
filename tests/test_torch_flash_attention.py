"""The plain version of the flash-attention kernel K7
(``repro_torch.kernels.flash_attention``) and the port's chunked attention
(``repro_torch.models.layers.chunked_attention``), against the JAX
package's Pallas ``flash_attention`` in interpret mode (as
``tests/test_kernels.py`` runs it), its pure-jnp ``attention_ref`` and the
model's jnp ``chunked_attention``.  Inputs come from numpy with a fixed
seed.  Tolerances are ``tests/test_kernels.py``'s: 2e-5 in float32 (the
implementations sum in other orders), 2e-2 in bfloat16 (one rounding of
the output).  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against this plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import chunked_attention as jax_chunked_attention

import repro_torch.kernels as kernels
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, Sq, Skv, H, K, D, dtype, seed=0):
    """(torch q, k, v), (jax q, k, v) holding the same values."""
    torch_dt, jax_dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]
    return ([torch.as_tensor(a).to(torch_dt) for a in arrs],
            [jnp.asarray(a).astype(jax_dt) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal", [
    (1, 64, 64, 4, 4, 32, True),       # MHA square
    (2, 64, 64, 8, 2, 32, True),       # GQA 4:1
    (1, 64, 64, 6, 2, 64, True),       # GQA 3:1, as Llama-3.2-3B
    (1, 32, 128, 2, 2, 32, True),      # Sq < Skv: the last Sq positions
    (1, 64, 64, 4, 2, 32, False),      # non-causal
])
def test_plain_matches_the_pallas_kernel_and_ref(B, Sq, Skv, H, K, D, causal,
                                                 dtype):
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Skv, H, K, D, dtype)
    tol = DTYPES[dtype][2]
    got = kernels.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, D)
    pallas = jax_flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32,
                                 interpret=True)
    plain = jax_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv", [(1, 1), (17, 17), (5, 23), (33, 70)])
def test_plain_at_ragged_lengths(Sq, Skv):
    """Lengths no tile divides (the kernel masks the ragged edge; the TPU
    wrapper asserts divisibility, so the reference here is attention_ref)."""
    (q, k, v), (jq, jk, jv) = _inputs(2, Sq, Skv, 6, 2, 16, "float32", seed=3)
    got = ops.flash_attention(q, k, v, causal=True)
    want = jax_attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,D,chunk,window", [
    (2, 64, 4, 2, 32, 16, 0),          # GQA 2:1, whole chunks
    (1, 40, 6, 2, 32, 16, 0),          # GQA 3:1, ragged last chunk
    (1, 48, 8, 2, 16, 16, 12),         # GQA 4:1, sliding window
])
def test_chunked_attention_matches_the_models(B, S, H, K, D, chunk, window,
                                              dtype):
    """The model's CPU path against the reference model's jnp path, at the
    model's positions (0..S-1, causal)."""
    (q, k, v), (jq, jk, jv) = _inputs(B, S, S, H, K, D, dtype, seed=5)
    tol = DTYPES[dtype][2]
    pos = np.arange(S)
    got = layers.chunked_attention(q, k, v, causal=True, chunk=chunk,
                                   q_positions=torch.as_tensor(pos),
                                   kv_positions=torch.as_tensor(pos),
                                   sliding_window=window)
    want = jax_chunked_attention(jq, jk, jv, causal=True, chunk=chunk,
                                 q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(pos),
                                 sliding_window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    if not window:
        np.testing.assert_allclose(
            _np(got), _np(ops.flash_attention(q, k, v, causal=True)),
            rtol=tol, atol=tol)


def test_chunked_attention_non_causal():
    """Whole chunks: equal to the reference's chunked path.  A ragged last
    chunk: equal to attention_ref — the reference's chunked path gives the
    zero pad keys weight there (ROADMAP Queue 3, R6), the port masks them."""
    (q, k, v), (jq, jk, jv) = _inputs(1, 32, 32, 4, 2, 16, "float32", seed=7)
    got = layers.chunked_attention(q, k, v, causal=False, chunk=16)
    want = jax_chunked_attention(jq, jk, jv, causal=False, chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    (q, k, v), (jq, jk, jv) = _inputs(1, 20, 20, 4, 2, 16, "float32", seed=7)
    got = layers.chunked_attention(q, k, v, causal=False, chunk=16)
    np.testing.assert_allclose(_np(got),
                               _np(jax_attention_ref(jq, jk, jv,
                                                     causal=False)),
                               rtol=2e-5, atol=2e-5)


def test_ref_is_the_wrappers_plain_version():
    (q, k, v), _ = _inputs(1, 8, 8, 2, 1, 8, "float32", seed=9)
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.attention_ref(q, k, v))
    assert ops.KERNEL_WRAPPERS == {"flash_attention": ops.flash_attention}
    assert kernels.flash_attention is ops.flash_attention


def test_a_non_cpu_call_launches_or_raises(monkeypatch):
    """Off the CPU the wrapper never runs the plain version: a tensor that
    is not on CUDA is refused, and a launch that cannot build raises."""
    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ref, "attention_ref", no_fallback)
    q = torch.empty((1, 4, 2, 8), device="meta")
    k = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, k)
    monkeypatch.setattr(ops, "cuda_operands", lambda *a: 0)
    with pytest.raises((RuntimeError, AssertionError)) as err:
        ops.flash_attention(q, k, k)
    assert "fell back" not in str(err.value)
    assert ops.flash_attention.launches == 0


def test_wrapper_checks_shapes():
    x = torch.zeros((1, 4, 6, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(x, torch.zeros((1, 4, 4, 8)),
                            torch.zeros((1, 4, 4, 8)))
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(x, torch.zeros((1, 4, 2, 8)),
                            torch.zeros((1, 5, 2, 8)))


# -------------------------------------- K7's tensor-core arithmetic (bf16)
LOG2E = 1.4426950408889634
BKV = 64            # the kernel's key tile (csrc/flash_attention.cu)


def tensor_core_emulation(q, k, v, *, causal, terms=3):
    """What K7's bf16 body computes, in plain float32 torch: S = q·k from
    the bf16 values (each product exact in float32), times scale·log2(e)
    afterwards; the online softmax in log2 units (p = exp2(x − m)) over
    tiles of BKV keys with -1e30 on causally masked keys; each tile's P·V summed from zero, with P written
    as ``terms`` bf16 parts (hi = bf16(P), mid = bf16(P - hi), lo =
    bf16(P - hi - mid); ``terms=1`` is FlashAttention-2's single bf16 P),
    then added to the rescaled accumulator; l summed from the float32 P;
    out = acc / max(l, 1e-30) rounded once to bf16."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    scale = D ** -0.5
    qf = q.float().reshape(B, Sq, K, H // K, D)
    kf, vf = k.float(), v.float()
    off = Skv - Sq
    m = torch.full((B, K, H // K, Sq), -1e30)
    l = torch.zeros((B, K, H // K, Sq))
    acc = torch.zeros((B, K, H // K, Sq, D))
    rows = torch.arange(Sq)[:, None] + off
    kv_end = min(Skv, off + Sq) if causal else Skv
    with ref.full_f32_matmul():
        for kv0 in range(0, kv_end, BKV):
            kt, vt = kf[:, kv0:kv0 + BKV], vf[:, kv0:kv0 + BKV]
            s = torch.einsum("bikgd,bjkd->bkgij", qf, kt) * (scale * LOG2E)
            if causal:
                cols = torch.arange(kv0, kv0 + kt.shape[1])[None]
                s = s.masked_fill(cols > rows, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv, rest = 0.0, p
            for _ in range(terms):
                part = rest.bfloat16().float()
                pv = pv + torch.einsum("bkgij,bjkd->bkgid", part, vt)
                rest = rest - part
            acc = acc * alpha[..., None] + pv
            m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).bfloat16()


def bf16_bound_breaks(got, want):
    """Elements outside chip_smoke.py's bf16 bound: one bf16 ulp of want
    plus 1e-6 · max|want|."""
    w = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    bound = ulp + 1e-6 * float(want.float().abs().max())
    return int(((got.float() - want.float()).abs() > bound).sum())


def _bf16_inputs(B, Sq, Skv, H, K, D, packed, seed):
    rng = np.random.default_rng(seed)
    if packed:      # q/k/v as slices of one projection, as the model does
        qkv = torch.as_tensor(rng.standard_normal(
            (B, Sq, H + 2 * K, D)).astype(np.float32)).bfloat16()
        return qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in ((B, Sq, H, D), (B, Skv, K, D),
                                  (B, Skv, K, D))]


# chip_smoke.py's hostile K7 shapes (B, Sq, Skv, H, K, D, causal, packed),
# the new tilings' edges among them (D 40, S 200, Sq 70 / Skv 333), and
# S 1 024 / D 128 / GQA 3
K7_EMULATION_SHAPES = [
    (1, 1, 1, 2, 2, 64, True, False), (2, 17, 17, 6, 2, 128, True, False),
    (1, 1000, 1000, 4, 1, 64, True, False),
    (2, 64, 256, 8, 2, 128, True, False),
    (1, 100, 300, 3, 3, 128, False, False),
    (2, 5, 37, 12, 4, 96, True, False),
    (1, 1000, 1000, 6, 2, 128, False, True),
    (2, 129, 129, 24, 8, 128, True, True),
    (2, 77, 77, 4, 2, 40, True, False), (1, 200, 200, 6, 2, 128, True, False),
    (1, 70, 333, 6, 3, 128, True, False),
    (1, 1024, 1024, 6, 2, 128, True, False),
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,packed", K7_EMULATION_SHAPES)
def test_k7_tensor_core_arithmetic_keeps_the_bf16_bound(B, Sq, Skv, H, K, D,
                                                        causal, packed):
    q, k, v = _bf16_inputs(B, Sq, Skv, H, K, D, packed, seed=Sq + D + H)
    got = tensor_core_emulation(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert bf16_bound_breaks(got, want) == 0


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,causal,packed,seed", [
    (1, 1024, 1024, 4, 4, 128, True, False, 14),
    (1, 1000, 1000, 6, 2, 128, False, True, 1134),
])
def test_fewer_parts_of_p_leave_the_bound(B, Sq, Skv, H, K, D, causal, packed,
                                          seed):
    """Why K7 splits P into three bf16 parts: P rounded once to bf16
    (FlashAttention-2) puts over 1 % of the outputs outside the bound;
    two parts leave P ~2^-18 off, which near-zero outputs of a long
    non-causal row can feel; three parts keep every output inside.
    PERF.md records the printed counts."""
    q, k, v = _bf16_inputs(B, Sq, Skv, H, K, D, packed, seed=seed)
    want = ref.attention_ref(q, k, v, causal=causal)
    breaks = [bf16_bound_breaks(tensor_core_emulation(
        q, k, v, causal=causal, terms=n), want) for n in (1, 2, 3)]
    print(f"outside the bf16 bound of {want.numel()} outputs with 1 / 2 / 3 "
          f"bf16 parts of P: {breaks}")
    assert breaks[0] > want.numel() // 100 and breaks[2] == 0
