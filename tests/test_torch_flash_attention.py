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
