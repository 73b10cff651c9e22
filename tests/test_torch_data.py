"""The port's synthetic data pipeline (``repro_torch.data``) against the
JAX package's (``repro.data``), on the CPU: the same seed and step give
the same arrays, tokens and the VLM's patches and Whisper's frames alike
(the intent of ``tests/test_training.py::
test_data_pipeline_deterministic``), and ``make_batch_specs`` gives meta
tensors with the shapes and dtypes of the reference's
``ShapeDtypeStruct``s."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.data import make_batch_specs as jax_batch_specs

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_batch_specs

ARCHS = ("llama3.2-3b@smoke", "internvl2-1b@smoke", "whisper-large-v3@smoke")
# (batch, sequence length): the VLM's 8 patch rows take their place in it
SHAPE = (4, 32)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference(arch, seed):
    """Steps 0–3: every array equal to the reference's, with its dtype and
    shape, in both the batch and the iterator."""
    ds = SyntheticLMDataset(get_config(arch), *SHAPE, seed=seed)
    ref = JaxDataset(jax_get_config(arch), *SHAPE, seed=seed)
    it = iter(ds)
    for step in range(4):
        got, want = ds.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want)
        for name, arr in want.items():
            assert got[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(got[name], arr)
        for name, arr in next(it).items():
            np.testing.assert_array_equal(arr, got[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_carry_the_modality_stubs(arch):
    """Seeded, non-zero ``patches`` [B, num_patch_tokens, frontend_dim]
    for the VLM (the text row count less the patch rows) and ``frames``
    [B, encoder_seq, frontend_dim] for Whisper; another seed gives other
    tokens."""
    cfg = get_config(arch)
    b = SyntheticLMDataset(cfg, *SHAPE, seed=5).batch(3)
    P = cfg.num_patch_tokens
    assert b["tokens"].shape == (SHAPE[0], SHAPE[1] - P)
    assert b["tokens"].dtype == np.int32
    assert ((0 <= b["tokens"]) & (b["tokens"] < cfg.vocab_size)).all()
    assert ("patches" in b) == bool(P)
    assert ("frames" in b) == (cfg.arch_type == "audio")
    if P:
        assert b["patches"].shape == (SHAPE[0], P, cfg.frontend_dim)
    if "frames" in b:
        assert b["frames"].shape == (SHAPE[0], cfg.encoder_seq,
                                     cfg.frontend_dim)
    for name in ("patches", "frames"):
        if name in b:
            assert b[name].dtype == np.float32 and b[name].std() > 0.5
    again = SyntheticLMDataset(cfg, *SHAPE, seed=5).batch(3)
    np.testing.assert_array_equal(again["tokens"], b["tokens"])
    other = SyntheticLMDataset(cfg, *SHAPE, seed=6).batch(3)
    assert (other["tokens"] != b["tokens"]).any()


@pytest.mark.parametrize("arch", ARCHS + ("whisper-large-v3",
                                          "internvl2-1b"))
def test_batch_specs_match_the_reference(arch):
    """Meta tensors, nothing allocated, with the reference's names, shapes
    and dtypes (full width included: 1 500 frames of 1 280, 256 patches of
    1 024)."""
    specs = make_batch_specs(get_config(arch), 8, 512)
    want = jax_batch_specs(jax_get_config(arch), 8, 512)
    assert sorted(specs) == sorted(want)
    for name, spec in want.items():
        t = specs[name]
        assert t.device.type == "meta"
        assert tuple(t.shape) == spec.shape
        assert str(t.dtype).split(".")[-1] == spec.dtype.name
    assert specs["tokens"].dtype == torch.int32
