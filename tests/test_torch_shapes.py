"""``repro_torch.launch.shapes`` against ``repro.launch.shapes``: the same
shapes, the same per-(arch, shape) policy for every registered
architecture (the intents of ``tests/test_dryrun.py``'s shape tests), and
the batch and token stand-ins on the meta device with the reference's
shapes and dtypes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import shapes


def test_all_shapes_defined():
    assert set(shapes.SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"}
    assert shapes.SHAPES["train_4k"].global_batch == 256
    assert shapes.SHAPES["long_500k"].seq_len == 524_288
    assert shapes.SLIDING_WINDOW == jax_shapes.SLIDING_WINDOW == 8192
    for name, spec in shapes.SHAPES.items():
        want = jax_shapes.SHAPES[name]
        assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
            (want.name, want.seq_len, want.global_batch, want.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_policy(arch):
    """Whisper skips long_500k; everything else runs everything, as the
    reference decides."""
    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in shapes.SHAPES:
        got = shapes.shape_applicable(cfg, shape)
        assert got == jax_shapes.shape_applicable(jcfg, shape)
        assert got == (not (arch == "whisper-large-v3"
                            and shape == "long_500k"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long500k_gets_sliding_window_for_attention_archs(arch):
    """Dense, MoE and VLM configs get the 8 192 window at long_500k, the
    recurrent ones none (native sub-quadratic); no other shape changes a
    config."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in shapes.SHAPES:
        got = shapes.config_for_shape(cfg, shape)
        want = jax_shapes.config_for_shape(jcfg, shape)
        assert got.sliding_window == want.sliding_window, (arch, shape)
        if shape != "long_500k":
            assert got == cfg
    window = shapes.config_for_shape(cfg, "long_500k").sliding_window
    if cfg.arch_type in ("dense", "moe", "vlm"):
        assert window == 8192
    else:
        assert window == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_token_specs_are_the_references_on_meta(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        got = shapes.batch_specs(cfg, shapes.SHAPES[name])
        want = jax_shapes.batch_specs(jcfg, jax_shapes.SHAPES[name])
        assert set(got) == set(want)
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[key].shape
            assert np.dtype(str(t.dtype).split(".")[-1]) == \
                np.dtype(want[key].dtype)
    for name in ("decode_32k", "long_500k"):
        tok = shapes.decode_token_specs(shapes.SHAPES[name])
        want = jax_shapes.decode_token_specs(jax_shapes.SHAPES[name])
        assert tok.device.type == "meta" and tok.dtype == torch.int32
        assert tuple(tok.shape) == want.shape and want.dtype == jnp.int32
