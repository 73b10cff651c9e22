"""``repro_torch.analysis.roofline`` against ``repro.analysis.roofline``:
the intents of ``tests/test_roofline.py`` (collective census, dominant
term, MFU bound, MoE active parameters), each port function equal to the
reference's on the same inputs, and the H100's spec."""
import pytest

from repro.analysis import roofline as jax_roofline
from repro.configs import get_config as jax_get_config

from repro_torch.analysis import roofline
from repro_torch.analysis.roofline import (H100, TPU_V5E,
                                           collective_bytes_from_hlo,
                                           model_flops, roofline_report)
from repro_torch.configs import get_config

HLO = """
HloModule test
%x1 = f32[1024,256]{1,0} all-gather(%a), channel_id=1, replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}
%x2 = bf16[512]{0} all-reduce(%b), replica_groups=[4,4]<=[16]
%x3 = (f32[128]{0}, f32[2048]{0}) all-gather-start(%c), replica_groups=[1,16]<=[16]
%x4 = f32[2048]{0} all-gather-done(%x3)
%x5 = f32[256,64]{1,0} reduce-scatter(%d), replica_groups={{0,1,2,3}}, dimensions={0}
%x6 = f32[64,64]{1,0} all-to-all(%e), replica_groups=[2,8]<=[16]
%x7 = bf16[32]{0} collective-permute(%f), source_target_pairs={{0,1}}
"""


def test_collective_census():
    out = collective_bytes_from_hlo(HLO)
    assert out["all-gather"] == (1024 * 256 * 4) * 15 // 16 \
        + (2048 * 4) * 15 // 16
    assert out["all-reduce"] == 2 * 512 * 2 * 3 // 4
    assert out["reduce-scatter"] == 256 * 64 * 4 * 3
    assert out["all-to-all"] == 64 * 64 * 4 * 7 // 8
    assert out["collective-permute"] == 32 * 2
    assert out["total"] == sum(out[k] for k in roofline.COLLECTIVES)
    assert out == jax_roofline.collective_bytes_from_hlo(HLO)


def test_collective_census_ignores_non_collectives():
    txt = "%y = f32[8]{0} add(f32[8] %a, f32[8] %b)\n"
    assert collective_bytes_from_hlo(txt)["total"] == 0
    assert collective_bytes_from_hlo(txt) == \
        jax_roofline.collective_bytes_from_hlo(txt)


@pytest.mark.parametrize("hw", ["TPU_V5E", "H100"])
def test_roofline_dominant_term(hw):
    spec = getattr(roofline, hw)
    kw = dict(flops=spec.peak_flops, bytes_accessed=spec.hbm_bw * 2,
              collective_bytes=spec.link_bw * 0.5)
    r = roofline_report(**kw, hw=spec)
    # compute: 1 s, memory: 2 s, collective: 0.5 s
    assert r["dominant"] == "memory_s"
    assert r["step_time_lb_s"] == pytest.approx(2.0)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["collective_s"] == pytest.approx(0.5)
    if hw == "TPU_V5E":
        assert r == jax_roofline.roofline_report(**kw)


def test_roofline_mfu_bound():
    kw = dict(flops=1e12, bytes_accessed=0.0, collective_bytes=0.0,
              model_flops_global=256e12, chips=256)
    r = roofline_report(**kw)
    assert r["useful_flop_fraction"] == pytest.approx(1.0)
    assert r["mfu_bound"] == pytest.approx(1.0)
    assert r == jax_roofline.roofline_report(**kw)
    assert roofline_report(**kw, hw=H100)["mfu_bound"] == pytest.approx(1.0)


def test_model_flops_moe_uses_active_params():
    moe = get_config("phi3.5-moe-42b-a6.6b")
    dense_equiv = model_flops(moe, "train", 1000)
    assert dense_equiv == 6.0 * moe.active_param_count() * 1000
    assert moe.active_param_count() < 0.25 * moe.param_count()
    for arch in ("phi3.5-moe-42b-a6.6b", "llama3.2-3b", "zamba2-2.7b"):
        for kind in ("train", "prefill", "decode"):
            assert model_flops(get_config(arch), kind, 4096) == \
                jax_roofline.model_flops(jax_get_config(arch), kind, 4096)


def test_the_h100_spec():
    """NVIDIA's H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s
    HBM3, 80 GB, NVLink 450 GB/s a direction; the TPU's spec is the
    reference's."""
    assert H100 == roofline.HardwareSpec(
        "h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
        hbm_bytes=80e9)
    assert TPU_V5E == roofline.HardwareSpec(*jax_roofline.TPU_V5E.__dict__
                                            .values())
    assert (H100.peak_flops / H100.hbm_bw) == pytest.approx(295.2, abs=0.1)
