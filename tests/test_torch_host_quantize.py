"""The client edge's input quantize (``QParams.quantize``, one pass of the
host kernel ``kernels/host_quant``) bit-identical to numpy's five-pass
expression and to the reference's ``QParams.quantize``: ties half to even,
both rails and the infinities, signed zero and subnormals, scales from
1e-8 to 1e3 at the zero points -128, 0 and 127, every vector tail length
and an unaligned start, strided, float64 and (H, W, C) inputs; and the
host build's flags, its missing-compiler error, its absence from
``build_all()`` and concurrent builds of one library.  NaN is outside the
contract, as in numpy."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.graphs.quantize import QParams as RefQParams

from repro_torch.graphs.quantize import QParams
from repro_torch.kernels import build
from repro_torch.kernels.host_quant import quantize_int8
from repro_torch.kernels.host_quant.build import HOST_QUANT

from quantize_oracle import numpy_quantize as oracle

SCALES = [1e-8, 3.7e-6, 0.0157, 0.5, 1.0, 7.3, 1e3]
ZERO_POINTS = [-128, 0, 127]
LENGTHS = [0, 1, 7, 15, 16, 17, 63, 64, 65, 110_592, 150_528]
TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


def check(x, scale, zero_point):
    got = QParams(scale, zero_point).quantize(x)
    with np.errstate(over="ignore", under="ignore"):
        want = oracle(x, scale, zero_point)
        ref = RefQParams(scale, zero_point).quantize(x)
    assert got.dtype == np.int8 and got.shape == np.shape(x)
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(got, want)
    return got


def _ties(scale):
    """Inputs whose float32 quotient by ``scale`` is exactly k + 0.5, for
    k + 0.5 in ±{0.5, 1.5, 2.5, 126.5, 127.5, 128.5}, and their float32
    neighbours on both sides."""
    s = np.float32(scale)
    halves = np.array([0.5, 1.5, 2.5, 126.5, 127.5, 128.5])
    halves = np.concatenate([halves, -halves])
    x = (halves * np.float64(s)).astype(np.float32)
    x = x[x / s == halves.astype(np.float32)]
    return x, np.concatenate([x, np.nextafter(x, np.float32(np.inf)),
                              np.nextafter(x, np.float32(-np.inf))])


@pytest.mark.parametrize("zero_point", ZERO_POINTS)
@pytest.mark.parametrize("scale", SCALES)
def test_ties_round_half_to_even(scale, zero_point):
    exact, x = _ties(scale)
    assert exact.size >= 8, "too few exact ties at this scale"
    q = check(x, scale, zero_point)[:exact.size]
    want = np.rint(exact / np.float32(scale)) + zero_point
    np.testing.assert_array_equal(q, np.clip(want, -128, 127))


@pytest.mark.parametrize("zero_point", ZERO_POINTS)
@pytest.mark.parametrize("scale", SCALES)
def test_both_rails_and_infinities(scale, zero_point):
    s = np.float32(scale)
    units = np.array([126.49, 127.0, 127.5, 128.0, 255.5, 256.0, 1e6, 3e30])
    x = np.concatenate([units * s, -units * s, [3.4e38, -3.4e38]])
    x = np.concatenate([x.astype(np.float32), [np.inf, -np.inf]])
    q = check(x, scale, zero_point)
    assert q[-2] == 127 and q[-1] == -128
    assert q.max() == 127 and q.min() == -128


@pytest.mark.parametrize("zero_point", ZERO_POINTS)
@pytest.mark.parametrize("scale", SCALES)
def test_signed_zero_and_subnormals(scale, zero_point):
    tiny = np.finfo(np.float32).smallest_subnormal
    normal = np.finfo(np.float32).smallest_normal
    x = np.array([0.0, -0.0, tiny, -tiny, 1e-40, -1e-40,
                  np.nextafter(normal, 0), -np.nextafter(normal, 0),
                  normal, -normal], np.float32)
    check(x, scale, zero_point)


@pytest.mark.parametrize("zero_point", ZERO_POINTS)
@pytest.mark.parametrize("scale", SCALES)
def test_scales_and_zero_points(scale, zero_point):
    rng = np.random.default_rng([SCALES.index(scale), zero_point + 128])
    s = np.float32(scale)
    x = np.concatenate([rng.standard_normal(3000) * 60 * s,
                        rng.uniform(-300, 300, 3000) * s,
                        np.round(rng.uniform(-300, 300, 1000)) * s])
    check(x.astype(np.float32), scale, zero_point)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_lengths_and_unaligned_starts(n, offset):
    """Every tail a vector loop can leave, from an aligned start and from
    one float past it."""
    rng = np.random.default_rng(n)
    buf = rng.uniform(-1.2, 1.2, n + 1).astype(np.float32)
    x = buf[offset:offset + n]
    if n:
        assert (x.ctypes.data % 16 == 0) == (offset == 0)
    check(x, 2 / 255, -3)


@pytest.mark.parametrize("layout", [
    "hwc", "strided", "transposed", "float64", "float64_strided",
    "list", "scalar"])
def test_layouts_and_conversions(layout):
    """Inputs that are not contiguous float32 are converted first, as
    ``np.asarray(x, np.float32)`` converts them; the output has the input's
    shape and is a new array."""
    rng = np.random.default_rng(7)
    hwc = rng.uniform(-1, 1, (192, 192, 3))
    x = {"hwc": hwc.astype(np.float32),
         "strided": hwc.astype(np.float32)[::2, 1::3],
         "transposed": hwc.astype(np.float32).transpose(2, 0, 1),
         "float64": hwc + 1e-9,
         "float64_strided": (hwc + 1e-9)[:, ::-2],
         "list": hwc[0, :5, 0].tolist(),
         "scalar": np.float32(0.3)}[layout]
    q = check(x, 1 / 127, 2)
    assert not np.shares_memory(q, np.asarray(x))


def test_counts_calls_and_elements():
    calls, elements = quantize_int8.calls, quantize_int8.elements
    QParams(0.1, 0).quantize(np.zeros((4, 5, 3), np.float32))
    quantize_int8(np.zeros(0, np.float32), 0.1, 0)
    assert quantize_int8.calls - calls == 2
    assert quantize_int8.elements - elements == 60


def test_host_flags_keep_the_arithmetic():
    """No flag lets the compiler turn the division into a reciprocal
    multiply or contract and reorder float operations."""
    flags = " ".join(build.HOST_FLAGS)
    for banned in ("fast-math", "reciprocal", "-Ofast", "unsafe-math",
                   "-march", "associative"):
        assert banned not in flags
    assert "-ffp-contract=off" in build.HOST_FLAGS
    lib = build.library_path(HOST_QUANT.csrc, "quantize_int8")
    assert lib.name.startswith("libquantize_int8-") and lib.suffix == ".so"


def test_no_compiler_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError,
                       match=r"no C\+\+ compiler \(g\+\+\)"):
        build.cxx()


def test_build_all_builds_the_card_kernels_only(monkeypatch):
    """``build_all()`` builds the ``.cu`` kernels, whose names
    ``chip_smoke.py`` checks; the host kernel builds at its first call."""
    monkeypatch.setattr(build, "build",
                        lambda targets: {n: (c / f"{n}.cu").exists()
                                         for c, n in targets})
    built = build.build_all()
    assert "quantize_int8" not in built
    assert built and all(built.values())


_BUILD_ONCE = """
import sys
from pathlib import Path
import numpy as np
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
from repro_torch.kernels.host_quant import quantize_int8
from quantize_oracle import numpy_quantize
x = np.linspace(-2, 2, 1001, dtype=np.float32)
q = quantize_int8(x, 0.0157, 3)
sys.exit(0 if (q == numpy_quantize(x, 0.0157, 3)).all() else 1)
"""


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Four processes that find no library build it at once: each writes
    its own temporary file and renames it into place, so each loads a
    whole one and quantizes right."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC),
                                                      str(TESTS)]))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONCE,
                               str(tmp_path)], env=env)
             for _ in range(4)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0, 0, 0, 0]
    libs = list(tmp_path.iterdir())
    assert [p.name for p in libs] == [
        build.library_path(HOST_QUANT.csrc, "quantize_int8").name]
