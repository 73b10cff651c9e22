#!/usr/bin/env python3
"""Time the client edge's host quantize (``kernels/host_quant``, behind
``QParams.quantize``) on this host, beside the numpy expression it
replaced (``tests/quantize_oracle.py``, which the tests hold the kernel
bit-identical to; run ``pytest tests/test_torch_host_quantize.py`` for
that check).

    python3 tools/host_quant_times.py [--repeats 7]

It times both through ``QParams.quantize``'s call (the wrapper's
conversion and allocation included) at MobileNet-1.0@192's 110 592 and
MobileNetV2-1.0@224's 150 528 floats an image: one image over and over (in
cache), and a 256-image pool in a seeded order (read from memory, as the
benchmark's client reads it).  Each line gives the median and the range
over ``--repeats`` sweeps, in microseconds an image.  It needs no card.
"""
import argparse
import platform
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from quantize_oracle import numpy_quantize  # noqa: E402
from repro_torch.graphs.quantize import QParams  # noqa: E402

SIZES = {"mobilenet_v1_192": (192, 192, 3), "mobilenet_v2_224": (224, 224, 3)}
POOL = 256
SCALE, ZERO_POINT = 2 / 255, -1     # uniform [-1, 1) images, calibrated


def cpu_info() -> str:
    """The host's CPU model and the vector extensions the kernel's clones
    pick among."""
    name, flags = platform.processor() or platform.machine(), set()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
            elif line.startswith("flags"):
                flags = set(line.split(":", 1)[1].split())
                break
    except OSError:
        pass
    return "; ".join([name, " ".join(
        f for f in ("sse4_1", "avx2", "avx512f", "avx512bw", "avx512vl")
        if f in flags) or "unknown"])


def sweep(fn, images, order) -> float:
    """Microseconds an image over one pass of ``order``."""
    t0 = time.perf_counter()
    for i in order:
        fn(images[i])
    return 1e6 * (time.perf_counter() - t0) / len(order)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)

    print(f"host: {cpu_info()}; numpy {np.__version__}; "
          f"python {platform.python_version()}")
    kernel = QParams(SCALE, ZERO_POINT).quantize
    t0 = time.perf_counter()
    kernel(np.zeros(8, np.float32))
    print(f"first call (build and load): {time.perf_counter() - t0:.3f} s")

    def plain(x):
        return numpy_quantize(x, SCALE, ZERO_POINT)

    rng = np.random.default_rng(7)
    for name, shape in SIZES.items():
        pool = rng.uniform(-1, 1, (POOL, *shape)).astype(np.float32)
        n = int(np.prod(shape))
        cases = {"in cache": [0] * 64,
                 "pool": list(rng.permutation(POOL))}
        for case, order in cases.items():
            times = {"kernel": [], "numpy": []}
            for _ in range(args.repeats):
                for label, fn in (("kernel", kernel), ("numpy", plain)):
                    times[label].append(sweep(fn, pool, order))
            med = {k: statistics.median(v) for k, v in times.items()}
            print(f"{name} ({n} floats), {case}: kernel "
                  f"{med['kernel']:.1f} us ({min(times['kernel']):.1f}-"
                  f"{max(times['kernel']):.1f}), numpy {med['numpy']:.1f} "
                  f"us ({min(times['numpy']):.1f}-{max(times['numpy']):.1f})"
                  f", numpy / kernel {med['numpy'] / med['kernel']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
