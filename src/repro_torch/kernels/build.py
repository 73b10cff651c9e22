"""Build and load the port's Hopper kernels (``<package>/csrc/*.cu``) at
first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The libraries go under
``src/repro_torch/kernels/_build/`` (git-ignored), named by a hash of
their source, the headers beside it and the flags: a stale library is
never loaded, and an unchanged one is not rebuilt.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them;
``build_all()`` does that for every kernel of every package.  Nothing here
runs at import.  ``-Xptxas -v`` is on: ``PTXAS`` keeps, per library built
by this process, each kernel's registers, stack and spill bytes.

A kernel package declares its kernels as a ``KernelSet``: its ``csrc``
directory and the C signature of each ``<name>_launch`` function.  Every
launch goes through ``KernelSet.launch``, which refuses to launch while
``make_fx`` traces (``errors.TraceError``): a ctypes launch fills its
output through ``data_ptr``, so a trace would record an unwritten
``torch.empty``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> "<kernel>: N registers, S B stack, T/L B spill stores/
# loads" for each kernel ptxas compiled in this process
PTXAS: Dict[str, List[str]] = {}

_lock = threading.Lock()
_libs: List[ctypes.CDLL] = []      # loaded libraries, kept for the process


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "src/repro_torch/kernels/*/csrc at first use and "
                       "need the CUDA toolkit")


def library_path(csrc: Path, name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.iterdir()):
        if src.suffix in (".cu", ".cuh") and (
                src.suffix == ".cuh" or src.stem == name):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _demangle(names: List[str]) -> List[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, timeout=30).stdout
        plain = out.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = []
    if len(plain) != len(names):
        return names
    plain = [p.replace("(anonymous namespace)::", "") for p in plain]
    return [p.split("(")[0].removeprefix("void ") for p in plain]


def ptxas_summary(log: str) -> List[str]:
    """Registers, stack and spill bytes per kernel from ``ptxas -v``."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = (f"{m.group(1)} B stack, {m.group(2)}/{m.group(3)} B "
                     f"spill stores/loads")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m.group(1)} registers, {frame}"))
            name, frame = None, ""
    names = _demangle([n for n, _ in rows])
    return [f"{n}: {info}" for n, (_, info) in zip(names, rows)]


def build(targets: Sequence[Tuple[Path, str]]) -> Dict[str, float]:
    """Compile every library of ``targets`` (``(csrc, name)`` pairs) that
    is missing, one ``nvcc`` per source, all started together.  Returns
    the seconds each build took (0.0 for a library already built); raises
    on any failure."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for csrc, name in targets:
            target = library_path(csrc, name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(csrc / f"{name}.cu")]
            procs[name] = (time.perf_counter(), tmp, target,
                           subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
        seconds = {name: 0.0 for _, name in targets}
        errors = []
        for name, (t0, tmp, target, proc) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
                PTXAS[name] = ptxas_summary(log)
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


@functools.lru_cache(maxsize=None)
def _proxy_mode_getter():
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    return get_proxy_mode


class KernelSet:
    """The kernels of one package: sources in ``csrc``, and the C argument
    types of each ``<name>_launch`` (pointers and the stream as void*)."""

    def __init__(self, csrc: Path, argtypes: Dict[str, List]) -> None:
        self.csrc = csrc
        self.argtypes = argtypes
        self.names = tuple(argtypes)
        # name -> loaded launch function; looked up before anything else,
        # so a launch never re-hashes the sources
        self._fns: Dict[str, Any] = {}

    def load(self, name: str):
        """The launch function of kernel ``name``, its library built first
        if missing."""
        fn = self._fns.get(name)
        if fn is not None:
            return fn
        build([(self.csrc, name)])
        with _lock:
            if name not in self._fns:
                lib = ctypes.CDLL(str(library_path(self.csrc, name)))
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = self.argtypes[name]
                fn.restype = ctypes.c_int
                _libs.append(lib)
                self._fns[name] = fn
            return self._fns[name]

    def launch(self, name: str, *args) -> None:
        """Call ``<name>_launch(*args)``; raise on a nonzero CUDA error, and
        ``TraceError`` instead of launching while ``make_fx`` traces (a
        trace cannot see what the kernel writes)."""
        if _proxy_mode_getter()() is not None:
            from repro_torch.errors import TraceError
            raise TraceError(
                f"kernel {name} reached while make_fx traces the program: "
                f"its launch writes through data_ptr, which the trace "
                f"cannot record")
        rc = (self._fns.get(name) or self.load(name))(*args)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def build_all() -> Dict[str, float]:
    """Build every kernel of the port at once (one ``nvcc`` per source)."""
    from repro_torch.kernels.conv_pointwise.build import CONV_POINTWISE
    from repro_torch.kernels.conv_quant.build import CONV_QUANT
    from repro_torch.kernels.decode_attention.build import DECODE_ATTENTION
    from repro_torch.kernels.flash_attention.build import FLASH_ATTENTION
    return build([(ks.csrc, n) for ks in (CONV_QUANT, CONV_POINTWISE,
                                          FLASH_ATTENTION, DECODE_ATTENTION)
                  for n in ks.names])


__all__ = ["BUILD_DIR", "KernelSet", "PTXAS", "build", "build_all",
           "library_path", "nvcc", "ptxas_summary"]
