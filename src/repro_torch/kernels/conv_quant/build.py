"""Build and load the int8 conv kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The libraries go under
``src/repro_torch/kernels/_build/`` (git-ignored), named by a hash of
their sources and flags: a stale library is never loaded, and an
unchanged one is not rebuilt.  ``build()`` starts one ``nvcc`` per missing
library, all at once, and waits for them.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("qconv1x1", "qdwconv", "qconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signatures of the launch functions (pointers and the stream as void*)
_ARGTYPES = {
    "qconv1x1": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _F, _I, _I, _I, _P],
    "qdwconv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _L,
                _F, _I, _I, _I, _P],
    "qconv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L,
              _L, _F, _I, _I, _I, _P],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the int8 conv kernels are built "
                       "from src/repro_torch/kernels/conv_quant/csrc at "
                       "first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (
                src.suffix == ".cuh" or src.stem == name):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    per source, all started together.  Returns the seconds each build
    took (0.0 for a library already built); raises on any failure."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (time.perf_counter(), tmp, target,
                           subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
        seconds = {name: 0.0 for name in names}
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
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


__all__ = ["BUILD_DIR", "KERNELS", "build", "library_path", "load", "nvcc"]
