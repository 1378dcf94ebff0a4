"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries are
keyed by a hash of the source, of every ``csrc/*.cuh`` header it includes
and of the flags, and live under
``build/repro_torch/`` at the root of the checkout, so a changed source is
rebuilt and an unchanged one is reused.  Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gather_dist", "greedy_assign", "l2dist", "topk", "twotower_score")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the repro_torch CUDA kernels "
            "are built from source at first use"
        )
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_bytes(path: Path, _seen=None) -> bytes:
    """The bytes of a source and of every header it includes with
    ``#include "..."`` from its own directory, recursively, in order."""
    seen = set() if _seen is None else _seen
    if path in seen:
        return b""
    seen.add(path)
    text = path.read_bytes()
    return text + b"".join(source_bytes(path.parent / m.decode(), seen)
                           for m in _INCLUDE.findall(text))


def _target(name: str) -> Path:
    src = source_bytes(CSRC / f"{name}.cu")
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in ``names``, all ``nvcc`` processes
    started together.  Returns the wall seconds per library built (0.0 for
    one already built).  Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out, time.perf_counter())
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str, functions: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``functions`` maps each
    exported C function to its ``argtypes``."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = bind(_target(name), functions)
    return lib


def bind(path, functions: Dict[str, list]) -> ctypes.CDLL:
    """Load a built library and declare each of ``functions``' ``argtypes``.
    Every function returns the ``cudaError_t`` of its launch as an int."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in functions.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ``void*`` argument (None → NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
