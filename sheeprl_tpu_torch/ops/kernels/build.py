"""Build and load the port's hand-written CUDA kernels.

Each source under `sheeprl_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, at first
use, into `build/kernels/` at the root of the checkout, and loaded with
`ctypes`. The library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module.

`build_all()` starts one `nvcc` per source, all at once, and waits for them.
The launch helpers at the end are shared by the kernel wrappers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "DTYPE_CODES", "SOURCES", "bind", "build_all", "build_log",
    "load_library", "reduction_splits",
]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# every kernel library of the port, by source stem
SOURCES = ("ln_gru", "conv_ln_silu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found (looked in {cuda_home}/bin and on PATH): the CUDA "
        "kernels are built from source at first use"
    )


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all(names=SOURCES) -> None:
    """Compile every listed source that has no current library, one `nvcc`
    per source, all started together."""
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output for the last build of `name` (registers, shared
    memory and spills per kernel, from `-Xptxas -v`)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


# ---------------------------------------------------------------------------
# launch helpers
# ---------------------------------------------------------------------------

# the dtype argument of every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# split a reduction axis until a grid holds two blocks per H100 SM
_TARGET_BLOCKS = 2 * 132
_bound: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `fn` of kernel library `name` (built first if needed),
    with its argument types declared and an int (cudaError_t) result."""
    key = (name, fn)
    if key not in _bound:
        func = getattr(load_library(name), fn)
        func.argtypes = argtypes
        func.restype = ctypes.c_int
        _bound[key] = func
    return _bound[key]


def reduction_splits(blocks: int, k: int, depth: int) -> int:
    """How many slices to cut a reduction of length `k` into (in steps of
    `depth`) so that `blocks` output tiles fill the card."""
    return max(1, min(-(-_TARGET_BLOCKS // blocks), -(-k // depth)))
