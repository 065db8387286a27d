"""Build and load the port's hand-written CUDA kernels (plain C interface).

Each ``ygz_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a
into ``build/ygz_tpu_torch/`` at the repository root (git-ignored) on first
use, and loaded with ``ctypes``. The library file name carries a hash of
the source, so an edited kernel is rebuilt and a stale one is never
loaded. Nothing here runs at import time; a missing toolchain raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ygz_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                       "kernels of ygz_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu if its hashed library is missing."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
