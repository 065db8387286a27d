"""Build and load the port's hand-written CUDA kernels (plain C interface).

Each ``ygz_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a
into ``build/ygz_tpu_torch/`` at the repository root (git-ignored) on first
use, and loaded with ``ctypes`` (``CDLL``, which releases Python's
interpreter lock during each call; ``PyDLL`` for an entry that must keep
it). The library file name carries a hash of
the source and of the shared headers (``csrc/*.cuh``), so an edited kernel
is rebuilt and a stale one is never loaded. Nothing here runs at import
time; a missing toolchain raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ygz_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[tuple[str, bool], ctypes.CDLL] = {}
# launch counts are bumped from the tracking and the mapping threads
_count_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA "
                       "kernels of ygz_tpu_torch cannot be built")


def sources() -> list[str]:
    """The names of every kernel source, csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


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


def build_all(verbose: bool = False) -> list[Path]:
    """Compile every csrc/*.cu, one nvcc process each, all at once."""
    names = sources()
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(lambda n: build(n, verbose), names))


def load(name: str, hold_gil: bool = False) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first use); with
    hold_gil, loaded as a ctypes.PyDLL, whose calls keep the interpreter
    lock."""
    lib = _loaded.get((name, hold_gil))
    if lib is None:
        kind = ctypes.PyDLL if hold_gil else ctypes.CDLL
        lib = kind(str(build(name)))
        _loaded[(name, hold_gil)] = lib
    return lib


def function(name: str, entry: str, argtypes,
             hold_gil: bool = False) -> ctypes._CFuncPtr:
    """The C entry `entry` of csrc/<name>.cu with its argument types set
    (ctypes.c_void_p for every pointer and the stream) and an int return:
    the cudaGetLastError() right after the launch, or the CUDA call's own
    error code. hold_gil: the call keeps the interpreter lock (load)."""
    fn = getattr(load(name, hold_gil), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def check_call(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def count_launch(wrapper) -> None:
    """One more launch on the wrapper's plain-integer counter. A call made
    while its stream is captured into a CUDA graph runs no kernel (the
    graph's replays do, with no wrapper call) and is not counted."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        return
    with _count_lock:
        wrapper.launches += 1


def rows_arg(x, cols: int, dtype, name: str):
    """(tensor, row stride in elements) of an [N, cols] (or [N] for cols 0)
    kernel input on the card: rows may be strided views (the frame step's
    cache columns), entries within a row must be adjacent."""
    import torch

    if not isinstance(x, torch.Tensor) or x.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor")
    if x.dim() != (2 if cols else 1) or (cols and x.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(x.shape)}")
    if cols and x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def on_device(name: str, tensors, launch, plain=None):
    """A kernel wrapper's device switch: ``launch()`` when ``tensors`` (None
    entries skipped) are on a CUDA device, the plain version ``plain()``
    on the CPU. Another device, or the CPU without a plain version, raises
    "<name>: unsupported device <dev>"; tensors on two devices raise
    "<name>: inputs on different devices" (both ValueError)."""
    tensors = [x for x in tensors if x is not None]
    dev = tensors[0].device
    if dev.type != "cuda" and (dev.type != "cpu" or plain is None):
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(x.device != dev for x in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    return launch() if dev.type == "cuda" else plain()
