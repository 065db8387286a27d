"""Native dataset runtime (C++): PNG grayscale decode + threaded prefetch.

Port of ``ygz_tpu/native``. ``loader.cpp`` is compiled with g++ and libpng
on first use (plain CPython C API, no pybind11) into the git-ignored
``build/ygz_tpu_torch/`` at the repository root, under a name that carries
a hash of the source; a cached library that does not load (built on
another machine) is rebuilt once. Where g++, libpng or the Python headers
are missing, ``io/png.py`` decodes instead; ``available()`` says whether
the native route is active and ``route()`` names it (with the reason for a
failed build). Both routes give the same bytes. ``unfilter.cpp``, io/png.py's
row unfiltering, is built the same way with g++ alone. This is host I/O,
not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

from ..io import png

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "loader.cpp"
_UNFILTER_SRC = _HERE / "unfilter.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "ygz_tpu_torch"
_lock = threading.Lock()
_mod = None
_tried = False
_why = ""
_unfilter = None     # (ctypes function or None, why it did not build)


def _built_path(src: Path, stem: str) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}_{digest}.so"


def library_path() -> Path:
    return _built_path(_SRC, "ygz_torch_native")


def unfilter_library_path() -> Path:
    return _built_path(_UNFILTER_SRC, "ygz_torch_unfilter")


def _compile(src: Path, out: Path, args=()):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src),
           *args, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        lines = proc.stderr.strip().splitlines() or ["g++ failed"]
        raise RuntimeError(next((ln for ln in lines if "error" in ln),
                                lines[-1]))
    os.replace(tmp, out)


def _build(out: Path):
    args = [f"-I{sysconfig.get_paths()['include']}", "-lpng"]
    # load libpng from where the linker finds it, on any library path
    lib = subprocess.run(["g++", "-print-file-name=libpng.so"],
                         capture_output=True, text=True).stdout.strip()
    if os.path.isabs(lib):
        args.append(f"-Wl,-rpath,{os.path.dirname(os.path.realpath(lib))}")
    _compile(_SRC, out, args)


def _load_cached(out: Path, build, load):
    """load(out), built first where it is missing; a cached file that fails
    to load is rebuilt once."""
    if not out.exists():
        build(out)
        return load(out)
    try:
        return load(out)
    except (OSError, ImportError):
        out.unlink(missing_ok=True)
        build(out)
        return load(out)


def _import(out: Path):
    spec = importlib.util.spec_from_file_location("ygz_torch_native", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load():
    global _mod, _tried, _why
    with _lock:
        if _tried:
            return _mod
        _tried = True
        try:
            _mod = _load_cached(library_path(), _build, _import)
        except (OSError, RuntimeError, ImportError) as e:
            _why = f"{type(e).__name__}: {e}"
        return _mod


def unfilter_fn():
    """(ygz_png_unfilter from unfilter.cpp through ctypes, "") where it
    built, else (None, why not)."""
    global _unfilter
    with _lock:
        if _unfilter is None:
            try:
                lib = _load_cached(unfilter_library_path(),
                                   lambda out: _compile(_UNFILTER_SRC, out),
                                   lambda out: ctypes.CDLL(str(out)))
                fn = lib.ygz_png_unfilter
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64]
                _unfilter = (fn, "")
            except (OSError, RuntimeError, AttributeError) as e:
                _unfilter = (None, f"{type(e).__name__}: {e}")
        return _unfilter


def available() -> bool:
    """True when the libpng loader built and loaded."""
    return _load() is not None


def route() -> str:
    """Which decoder runs: 'native (libpng)', or 'io/png.py with the
    <C or Python> unfilter (<why the native build failed>)'."""
    if _load() is not None:
        return "native (libpng)"
    return f"io/png.py with the {png.unfilter_route()} unfilter ({_why})"


def _as_image(buf, h, w):
    return np.frombuffer(buf, np.uint8).reshape(h, w).astype(np.float32)


def decode_gray(path: str) -> np.ndarray:
    """[H, W] float32 gray of a PNG file; libpng where it built,
    io/png.py otherwise."""
    m = _load()
    if m is not None:
        return _as_image(*m.decode_png_gray(str(path)))
    return png.decode_gray(str(path))


class FramePrefetcher:
    """Decode-ahead frame reader over a list of PNG paths: the native
    worker pool where it built, else synchronous decodes."""

    def __init__(self, paths, ahead: int = 8, threads: int = 2):
        self.paths = [str(p) for p in paths]
        m = _load()
        self._native = (m.Prefetcher(self.paths, ahead, threads)
                        if m is not None else None)

    def get(self, i: int) -> np.ndarray:
        if self._native is not None:
            return _as_image(*self._native.get(i))
        return png.decode_gray(self.paths[i])
