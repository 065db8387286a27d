"""FAST-10 corner scores + 3x3 non-maximum suppression, full image.

Port of ``ygz_tpu/ops/fast.py``. ``fast_score_map`` is the wrapper of the
hand-written CUDA kernel ``csrc/fast_score.cu`` (the Hopper port of the TPU
kernel ``ygz_tpu/ops/pallas_fast.py::fast_score_map_pallas``): a CUDA
tensor launches the kernel, a CPU tensor takes the plain PyTorch version
``fast_score_map_torch``, anything else raises. Both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

# Bresenham circle of radius 3 — (dx, dy), clockwise from (0,-3).
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 10  # FAST-10


def _shift(img, dx, dy):
    """out[y, x] = img[y + dy, x + dx] (wrapped; the 3-px frame masks it)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_score_map_torch(img, threshold: float = 20.0):
    """Plain PyTorch FAST-10 score map [H, W] (0 where not a corner)."""
    H, W = img.shape
    taps = torch.stack([_shift(img, dx, dy) for dx, dy in CIRCLE])
    diff = taps - img[None]
    bright = diff - threshold
    dark = (-diff) - threshold

    def arc_strength(x):
        ext = torch.cat([x, x[: ARC - 1]], 0)
        m = ext[:16]
        for j in range(1, ARC):
            m = torch.minimum(m, ext[j: j + 16])
        return m.amax(0)

    strength = torch.maximum(arc_strength(bright), arc_strength(dark))
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    score = torch.where(strength > 0.0, strength + threshold, zero)
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    frame = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(frame, score, zero)


def _launch_cuda(img, threshold):
    from ..utils import cuda_build

    lib = cuda_build.load("fast_score")
    fn = lib.ygz_fast_score
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(img)
    H, W = img.shape
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = fn(img.data_ptr(), out.data_ptr(), H, W, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"fast_score kernel launch failed: CUDA error "
                           f"{err}")
    fast_score_map.launches += 1
    return out


def fast_score_map(img, threshold: float = 20.0):
    """FAST-10 corner response [H, W] float32 of a 2-D float32 image.

    CUDA tensors run the hand-written kernel (counted in
    ``fast_score_map.launches``); CPU tensors run the plain version."""
    if not isinstance(img, torch.Tensor) or img.dim() != 2 \
            or img.dtype != torch.float32:
        raise TypeError("fast_score_map takes a 2-D float32 tensor")
    if img.device.type == "cuda":
        if not img.is_contiguous():
            raise ValueError("fast_score_map needs a contiguous CUDA tensor")
        return _launch_cuda(img, threshold)
    if img.device.type == "cpu":
        return fast_score_map_torch(img, threshold)
    raise ValueError(f"fast_score_map: unsupported device {img.device}")


fast_score_map.launches = 0


def nonmax_3x3(score):
    """Keep only 3x3-neighbourhood maxima (ties kept)."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                neigh = torch.maximum(neigh, _shift(score, dx, dy))
    return torch.where(score >= neigh, score, torch.zeros_like(score))
