"""FAST-10 corner scores + 3x3 non-maximum suppression, full image.

Port of ``ygz_tpu/ops/fast.py``. Two wrappers of the hand-written CUDA
source ``csrc/fast_score.cu`` (the Hopper port of the TPU kernel
``ygz_tpu/ops/pallas_fast.py::fast_score_map_pallas``):

- ``fast_score_map``: the score map of one image at one threshold;
- ``fast_corner_maps``: the extractor's front over a whole stacked pyramid
  in one launch (both thresholds, the merge and the NMS).

A CUDA tensor launches the kernel, a CPU tensor takes the plain PyTorch
version (``fast_score_map_torch``, ``fast_corner_maps_torch``), anything
else raises. Kernel and plain version give the same bits for any threshold
>= 0 (a FAST threshold); the wrappers refuse a negative one.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .image import pyramid_shapes, stack_rows, unstack_pyramid

# Bresenham circle of radius 3 — (dx, dy), clockwise from (0,-3).
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 10  # FAST-10
# high-threshold corners rank above every low-threshold one in the merge
HI_BONUS = 1000.0
# the launch counts are bumped from the tracking and the mapping threads
_count_lock = threading.Lock()


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


def nonmax_3x3(score):
    """Keep only 3x3-neighbourhood maxima (ties kept)."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                neigh = torch.maximum(neigh, _shift(score, dx, dy))
    return torch.where(score >= neigh, score, torch.zeros_like(score))


def _kernel(name, argtypes):
    from ..utils import cuda_build

    fn = getattr(cuda_build.load("fast_score"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_args(x, name, *thresholds):
    if not isinstance(x, torch.Tensor) or x.dim() != 2 \
            or x.dtype != torch.float32:
        raise TypeError(f"{name} takes a 2-D float32 tensor")
    # the kernels' exactness argument (csrc/fast_score.cu) needs th >= 0
    if not all(th >= 0.0 for th in thresholds):
        raise ValueError(f"{name}: FAST thresholds must be >= 0, got "
                         f"{thresholds}")


def fast_score_map(img, threshold: float = 20.0):
    """FAST-10 corner response [H, W] float32 of a 2-D float32 image.

    CUDA tensors run the hand-written kernel (counted in
    ``fast_score_map.launches``); CPU tensors run the plain version."""
    _check_args(img, "fast_score_map", threshold)
    if img.device.type == "cuda":
        if not img.is_contiguous():
            raise ValueError("fast_score_map needs a contiguous CUDA tensor")
        fn = _kernel("ygz_fast_score",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        out = torch.empty_like(img)
        H, W = img.shape
        stream = torch.cuda.current_stream(img.device).cuda_stream
        _check_launch(fn(img.data_ptr(), out.data_ptr(), H, W,
                         float(threshold), stream), "fast_score")
        with _count_lock:
            fast_score_map.launches += 1
        return out
    if img.device.type == "cpu":
        return fast_score_map_torch(img, threshold)
    raise ValueError(f"fast_score_map: unsupported device {img.device}")


fast_score_map.launches = 0


def fast_corner_maps_torch(stack, height: int, n_levels: int, th_hi: float,
                           th_lo: float):
    """Plain PyTorch extraction front of a stacked [SH, W0] pyramid: per
    level nonmax_3x3(where(fast(th_hi) > 0, fast(th_hi) + 1000,
    fast(th_lo))), stacked the same way, 0 in the pad columns."""
    out = torch.zeros_like(stack)
    offs, _ = stack_rows(height, stack.shape[1], n_levels)
    for o, lv in zip(offs, unstack_pyramid(stack, n_levels, height=height)):
        hi = fast_score_map_torch(lv, th_hi)
        lo = fast_score_map_torch(lv, th_lo)
        h, w = lv.shape
        out[o: o + h, :w] = nonmax_3x3(torch.where(hi > 0, hi + HI_BONUS, lo))
    return out


def fast_corner_maps(stack, height: int, n_levels: int, th_hi: float,
                     th_lo: float, scale_factor: float = 2.0):
    """Merged, non-maximum-suppressed FAST-10 corner maps of every level of
    a contiguous stacked [SH, W0] float32 pyramid (level-0 height
    `height`), as one stacked [SH, W0] map.

    CUDA tensors run one launch of the hand-written kernel (counted in
    ``fast_corner_maps.launches``); CPU tensors run the plain version."""
    _check_args(stack, "fast_corner_maps", th_hi, th_lo)
    if not stack.is_contiguous():
        raise ValueError("fast_corner_maps needs a contiguous stacked buffer")
    w0 = stack.shape[1]
    offs, total = stack_rows(height, w0, n_levels, scale_factor)
    if total != stack.shape[0]:
        raise ValueError(f"stack has {stack.shape[0]} rows; {n_levels} "
                         f"levels of height {height} take {total}")
    if stack.device.type == "cuda":
        shapes = pyramid_shapes(height, w0, n_levels, scale_factor)
        ints = ctypes.c_int * n_levels
        p_int = ctypes.POINTER(ctypes.c_int)
        fn = _kernel("ygz_fast_corners",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      p_int, p_int, p_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p])
        out = torch.empty_like(stack)
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        _check_launch(fn(stack.data_ptr(), out.data_ptr(), w0, ints(*offs),
                         ints(*(h for h, _ in shapes)),
                         ints(*(w for _, w in shapes)), n_levels,
                         float(th_hi), float(th_lo), stream), "fast_corners")
        with _count_lock:
            fast_corner_maps.launches += 1
        return out
    if stack.device.type == "cpu":
        return fast_corner_maps_torch(stack, height, n_levels, th_hi, th_lo)
    raise ValueError(f"fast_corner_maps: unsupported device {stack.device}")


fast_corner_maps.launches = 0
