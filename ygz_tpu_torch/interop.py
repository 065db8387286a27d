"""Carry state across from the JAX package (as numpy arrays).

The system has no model weights: its state is the map, the per-frame carry
and the direct-tracking cache. ``ygz_tpu`` and this port share the packed
layouts (``frontend/framestep.py``), so the JAX package's state, read back
as numpy, becomes the port's tensors here. ``SlamMap`` is host numpy in
both packages and is shared as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontend.framestep import CACHE_COLS, FrameCarry


def _to(a, device):
    # a copy: arrays read back from jax are read-only
    return torch.as_tensor(np.array(a, np.float32), device=device)


def carry_from_numpy(pyr, state, pts, device="cpu") -> FrameCarry:
    """FrameCarry from its three arrays: pyr [SH, W] stacked pyramid,
    state [24], pts [cap, 6] (e.g. ``jax FrameCarry`` fields through
    ``np.asarray``)."""
    state = np.asarray(state)
    pts = np.asarray(pts)
    if state.shape != (24,) or pts.ndim != 2 or pts.shape[1] != 6:
        raise ValueError(f"carry shapes: state {state.shape}, pts "
                         f"{pts.shape}")
    return FrameCarry(pyr=_to(pyr, device), state=_to(state, device),
                      pts=_to(pts, device))


def cache_from_numpy(cache, device="cpu"):
    """The packed [cap, CACHE_COLS] direct-tracking cache."""
    cache = np.asarray(cache)
    if cache.ndim != 2 or cache.shape[1] != CACHE_COLS:
        raise ValueError(f"cache must be [cap, {CACHE_COLS}], got "
                         f"{cache.shape}")
    return _to(cache, device)
