"""Carry state across from the JAX package (as numpy arrays).

The system has no model weights: its state is the map, the per-frame carry
and the direct-tracking cache. ``ygz_tpu`` and this port share the packed
layouts (``frontend/framestep.py``), so the JAX package's state, read back
as numpy, becomes the port's tensors here. ``SlamMap`` is host numpy in
both packages and is shared as it is.

The IMU state crosses the same way: a preintegration, a NavState or a
(P, V, R, bg, ba) state tuple of the JAX package, read back as numpy,
becomes the port's tensors, and back to numpy arrays in the same field
order, which the JAX package's NamedTuples take as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .frontend.framestep import CACHE_COLS, FrameCarry
from .imu.navstate import NavState
from .imu.preintegration import PreintState


def _to(a, device):
    # a copy: arrays read back from jax are read-only
    return torch.as_tensor(np.array(a, np.float32), device=device)


def carry_from_numpy(pyr, state, pts, device="cuda") -> FrameCarry:
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


def cache_from_numpy(cache, device="cuda"):
    """The packed [cap, CACHE_COLS] direct-tracking cache."""
    cache = np.asarray(cache)
    if cache.ndim != 2 or cache.shape[1] != CACHE_COLS:
        raise ValueError(f"cache must be [cap, {CACHE_COLS}], got "
                         f"{cache.shape}")
    return _to(cache, device)


def preint_from_numpy(pre, device="cuda") -> PreintState:
    """PreintState from any object with its fields (dP, dV, dR, J_P_bg,
    J_P_ba, J_V_bg, J_V_ba, J_R_bg, cov, dt), e.g. the JAX package's; a
    list of them is stacked into one batch."""
    if isinstance(pre, (list, tuple)) and not hasattr(pre, "_fields"):
        return PreintState(*(
            _to(np.stack([np.asarray(getattr(p, f)) for p in pre]), device)
            for f in PreintState._fields))
    return PreintState(*(_to(getattr(pre, f), device)
                         for f in PreintState._fields))


def navstate_from_numpy(ns, device="cuda") -> NavState:
    """NavState from any object with its fields (P, V, R, bg, ba, dbg,
    dba)."""
    return NavState(*(_to(getattr(ns, f), device) for f in NavState._fields))


def state_from_numpy(state, device="cuda") -> tuple:
    """The optimizers' (P, V, R, bg, ba) tuple of tensors."""
    return tuple(_to(a, device) for a in state)


def to_numpy(x):
    """A PreintState, NavState or state tuple of the port (or any tuple of
    tensors) as a tuple of numpy arrays in its field order; a NamedTuple
    keeps its type's fields: ``jax_type(*to_numpy(x))`` rebuilds it."""
    return tuple(np.asarray(a.detach().cpu().numpy()
                            if isinstance(a, torch.Tensor) else a)
                 for a in x)
