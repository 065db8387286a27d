"""Fused per-frame tracking step over device-resident carry state.

Port of ``ygz_tpu/frontend/framestep.py``: ``frame_step`` (one frame) and
``frame_step_batch`` (B frames chained through the carry). One call per
frame: pyramid build (+ optional undistort remap), sparse alignment against
the last frame, direct local-map tracking, velocity update. On the card the
tracker replays ``frame_step`` as a captured CUDA graph through
``framestep_graph.FrameStepper`` (the port's counterpart of the JAX
``jit``); the eager functions are the CPU path and the replay's yardstick.
The packed layouts are the JAX package's, entry for entry:

  carry: pyr [SH, W] stacked | state [24] (R 9 | t 3 | Rv 9 | tv 3) |
         pts [cap, 6] (uv 2 | Xc 3 | valid 1)
  cache: [cap, CACHE_COLS = 419] (xyz 3 | valid 1 | patch 400 | ref_uv 2 |
         ref_level 1 | ref_R 9 | ref_t 3)
  out:   [N_SCALARS + 5 * cap] f32 — read back with ONE .cpu() per frame.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backend.mapstate import REF_PATCH
from ..ops.image import (build_pyramid, remap, stack_pyramid,
                         unstack_pyramid)
from .direct_tracker import track_local_map_direct
from .sparse_align import sparse_image_align

CACHE_COLS = 3 + 1 + REF_PATCH * REF_PATCH + 2 + 1 + 9 + 3
N_SCALARS = 29  # R 9 + t 3 + R_pred 9 + t_pred 3 + 5 scalar diagnostics


class FrameCarry(NamedTuple):
    pyr: torch.Tensor      # [SH, W] stacked prev-frame pyramid (f32)
    state: torch.Tensor    # [24] f32: R 9 | t 3 | Rv 9 | tv 3
    pts: torch.Tensor      # [cap, 6] f32: uv 2 | Xc 3 | valid 1


class FrameOut(NamedTuple):
    R: np.ndarray
    t: np.ndarray
    R_pred: np.ndarray
    t_pred: np.ndarray
    align_ok: bool
    align_n: float
    align_res: float
    n_align_in: float
    n_inliers: float
    tracked: np.ndarray    # [cap] bool
    visible: np.ndarray    # [cap] bool
    uv: np.ndarray         # [cap, 2]
    level: np.ndarray      # [cap]


def pack_cache_np(xyz, valid, patch, ref_uv, ref_level, ref_R, ref_t):
    """Host packing of the direct-tracking cache into one [cap, CACHE_COLS]
    float32 array."""
    cap = xyz.shape[0]
    out = np.empty((cap, CACHE_COLS), np.float32)
    o = 0
    for a, w in ((xyz, 3), (valid.reshape(cap, 1), 1),
                 (patch.reshape(cap, -1), REF_PATCH * REF_PATCH),
                 (ref_uv, 2), (ref_level.reshape(cap, 1), 1),
                 (ref_R.reshape(cap, 9), 9), (ref_t, 3)):
        out[:, o: o + w] = np.asarray(a, np.float32).reshape(cap, w)
        o += w
    return out


def unpack_cache(cache):
    """Packed [cap, CACHE_COLS] -> the 7 per-point arrays of
    track_local_map_direct (views + two casts)."""
    cap = cache.shape[0]
    xyz, valid, patch, ref_uv, ref_level, ref_R, ref_t = torch.split(
        cache, [3, 1, REF_PATCH * REF_PATCH, 2, 1, 9, 3], dim=1)
    return (xyz, valid[:, 0] > 0.5,
            patch.reshape(cap, REF_PATCH, REF_PATCH), ref_uv,
            ref_level[:, 0].to(torch.int32), ref_R.reshape(cap, 3, 3), ref_t)


def pack_pred_np(R_pred=None, t_pred=None, use: bool = False):
    """[13] f32 prediction vector: R 9 | t 3 | use 1."""
    v = np.zeros(13, np.float32)
    if R_pred is not None:
        v[:9] = np.asarray(R_pred, np.float32).ravel()
        v[9:12] = np.asarray(t_pred, np.float32)
    else:
        v[:9] = np.eye(3, dtype=np.float32).ravel()
    v[12] = 1.0 if use else 0.0
    return v


def _prep_image(img, remap_grid):
    img = img.to(torch.float32)
    if remap_grid is not None:
        img = remap(img, remap_grid[0], remap_grid[1])
    return img


def build_pyramid_stacked(img, remap_grid, n_levels: int,
                          scale_factor: float = 2.0):
    """Pyramid (+ optional [2, H, W] undistort remap) as one stacked
    [SH, W] buffer."""
    return stack_pyramid(build_pyramid(_prep_image(img, remap_grid),
                                       n_levels, scale_factor))


def build_pyramid_dispatch(img, remap_grid, n_levels: int,
                           scale_factor: float = 2.0):
    """Pyramid (+ optional undistort) as a level tuple."""
    return build_pyramid(_prep_image(img, remap_grid), n_levels,
                         scale_factor)


def frame_step(img, carry: FrameCarry, cache, pred, remap_grid, intr,
               n_levels: int = 4, scale_factor: float = 2.0,
               min_align: int = 30, align_iters: int = 10):
    """One tracked frame on the carry's device.

    img [H, W] (uint8 or float32) tensor; cache [cap, CACHE_COLS]; pred [13]
    (pack_pred_np); remap_grid [2, H, W] or None. Returns (new_carry,
    packed_out [N_SCALARS + 5 * cap] f32 — decode with unpack_out)."""
    img = _prep_image(img, remap_grid)
    pyr = build_pyramid(img, n_levels, scale_factor)
    prev_pyr = unstack_pyramid(carry.pyr, n_levels, scale_factor,
                               height=img.shape[0])
    s = carry.state
    R_prev, t_prev = s[:9].reshape(3, 3), s[9:12]
    Rv, tv = s[12:21].reshape(3, 3), s[21:24]
    uv_prev = carry.pts[:, 0:2]
    Xc_prev = carry.pts[:, 2:5]
    valid_prev = carry.pts[:, 5] > 0.5
    use_pred = pred[12] > 0.5
    cache_arrays = unpack_cache(cache)

    # velocity model, or an external prediction (use flag set)
    R_mm = torch.where(use_pred, pred[:9].reshape(3, 3), Rv @ R_prev)
    t_mm = torch.where(use_pred, pred[9:12], Rv @ t_prev + tv)

    # sparse alignment from the last frame, seeded from the identity
    dev = img.device
    n_align_in = valid_prev.sum()
    ares = sparse_image_align(
        prev_pyr, pyr, uv_prev, Xc_prev, valid_prev, intr,
        torch.eye(3, device=dev), torch.zeros(3, device=dev),
        levels=tuple(range(n_levels - 1, 0, -1)), iters=align_iters)
    align_ok = (n_align_in >= min_align) & (ares.n_meas >= min_align)
    R_pred = torch.where(align_ok, ares.R @ R_prev, R_mm)
    t_pred = torch.where(align_ok, ares.R @ t_prev + ares.t, t_mm)

    pyr_stack = stack_pyramid(pyr)
    dres = track_local_map_direct(pyr_stack, R_pred, t_pred, *cache_arrays,
                                  intr, n_levels=n_levels)
    R_new, t_new = dres.R, dres.t

    # velocity update + next-frame alignment points
    Rv_new = R_new @ R_prev.T
    tv_new = t_new - Rv_new @ t_prev
    Xc = cache_arrays[0] @ R_new.T + t_new
    valid_next = dres.tracked & (Xc[:, 2] > 0.1)
    f32 = torch.float32
    new_carry = FrameCarry(
        pyr=pyr_stack,
        state=torch.cat([R_new.reshape(9), t_new, Rv_new.reshape(9), tv_new]),
        pts=torch.cat([dres.uv, Xc, valid_next[:, None].to(f32)], 1))
    packed = torch.cat([
        R_new.reshape(-1), t_new, R_pred.reshape(-1), t_pred,
        torch.stack([align_ok.to(f32), ares.n_meas.to(f32),
                     ares.mean_res.to(f32), n_align_in.to(f32),
                     dres.n_inliers.to(f32)]),
        dres.tracked.to(f32), dres.visible.to(f32), dres.uv.reshape(-1),
        dres.level.to(f32)])
    return new_carry, packed


def frame_step_batch(imgs, carry: FrameCarry, cache, remap_grid, intr,
                     n_levels: int = 4, scale_factor: float = 2.0,
                     min_align: int = 30, align_iters: int = 10):
    """B consecutive frames imgs [B, H, W] chained through the carry, each
    with the velocity model (no external prediction): ``frame_step`` B
    times. Returns (new_carry, outs [B, N_SCALARS + 5 * cap], pyrs
    [B, SH, W] the frames' stacked pyramids)."""
    no_pred = torch.as_tensor(pack_pred_np(), device=imgs.device)
    outs, pyrs = [], []
    for img in imgs:
        carry, packed = frame_step(img, carry, cache, no_pred, remap_grid,
                                   intr, n_levels=n_levels,
                                   scale_factor=scale_factor,
                                   min_align=min_align,
                                   align_iters=align_iters)
        outs.append(packed)
        pyrs.append(carry.pyr)
    return carry, torch.stack(outs), torch.stack(pyrs)


def unpack_out(vec, cap: int) -> FrameOut:
    """Host-side decode of the packed frame output (a numpy array)."""
    s = vec[:N_SCALARS]
    o = N_SCALARS
    tracked = vec[o: o + cap] > 0.5
    visible = vec[o + cap: o + 2 * cap] > 0.5
    uv = vec[o + 2 * cap: o + 4 * cap].reshape(cap, 2)
    level = vec[o + 4 * cap: o + 5 * cap].astype(np.int32)
    return FrameOut(R=s[0:9].reshape(3, 3), t=s[9:12],
                    R_pred=s[12:21].reshape(3, 3), t_pred=s[21:24],
                    align_ok=bool(s[24] > 0.5), align_n=s[25],
                    align_res=s[26], n_align_in=s[27], n_inliers=s[28],
                    tracked=tracked, visible=visible, uv=uv, level=level)


def make_carry(pyr, R, t, uv, Xc, valid, Rv=None, tv=None) -> FrameCarry:
    """Host-side carry construction (after init or a fallback recovery).
    `pyr` is a level tuple or a stacked [SH, W] tensor; the carry lives on
    its device."""
    if isinstance(pyr, (tuple, list)):
        pyr = stack_pyramid(tuple(pyr))
    if Rv is None:
        Rv = np.eye(3, dtype=np.float32)
    if tv is None:
        tv = np.zeros(3, np.float32)
    state = np.concatenate([
        np.asarray(R, np.float32).ravel(), np.asarray(t, np.float32),
        np.asarray(Rv, np.float32).ravel(), np.asarray(tv, np.float32)])
    pts = np.concatenate(
        [np.asarray(uv, np.float32), np.asarray(Xc, np.float32),
         np.asarray(valid, np.float32).reshape(-1, 1)], axis=1)
    dev = pyr.device
    return FrameCarry(pyr=pyr, state=torch.as_tensor(state, device=dev),
                      pts=torch.as_tensor(pts, device=dev))
