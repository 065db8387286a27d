"""Multi-level ORB feature extraction.

Port of ``ygz_tpu/frontend/extractor.py``: FAST-10 scores at two
thresholds -> merge -> 3x3 NMS over the whole stacked pyramid (one launch
of the CUDA kernel for CUDA tensors, ``ops/fast.py::fast_corner_maps``),
then per level the keypoint selector -> IC angle -> steered BRIEF on the
blurred level, with fixed per-level keypoint budgets. The selector is the
DSO-style grid-capped top-k (``mode="grid"``) or the quadtree-style
``select_octree`` (``mode="octree"``, the reference's DistributeOctTree).
Keypoint uv is reported in LEVEL-0 pixels; `level` records the octave.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import fast, orb, select
from ..ops.image import (as_levels, gaussian_blur, stack_and_height,
                         stack_rows)


class Features(NamedTuple):
    uv: torch.Tensor      # [M, 2] level-0 coords
    level: torch.Tensor   # [M] int32 octave
    angle: torch.Tensor   # [M] radians
    score: torch.Tensor   # [M]
    desc: torch.Tensor    # [M, 256] uint8 bits
    valid: torch.Tensor   # [M] bool


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Per-level keypoint budgets, geometric in 1/scale_factor."""
    inv = 1.0 / scale_factor
    w = [inv ** lvl for lvl in range(n_levels)]
    s = sum(w)
    return [max(16, int(round(n_features * wi / s))) for wi in w]


class OrbExtractor:
    """Static extraction config; ``__call__`` extracts from a pyramid
    (level tuple or stacked [SH, W] tensor)."""

    def __init__(self, n_features: int = 512, n_levels: int = 4,
                 scale_factor: float = 2.0, fast_th: float = 20.0,
                 fast_th_min: float = 7.0, cell: int = 16,
                 max_per_cell: int = 3, border: int = 20,
                 mode: str = "grid"):
        if mode not in ("grid", "octree"):
            raise ValueError(f"keypoint mode {mode!r}: 'grid' or 'octree'")
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_th = fast_th
        self.fast_th_min = fast_th_min
        self.cell = cell
        self.max_per_cell = max_per_cell
        self.border = border
        self.mode = mode
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.total = sum(self.budgets)

    def _extract_level(self, img, merged, budget, border, occupancy=None):
        """Keypoints of one level from its merged, suppressed corner map
        (high-threshold corners rank first; the low threshold fills cells
        the high one left empty)."""
        if self.mode == "octree":
            uv, s, valid = select.select_octree(
                merged, max_kp=budget, border=border, occupancy=occupancy)
        else:
            uv, s, valid = select.select_grid_topk(
                merged, cell=self.cell, max_per_cell=self.max_per_cell,
                max_kp=budget, border=border, occupancy=occupancy)
        ang = orb.ic_angles(img, uv, valid)
        desc = orb.brief_descriptors(gaussian_blur(img, 7, 2.0), uv, ang,
                                     valid)
        return uv, s, valid, ang, desc

    def __call__(self, pyramid, occupancy=None) -> Features:
        stack, height = stack_and_height(pyramid, self.n_levels)
        stack = stack.contiguous()
        corners = fast.fast_corner_maps(stack, height, self.n_levels,
                                        self.fast_th, self.fast_th_min,
                                        self.scale_factor)
        offs, _ = stack_rows(height, stack.shape[1], self.n_levels,
                             self.scale_factor)
        pyramid = as_levels(pyramid, self.n_levels, self.scale_factor, height)
        outs = []
        for lvl in range(self.n_levels):
            img = pyramid[lvl].contiguous()
            h, w = img.shape
            scale = self.scale_factor ** lvl
            occ = occupancy[lvl] if occupancy is not None else None
            # border shrinks with level so level-0 coverage stays constant
            border = max(8, int(round(self.border / scale)))
            uv, s, valid, ang, desc = self._extract_level(
                img, corners[offs[lvl]: offs[lvl] + h, :w],
                self.budgets[lvl], border, occ)
            outs.append(((uv + 0.5) * scale - 0.5,
                         torch.full((uv.shape[0],), lvl, dtype=torch.int32,
                                    device=uv.device), ang, s, desc, valid))
        return Features(*(torch.cat([o[i] for o in outs]) for i in range(6)))

    def extract_keyframe(self, pyramid, uv0, level, valid):
        """Descriptors/angles at the tracked positions + occupancy stamping
        around them + fresh features in the unoccupied area. Returns
        (angle [M], desc [M, 256], Features)."""
        levels = as_levels(pyramid, self.n_levels, self.scale_factor)
        ang, desc = describe_at_core(levels, uv0, level, valid,
                                     self.n_levels, self.scale_factor)
        occ = []
        for lvl in range(self.n_levels):
            s = 0.5 ** lvl
            h, w = levels[lvl].shape
            occ.append(select.stamp_occupancy(
                h, w, (uv0 + 0.5) * s - 0.5, valid, radius=max(4, int(8 * s))))
        return ang, desc, self(pyramid, occ)


def describe_at_core(pyramid, uv0, level, valid, n_levels: int,
                     scale_factor: float):
    """IC angle + BRIEF for EXISTING keypoints (uv0 level-0, level [M])."""
    pyramid = as_levels(pyramid, n_levels, scale_factor)
    M = uv0.shape[0]
    angle = torch.zeros(M, dtype=torch.float32, device=uv0.device)
    desc = torch.zeros(M, 256, dtype=torch.uint8, device=uv0.device)
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        sel = valid & (level == lvl)
        uv_l = (uv0 + 0.5) * s - 0.5
        img = pyramid[lvl].contiguous()
        ang_l = orb.ic_angles(img, uv_l, sel)
        desc_l = orb.brief_descriptors(gaussian_blur(img, 7, 2.0), uv_l,
                                       ang_l, sel)
        angle = torch.where(sel, ang_l, angle)
        desc = torch.where(sel[:, None], desc_l, desc)
    return angle, desc
