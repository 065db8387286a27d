"""Grid-based keypoint selection with occupancy masking (DSO-style).

Port of ``ygz_tpu/ops/select.py`` (``select_octree`` is not ported yet).
``lax.top_k`` puts the lower index first on ties, and FAST scores on u8
frames tie often; ``torch.topk`` promises no tie order, so every top-k
here is a stable descending sort (equal keys keep index order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def topk_stable(x, k: int):
    """(values, indices) of the k largest entries along the last dim, ties
    broken towards the lower index (lax.top_k semantics)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def stamp_occupancy(h: int, w: int, uv, valid, radius: int):
    """Boolean [h, w] map, True within `radius` (Chebyshev) of a valid uv."""
    x = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    occ = torch.zeros(h * w, dtype=torch.float32, device=uv.device)
    occ.scatter_reduce_(0, y * w + x, valid.to(torch.float32), reduce="amax")
    occ = occ.reshape(h, w)
    if radius > 0:
        occ = F.max_pool2d(occ[None, None], 2 * radius + 1, stride=1,
                           padding=radius)[0, 0]
    return occ > 0.5


def select_grid_topk(score, cell: int, max_per_cell: int, max_kp: int,
                     border: int = 20, occupancy=None, min_score: float = 0.0):
    """Up to `max_kp` keypoints: <= max_per_cell strongest per grid cell,
    then the strongest overall. Returns uv [max_kp, 2] f32, score
    [max_kp], valid [max_kp] bool."""
    H, W = score.shape
    dev = score.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    if occupancy is not None:
        ok = ok & (~occupancy)
    s = torch.where(ok & (score > min_score), score,
                    torch.full_like(score, -1.0))
    gh = (H + cell - 1) // cell
    gw = (W + cell - 1) // cell
    s = F.pad(s, (0, gw * cell - W, 0, gh * cell - H), value=-1.0)
    cells = s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell * cell)

    top_s, top_i = topk_stable(cells, max_per_cell)            # [C, m]
    ci = torch.arange(gh * gw, device=dev)[:, None]
    cy = (ci // gw) * cell + top_i // cell
    cx = (ci % gw) * cell + top_i % cell
    flat_s = top_s.reshape(-1)
    flat_x = cx.reshape(-1).to(torch.float32)
    flat_y = cy.reshape(-1).to(torch.float32)

    k = min(max_kp, flat_s.shape[0])
    best_s, best_i = topk_stable(flat_s, k)
    uv = torch.stack([flat_x[best_i], flat_y[best_i]], 1)
    valid = best_s > 0.0
    if k < max_kp:
        uv = F.pad(uv, (0, 0, 0, max_kp - k))
        best_s = F.pad(best_s, (0, max_kp - k))
        valid = F.pad(valid, (0, max_kp - k))
    return uv, best_s, valid


def cell_size_for_budget(h: int, w: int, n_features: int) -> int:
    """Initial DSO grid size ~ sqrt(H*W/n), clamped to [8, 64]."""
    g = int(math.sqrt(h * w / max(n_features, 1)))
    return max(8, min(64, g))
