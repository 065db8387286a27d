"""Batched stereo matching for rectified pairs.

Port of ``ygz_tpu/ops/stereo.py``: every feature's left patch is
correlated against its whole disparity strip of the right image at once,
an [N, D] zero-mean SAD surface, then argmin, a uniqueness ratio, a
parabola refinement and the frame-wide median cost cut. Plain PyTorch on
the caller's device (in JAX this is XLA-fused, not a Pallas kernel).

The right-image windows of one feature at disparities 0..D-1 overlap: on
each of the P window rows they cover D + P - 1 distinct columns. So the
right image is sampled once per (row, column) of that strip, [N, P,
D + P - 1], and the windows are a strided view of it. Each sample sits at
the float32 coordinate the JAX package samples (u - d + ox, one rounding
either way), so the windows hold the same values.
"""
from __future__ import annotations

import torch

from .image import sample_bilinear

PATCH = 11          # SAD window (the reference's 11x11)
HALF = PATCH // 2


def stereo_match_features(imgL, imgR, uv, valid, max_disp: int = 96,
                          min_disp: float = 0.5, uniq_ratio: float = 0.9):
    """Per-feature subpixel disparity by dense SAD over the epipolar row.

    Args:
      imgL, imgR: rectified [H, W] float32 images.
      uv: [N, 2] left-image feature positions (level 0).
      valid: [N] bool.
    Returns (disp [N] float32, ok [N] bool): disparity uL - uR >= 0.
    """
    H, W = imgL.shape
    D = max_disp
    dev = uv.device
    u, v = uv[:, 0], uv[:, 1]
    off = torch.arange(-HALF, HALF + 1, dtype=torch.float32, device=dev)

    # left patches [N, P, P]: row i at v + off[i], column j at u + off[j]
    xL, yL = torch.broadcast_tensors(u[:, None, None] + off[None, None, :],
                                     v[:, None, None] + off[None, :, None])
    patchL = sample_bilinear(imgL, torch.stack([xL, yL], -1))

    # right strip [N, P, D + P - 1]: column k at u + (k - (D - 1) - HALF),
    # so the window of disparity d, column j reads k = j - d + D - 1
    cols = torch.arange(D + PATCH - 1, dtype=torch.float32,
                        device=dev) - float(D - 1 + HALF)
    xR, yR = torch.broadcast_tensors(u[:, None, None] + cols[None, None, :],
                                     v[:, None, None] + off[None, :, None])
    strip = sample_bilinear(imgR, torch.stack([xR, yR], -1))
    # the windows as a view [N, P, S, P]: [n, i, s, j] = strip[n, i, s + j]
    # is disparity d = D - 1 - s
    patchR = strip.unfold(2, PATCH, 1)

    # zero-mean SAD: invariant to gain/offset differences between cameras
    muL = patchL.mean(dim=(1, 2), keepdim=True)
    muR = patchR.mean(dim=(1, 3), keepdim=True)
    diff = patchR - muR
    diff.sub_((patchL - muL)[:, :, None, :])
    sad = diff.abs_().sum(dim=(1, 3)).flip(1)                   # [N, D]
    d_range = torch.arange(D, dtype=torch.float32, device=dev)
    ur = u[:, None] - d_range[None, :]
    big = torch.full_like(sad, 1e9)
    # penalize out-of-image candidates
    sad = torch.where(ur - HALF >= 0, sad, big)

    best = torch.argmin(sad, dim=1)          # first index on a tie, as JAX
    bmin = sad.gather(1, best[:, None])[:, 0]
    # uniqueness: best must beat the best outside a +-2 window by the ratio
    idx = torch.arange(D, device=dev)[None, :]
    masked = torch.where((idx - best[:, None]).abs() <= 2, big, sad)
    second = masked.min(dim=1).values
    uniq = bmin < uniq_ratio * second

    # subpixel parabola on (best-1, best, best+1)
    s0 = sad.gather(1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    s2 = sad.gather(1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = s0 + s2 - 2.0 * bmin
    delta = torch.where(denom.abs() > 1e-6,
                        0.5 * (s0 - s2) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    disp = best.to(torch.float32) + delta

    ok = (valid & uniq & (disp >= min_disp) & (disp < D - 1)
          & (bmin < 1e8)
          & (v > HALF) & (v < H - HALF - 1)
          & (u > HALF) & (u < W - HALF - 1))

    # median-cost outlier cut (reference Frame::ComputeStereoMatches
    # epilogue: reject best SADs above 1.5 * 1.4 * median)
    costs = torch.where(ok, bmin, torch.full_like(bmin, 1e9))
    k = torch.clamp(ok.sum(), min=1)
    med = torch.sort(costs).values.gather(0, ((k - 1) // 2).reshape(1))
    ok = ok & (bmin <= 1.5 * 1.4 * med)
    return disp, ok
