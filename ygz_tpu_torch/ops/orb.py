"""Oriented BRIEF (ORB): intensity-centroid angle + steered binary tests.

Port of ``ygz_tpu/ops/orb.py``; the 256-pair test pattern is the same
seeded Gaussian draw, so descriptors are comparable across the packages.
Rotated test points are rounded to the nearest pixel, so a last-bit
difference in an angle can move a test point: compare descriptors of the
two packages by Hamming distance, not for equality.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15          # IC-angle circular patch radius
PATTERN_RADIUS = 13      # max |coordinate| of a BRIEF test point
N_TESTS = 256


@functools.lru_cache()
def brief_pattern() -> np.ndarray:
    """[256, 4] int8 test pairs (x1, y1, x2, y2)."""
    rng = np.random.default_rng(20240817)
    pts = rng.normal(0.0, HALF_PATCH / 2.2, size=(N_TESTS * 2, 2))
    r = np.linalg.norm(pts, axis=1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_RADIUS / np.maximum(r, 1e-9))
    pts = np.round(pts * scale).astype(np.int8)
    return pts.reshape(N_TESTS, 4)


@functools.lru_cache()
def _ic_angle_mask() -> np.ndarray:
    r = HALF_PATCH
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (xs * xs + ys * ys) <= r * r
    return np.stack([xs * mask, ys * mask]).astype(np.float32)


def ic_angles(img, uv, valid):
    """Intensity-centroid orientation [N] (radians) of keypoints uv [N, 2]."""
    from .image import extract_patches

    patches = extract_patches(img, uv, HALF_PATCH)            # [N, 31, 31]
    xy = torch.as_tensor(_ic_angle_mask(), device=img.device)
    m10 = (patches * xy[0][None]).sum((1, 2))
    m01 = (patches * xy[1][None]).sum((1, 2))
    ang = torch.atan2(m01, m10)
    return torch.where(valid, ang, torch.zeros_like(ang))


def brief_descriptors(img_blurred, uv, angles, valid):
    """Steered BRIEF: [N, 256] uint8 bits (0/1) on the blurred level."""
    H, W = img_blurred.shape
    pat = torch.as_tensor(brief_pattern(), dtype=torch.float32,
                          device=img_blurred.device)
    ca = torch.cos(angles)[:, None]
    sa = torch.sin(angles)[:, None]

    def rot(p):                                             # -> [N, 256, 2]
        x = p[None, :, 0] * ca - p[None, :, 1] * sa
        y = p[None, :, 0] * sa + p[None, :, 1] * ca
        return torch.stack([x, y], -1)

    def sample_nearest(q):
        xi = torch.clamp(torch.round(q[..., 0]).long(), 0, W - 1)
        yi = torch.clamp(torch.round(q[..., 1]).long(), 0, H - 1)
        return img_blurred.reshape(-1)[yi * W + xi]

    q1 = rot(pat[:, 0:2]) + uv[:, None, :]
    q2 = rot(pat[:, 2:4]) + uv[:, None, :]
    bits = (sample_nearest(q1) < sample_nearest(q2)).to(torch.uint8)
    return torch.where(valid[:, None], bits, torch.zeros_like(bits))
