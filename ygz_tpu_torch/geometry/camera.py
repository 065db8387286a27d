"""Pinhole camera with radial-tangential distortion, on torch tensors.

Port of ``ygz_tpu/geometry/camera.py``: intrinsics are Python floats, the
distortion an 8-vector [k1,k2,p1,p2,k3,k4,k5,k6] (float32 CPU tensor; the
functions move it to the input's device). Undistortion is a fixed
8-iteration fixed-point scheme, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    dist: torch.Tensor  # [8] radtan coefficients (float32, CPU)
    bf: float = 0.0     # stereo baseline * fx (0 for mono)

    @staticmethod
    def make(fx, fy, cx, cy, width, height, dist=None, bf=0.0):
        d = torch.zeros(8, dtype=torch.float32)
        if dist is not None:
            dist = torch.as_tensor(dist, dtype=torch.float32).reshape(-1)
            d[: dist.shape[0]] = dist
        return Camera(float(fx), float(fy), float(cx), float(cy),
                      int(width), int(height), d, float(bf))

    @property
    def K(self):
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    @property
    def has_distortion(self) -> bool:
        return bool(self.dist.abs().sum() > 0)


def distort_normalized(cam: Camera, xn):
    """Apply radtan distortion to normalized coords xn [..., 2]."""
    k1, k2, p1, p2, k3, k4, k5, k6 = cam.dist.to(xn.device).unbind()
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
              / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_normalized(cam: Camera, xd, iters: int = 8):
    x = xd
    for _ in range(iters):
        x = xd - (distort_normalized(cam, x) - x)
    return x


def _safe_inv_z(z):
    return 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, Xc):
    """Camera-frame points [..., 3] -> distorted pixels [..., 2]."""
    zi = _safe_inv_z(Xc[..., 2])
    xd = distort_normalized(
        cam, torch.stack([Xc[..., 0] * zi, Xc[..., 1] * zi], -1))
    return torch.stack([cam.fx * xd[..., 0] + cam.cx,
                        cam.fy * xd[..., 1] + cam.cy], -1)


def project_ideal(cam: Camera, Xc):
    zi = _safe_inv_z(Xc[..., 2])
    return torch.stack([cam.fx * Xc[..., 0] * zi + cam.cx,
                        cam.fy * Xc[..., 1] * zi + cam.cy], -1)


def unproject(cam: Camera, uv, depth=None):
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], -1)
    ray = torch.cat([xn, torch.ones_like(xn[..., :1])], -1)
    return ray if depth is None else ray * depth[..., None]


def undistort_points(cam: Camera, uv):
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], -1)
    xn = undistort_normalized(cam, xd)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx,
                        cam.fy * xn[..., 1] + cam.cy], -1)


def undistort_remap_grid(cam: Camera, device="cuda"):
    """(map_u, map_v) [H, W] source locations that produce the undistorted
    image (cv::initUndistortRectifyMap analog)."""
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=device),
        torch.arange(cam.width, dtype=torch.float32, device=device),
        indexing="ij")
    xn = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy], -1)
    xd = distort_normalized(cam, xn)
    return cam.fx * xd[..., 0] + cam.cx, cam.fy * xd[..., 1] + cam.cy


def scale_camera(cam: Camera, scale: float) -> Camera:
    """Camera for a pyramid level scaled by `scale` (< 1 shrinks)."""
    return Camera(cam.fx * scale, cam.fy * scale,
                  (cam.cx + 0.5) * scale - 0.5, (cam.cy + 0.5) * scale - 0.5,
                  int(round(cam.width * scale)),
                  int(round(cam.height * scale)), cam.dist, cam.bf * scale)
