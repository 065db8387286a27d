"""SO(3)/SE(3) Lie-group operations on torch tensors.

Port of ``ygz_tpu/geometry/lie.py``. Rotations are 3x3 matrices; tangent
vectors follow the Sophus convention ``xi = [upsilon (trans), omega (rot)]``.
Every function takes a leading batch (``[..., 3]`` / ``[..., 3, 3]``) in
place of the JAX package's vmap; the small-angle branches are
``torch.where`` on Taylor expansions, so nothing branches on data.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def hat(w):
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _sin_over_x(x2):
    x = torch.sqrt(torch.clamp(x2, min=0.0))
    small = x2 < _EPS
    return torch.where(small, 1.0 - x2 / 6.0,
                       torch.sin(x) / torch.where(small, torch.ones_like(x),
                                                  x))


def _one_minus_cos_over_x2(x2):
    x = torch.sqrt(torch.clamp(x2, min=0.0))
    small = x2 < _EPS
    return torch.where(small, 0.5 - x2 / 24.0,
                       (1.0 - torch.cos(x))
                       / torch.where(small, torch.ones_like(x2), x2))


def _x_minus_sin_over_x3(x2):
    x = torch.sqrt(torch.clamp(x2, min=0.0))
    small = x2 < _EPS
    return torch.where(small, 1.0 / 6.0 - x2 / 120.0,
                       (x - torch.sin(x))
                       / torch.where(small, torch.ones_like(x2), x2 * x))


def so3_exp(w):
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    return (_eye3(w) + _sin_over_x(theta2) * W
            + _one_minus_cos_over_x2(theta2) * (W @ W))


def so3_left_jacobian(w):
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    return (_eye3(w) + _one_minus_cos_over_x2(theta2) * W
            + _x_minus_sin_over_x3(theta2) * (W @ W))


def so3_log(R):
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (angles < pi - eps; the
    near-pi branch of the JAX version is kept)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = _sin_over_x(theta * theta)
    w_generic = v / torch.clamp(s, min=1e-12)[..., None]
    near_pi = (cos_t < -1.0 + 1e-5)[..., None]
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    axis_sq = torch.clamp(0.5 * (diag + 1.0), 0.0, 1.0)
    axis = torch.sqrt(axis_sq)
    k = torch.argmax(axis_sq, -1)[..., None]
    c0 = torch.stack([axis[..., 0], R[..., 0, 1], R[..., 0, 2]], -1)
    c1 = torch.stack([R[..., 0, 1], axis[..., 1], R[..., 1, 2]], -1)
    c2 = torch.stack([R[..., 0, 2], R[..., 1, 2], axis[..., 2]], -1)
    signs = torch.sign(torch.where(k == 0, c0, torch.where(k == 1, c1, c2)))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    w_pi = theta[..., None] * axis * signs
    return torch.where(near_pi, w_pi, w_generic)


def _left_jacobian_inv(w):
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    x = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    half = 0.5 * x
    cot_term = half * torch.cos(half) / torch.where(
        small, torch.ones_like(half), torch.sin(half))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - cot_term)
                       / torch.where(small, torch.ones_like(theta2), theta2))
    return _eye3(w) - 0.5 * W + coef * (W @ W)


def se3_exp(xi):
    """se(3) tangent [..., 6] = [upsilon, omega] -> (R [..., 3, 3],
    t [..., 3])."""
    u, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    return R, (V @ u[..., None])[..., 0]


def se3_log(R, t):
    w = so3_log(R)
    return torch.cat([(_left_jacobian_inv(w) @ t[..., None])[..., 0], w], -1)


def se3_mul(Ra, ta, Rb, tb):
    """Compose (Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta
