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


def _sqrt_big(x2, small):
    # sqrt where the Taylor branch is not taken; 1 under it, so that
    # reverse-mode gradients through the unused branch stay finite
    return torch.sqrt(torch.where(small, torch.ones_like(x2), x2))


def _sin_over_x(x2):
    small = x2 < _EPS
    x = _sqrt_big(x2, small)
    return torch.where(small, 1.0 - x2 / 6.0, torch.sin(x) / x)


def _one_minus_cos_over_x2(x2):
    small = x2 < _EPS
    x = _sqrt_big(x2, small)
    return torch.where(small, 0.5 - x2 / 24.0,
                       (1.0 - torch.cos(x))
                       / torch.where(small, torch.ones_like(x2), x2))


def _x_minus_sin_over_x3(x2):
    small = x2 < _EPS
    x = _sqrt_big(x2, small)
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


def so3_right_jacobian(w):
    """Right Jacobian J_r of SO(3) = J_l(-w) (IMU preintegration)."""
    return so3_left_jacobian(-w)


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


def so3_log_safe(R, tiny=1e-12):
    """SO(3) log through theta = atan2(|vee|, (tr - 1) / 2) with a smoothed
    norm: exact away from 0 and pi, and differentiable at the identity,
    where the arccos form of so3_log has an infinite derivative (pose-graph
    residuals vanish there)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    s = torch.sqrt((v * v).sum(-1) + tiny)
    return v * (torch.atan2(s, c) / s)[..., None]


def so3_right_jacobian_inv(w):
    """Inverse of the right Jacobian J_r of SO(3)."""
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    small = theta2 < _EPS
    x = _sqrt_big(theta2, small)
    one = torch.ones_like(theta2)
    # 1/x^2 - (1 + cos x)/(2 x sin x), Taylor: 1/12 + x^2/720
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       1.0 / torch.where(small, one, theta2)
                       - (1.0 + torch.cos(x))
                       / torch.where(small, one, 2.0 * x * torch.sin(x)))
    return _eye3(w) + 0.5 * W + coef * (W @ W)


def _left_jacobian_inv(w):
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    small = theta2 < _EPS
    half = 0.5 * _sqrt_big(theta2, small)
    cot_term = half * torch.cos(half) / torch.sin(half)
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


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, X):
    """Apply the transform (R [3, 3], t [3]) to points X [..., 3]."""
    return X @ R.T + t


def se3_matrix(R, t):
    """(R [..., 3, 3], t [..., 3]) -> homogeneous [..., 4, 4]."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


# ---------------------------------------------------------------------------
# Quaternions (storage / trajectory IO; TUM rows are [x y z qx qy qz qw])

def rotmat_to_quat(R):
    """[..., 3, 3] -> unit quaternion [..., 4] = [w, x, y, z] (Shepperd's
    method: the four constructions, picked by the largest pivot with
    where, so nothing branches on data). Any float dtype."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    k = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)[..., None]
    q = torch.where(k == 0, q0, torch.where(k == 1, q1,
                                            torch.where(k == 2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """Quaternion [..., 4] = [w, x, y, z] -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)
