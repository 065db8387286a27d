"""Batched linear (DLT) triangulation with cheirality/reprojection/parallax
gates. Port of ``ygz_tpu/geometry/triangulation.py``; every argument may
carry leading batch dimensions (the JAX package vmapped the two-view
hypothesis check over them)."""
from __future__ import annotations

import torch


def triangulate_dlt(P1, P2, uv1, uv2):
    """P1, P2 [..., 3, 4]; uv1, uv2 [..., N, 2] -> X [..., N, 3].

    The 4x4 normal equations A^T A are solved with a batched symmetric
    eigendecomposition (smallest eigenvector), as in the reference port."""
    def rows(P, uv):
        a = uv[..., 0:1] * P[..., None, 2, :] - P[..., None, 0, :]
        b = uv[..., 1:2] * P[..., None, 2, :] - P[..., None, 1, :]
        return a, b

    a1, b1 = rows(P1, uv1)
    a2, b2 = rows(P2, uv2)
    a1, b1, a2, b2 = torch.broadcast_tensors(a1, b1, a2, b2)
    A = torch.stack([a1, b1, a2, b2], -2)                 # [..., N, 4, 4]
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    Xh = vecs[..., 0]                                     # smallest eigvec
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def _xform(R, t, X):
    """(R [..., 3, 3], t [..., 3]) applied to X [..., N, 3]."""
    return X @ R.transpose(-1, -2) + t[..., None, :]


def triangulation_checks(R1, t1, R2, t2, X, uv1, uv2, fx, fy, cx, cy,
                         sigma2=1.0, reproj_chi2=4.0, min_parallax_cos=0.99998):
    """Positive depth in both views, reprojection chi2 below
    ``reproj_chi2 * sigma2`` in both, parallax above threshold.
    (R_i, t_i) map world -> camera i. Returns (good [..., N], cos [..., N])."""
    Xc1 = _xform(R1, t1, X)
    Xc2 = _xform(R2, t2, X)

    def reproj_err2(Xc, uv):
        z = Xc[..., 2]
        zi = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        du = fx * Xc[..., 0] * zi + cx - uv[..., 0]
        dv = fy * Xc[..., 1] * zi + cy - uv[..., 1]
        return du * du + dv * dv

    e1 = reproj_err2(Xc1, uv1)
    e2 = reproj_err2(Xc2, uv2)
    O1 = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    O2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    r1 = X - O1[..., None, :]
    r2 = X - O2[..., None, :]
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cosp = (r1 * r2).sum(-1) / torch.clamp(n1 * n2, min=1e-12)
    good = ((Xc1[..., 2] > 0.0) & (Xc2[..., 2] > 0.0)
            & (e1 < reproj_chi2 * sigma2) & (e2 < reproj_chi2 * sigma2)
            & (cosp < min_parallax_cos) & torch.isfinite(X).all(-1))
    return good, cosp
