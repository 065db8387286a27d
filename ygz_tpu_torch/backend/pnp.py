"""Robust PnP for relocalization: batched EPnP RANSAC + GN polish.

Port of ``ygz_tpu/backend/pnp.py`` (the reference's EPnP + RANSAC,
PnPsolver.cc, used only by relocalization). All RANSAC hypotheses are
solved at once: the solvers take a leading batch dim [S, k, ...] where the
JAX package vmapped them, every hypothesis is scored against every
correspondence in one broadcast, and the winner is polished by the pose GN
(``backend/optim.py::pose_optimization``).

Degenerate samples (collinear or repeated points) give singular systems:
the eigen-solves and SVDs zero non-finite entries first (``eigh`` has no
``_ex`` form and raises on them), the inverses use ``inv_ex``, and the
least-squares solves use the SVD pseudo-inverse (XLA's lstsq is SVD-based;
torch's CUDA lstsq assumes full rank). A degenerate hypothesis then scores
few or no inliers and loses, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .optim import CHI2_MONO, pose_optimization
from ..geometry.sim3 import eigh_finite, svd_finite
from ..geometry.twoview import draw_samples


class PnPResult(NamedTuple):
    ok: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _diag3(d):
    one = torch.ones_like(d)
    return torch.diag_embed(torch.stack([one, one, d], -1))


def _proper(M):
    """Nearest rotation U diag(1, 1, det(U Vh)) Vh of M [..., 3, 3]."""
    U, S, Vh = svd_finite(M)
    det = torch.linalg.det(U @ Vh)
    return U @ _diag3(det) @ Vh, S, det


def _dlt_pose(X, uvn):
    """Linear PnP from k >= 6 points: X [..., k, 3] world, uvn [..., k, 2]
    normalized image coords. Returns (R [..., 3, 3], t [..., 3])."""
    zeros = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    r1 = torch.cat([Xh, zeros, -uvn[..., 0:1] * Xh], -1)
    r2 = torch.cat([zeros, Xh, -uvn[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                              # [..., 2k, 12]
    _, V = eigh_finite(A.transpose(-1, -2) @ A)
    p = V[..., :, 0].reshape(V.shape[:-2] + (3, 4))
    # orthonormalize + resolve scale/sign (points must be in front)
    R, S, det = _proper(p[..., :3])
    scale = S.sum(-1) / 3.0 * det                 # signed mean singular value
    scale = torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12),
                        scale)
    t = p[..., 3] / scale[..., None]
    z = (X @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    flip = (torch.sign(z).sum(-1) < 0)[..., None]
    R = torch.where(flip[..., None], -R, R)
    t = torch.where(flip, -t, t)
    # restore a proper rotation if flipped (det(-R) = -det(R))
    R, _, _ = _proper(R)
    return R, t


def _kabsch(Xw, Xc):
    """Rigid (R, t) with Xc ~= R Xw + t (least squares), batched."""
    cw = Xw.mean(-2)
    cc = Xc.mean(-2)
    H = (Xw - cw[..., None, :]).transpose(-1, -2) @ (Xc - cc[..., None, :])
    U, _, Vh = svd_finite(H)
    Ut, V = U.transpose(-1, -2), Vh.transpose(-1, -2)
    R = V @ _diag3(torch.linalg.det(V @ Ut)) @ Ut
    return R, cc - (R @ cw[..., None])[..., 0]


def _refine_betas(b1, b2, dv1, dv2, dw2, iters=5):
    """Gauss-Newton on (b1, b2): min sum_k (|b1 dv1 + b2 dv2|^2 - dw2)^2."""
    eye2 = torch.eye(2, dtype=dv1.dtype, device=dv1.device)
    for _ in range(iters):
        d = b1[..., None, None] * dv1 + b2[..., None, None] * dv2
        r = (d * d).sum(-1) - dw2
        J = torch.stack([2.0 * (d * dv1).sum(-1), 2.0 * (d * dv2).sum(-1)],
                        -1)                                   # [..., n, 2]
        H = J.transpose(-1, -2) @ J + 1e-9 * eye2
        db = torch.linalg.solve_ex(H, J.transpose(-1, -2)
                                   @ r[..., None]).result[..., 0]
        b1, b2 = b1 - db[..., 0], b2 - db[..., 1]
    return b1, b2


def _betas(v1, v2, Cw, ia, ib):
    """The two beta estimates of EPnP: the N=1 closed form and the N=2
    least-squares one, each GN-refined. Returns [(b1, b2), (b1, b2)]."""
    dw2 = ((Cw[..., ia, :] - Cw[..., ib, :]) ** 2).sum(-1)
    dv1 = v1[..., ia, :] - v1[..., ib, :]
    dv2 = v2[..., ia, :] - v2[..., ib, :]
    n1 = (dv1 * dv1).sum(-1)
    b1a = (torch.sqrt(n1 * dw2).sum(-1)
           / torch.clamp(n1.sum(-1), min=1e-12))
    a = _refine_betas(b1a, torch.zeros_like(b1a), dv1, dv2, dw2)
    L = torch.stack([n1, 2.0 * (dv1 * dv2).sum(-1), (dv2 * dv2).sum(-1)], -1)
    bb = (_pinv(L) @ dw2[..., None])[..., 0]
    b1b = torch.sqrt(bb[..., 0].abs())
    b2b = torch.sqrt(bb[..., 2].abs()) * torch.sign(bb[..., 1]) \
        * torch.sign(bb[..., 0])
    return [a, _refine_betas(b1b, b2b, dv1, dv2, dw2)]


def _pinv(A):
    """SVD pseudo-inverse (numpy's / XLA's lstsq cutoff eps * max(m, n))."""
    U, S, Vh = svd_finite(A, full_matrices=False)
    keep = S >= torch.finfo(A.dtype).eps * max(A.shape[-2:]) * S[..., :1]
    Si = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                     torch.zeros_like(S))
    return Vh.transpose(-1, -2) @ (Si[..., None] * U.transpose(-1, -2))


def _pose_from(b, v1, v2, alph, X, u, v):
    """Camera-frame points from the betas -> Kabsch pose and its sample
    reprojection error."""
    b1, b2 = b
    Cc = b1[..., None, None] * v1 + b2[..., None, None] * v2
    Xc = alph @ Cc
    # cheirality: the nullspace sign is arbitrary
    flip = (torch.sign(Xc[..., 2]).sum(-1) < 0)[..., None, None]
    Xc = torch.where(flip, -Xc, Xc)
    R, t = _kabsch(X, Xc)
    Xp = X @ R.transpose(-1, -2) + t[..., None, :]
    zi = 1.0 / torch.clamp(Xp[..., 2], min=1e-6)
    err = ((Xp[..., 0] * zi - u) ** 2 + (Xp[..., 1] * zi - v) ** 2).sum(-1)
    return R, t, err


def _best_of(cands):
    (R1, t1, e1), (R2, t2, e2) = cands
    better = e2 < e1
    return (torch.where(better[..., None, None], R2, R1),
            torch.where(better[..., None], t2, t1), torch.minimum(e1, e2))


def _m_matrix(alph, u, v):
    """EPnP's [2s, 3c] M matrix from barycentrics alph [..., s, c]."""
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    c = alph.shape[-1]
    M1 = alph[..., :, :, None] * torch.stack([one, zero, -u], -1)[..., None, :]
    M2 = alph[..., :, :, None] * torch.stack([zero, one, -v], -1)[..., None, :]
    s = alph.shape[-2]
    return torch.cat([M1.reshape(M1.shape[:-3] + (s, 3 * c)),
                      M2.reshape(M2.shape[:-3] + (s, 3 * c))], -2)


_PAIRS_A = [0, 0, 0, 1, 1, 2]
_PAIRS_B = [1, 2, 3, 2, 3, 3]


def _epnp_pose(X, uvn):
    """Control-point EPnP from s >= 4 points (the reference PnPsolver's
    algorithm: PCA control points, barycentrics, the M nullspace, betas by
    the N=1 and N=2 cases + GN). X [..., s, 3], uvn [..., s, 2]. Returns
    (R, t, sample reprojection error)."""
    s = X.shape[-2]
    c0 = X.mean(-2)
    A = X - c0[..., None, :]
    w, E = eigh_finite(A.transpose(-1, -2) @ A / s)        # ascending
    sig = torch.sqrt(torch.clamp(w, min=1e-10))
    Cw = torch.cat([c0[..., None, :],
                    c0[..., None, :] + sig[..., :, None]
                    * E.transpose(-1, -2)], -2)               # [..., 4, 3]
    Cmat = torch.cat([Cw.transpose(-1, -2),
                      X.new_ones(Cw.shape[:-2] + (1, 4))], -2)  # [..., 4, 4]
    eye4 = torch.eye(4, dtype=X.dtype, device=X.device)
    # ridge keeps near-planar samples solvable (the 4th axis degenerates)
    Cinv = torch.linalg.inv_ex(Cmat + 1e-8 * eye4).inverse
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    alph = Xh @ Cinv.transpose(-1, -2)                        # [..., s, 4]
    u, v = uvn[..., 0], uvn[..., 1]
    M = _m_matrix(alph, u, v)
    _, V = eigh_finite(M.transpose(-1, -2) @ M)
    v1 = V[..., :, 0].reshape(V.shape[:-2] + (4, 3))
    v2 = V[..., :, 1].reshape(V.shape[:-2] + (4, 3))
    return _best_of([_pose_from(b, v1, v2, alph, X, u, v)
                     for b in _betas(v1, v2, Cw, _PAIRS_A, _PAIRS_B)])


def _epnp_planar(X, uvn):
    """3-control-point EPnP for (near-)planar samples: centroid + the two
    in-plane principal axes, 9-dim nullspace. Returns (R, t, sample
    reprojection error)."""
    s = X.shape[-2]
    c0 = X.mean(-2)
    A = X - c0[..., None, :]
    w, E = eigh_finite(A.transpose(-1, -2) @ A / s)        # ascending
    sig = torch.sqrt(torch.clamp(w, min=1e-10))
    # the two largest (in-plane) axes
    Cw = torch.stack([c0, c0 + sig[..., 2, None] * E[..., :, 2],
                      c0 + sig[..., 1, None] * E[..., :, 1]], -2)  # [..., 3, 3]
    Cmat = torch.cat([Cw.transpose(-1, -2),
                      X.new_ones(Cw.shape[:-2] + (1, 3))], -2)  # [..., 4, 3]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)      # [..., s, 4]
    alph = (_pinv(Cmat) @ Xh.transpose(-1, -2)).transpose(-1, -2)
    u, v = uvn[..., 0], uvn[..., 1]
    M = _m_matrix(alph, u, v)
    _, V = eigh_finite(M.transpose(-1, -2) @ M)
    v1 = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    v2 = V[..., :, 1].reshape(V.shape[:-2] + (3, 3))
    return _best_of([_pose_from(b, v1, v2, alph, X, u, v)
                     for b in _betas(v1, v2, Cw, [0, 0, 1], [1, 2, 2])])


def _epnp_best(X, uvn):
    """General + planar EPnP, the winner by sample reprojection error."""
    R4, t4, e4 = _epnp_pose(X, uvn)
    R3, t3, e3 = _epnp_planar(X, uvn)
    use3 = e3 < e4
    return (torch.where(use3[..., None, None], R3, R4),
            torch.where(use3[..., None], t3, t4))


def pnp_ransac(X, uv, valid, intr, generator=None, num_iters: int = 300,
               min_inliers: int = 10, chi2: float = CHI2_MONO,
               inv_sigma2=None, min_set: int = 4, samples=None):
    """Robust PnP. X [N, 3] world points, uv [N, 2] pixel observations,
    valid [N]. The reference's relocalization parameters: EPnP on 4-point
    minimal sets (min_set=4); the 6-point DLT with min_set >= 6.

    The hypotheses' index sets are drawn from ``generator`` (a CPU
    generator draws the same sets for a CUDA caller) or injected as
    ``samples`` [num_iters, min_set]."""
    fx, fy, cx, cy = intr
    N = X.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = torch.ones(N, dtype=X.dtype, device=X.device)
    uvn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    if samples is None:
        samples = draw_samples(valid, num_iters, min_set, generator)
    idx = samples.to(X.device).long()
    solver = _epnp_best if min_set < 6 else _dlt_pose
    Rs, ts = solver(X[idx], uvn[idx])                         # [S, 3, 3]

    Xc = X @ Rs.transpose(-1, -2) + ts[:, None, :]            # [S, N, 3]
    zi = 1.0 / torch.clamp(Xc[..., 2], min=1e-6)
    e2 = (((fx * Xc[..., 0] * zi + cx - uv[:, 0]) ** 2
           + (fy * Xc[..., 1] * zi + cy - uv[:, 1]) ** 2) * inv_sigma2)
    inl = valid & (e2 < chi2) & (Xc[..., 2] > 0)
    best = torch.argmax(inl.sum(-1))
    res = pose_optimization(X, uv, inv_sigma2, valid, Rs[best], ts[best],
                            intr, chi2_th=chi2)
    return PnPResult(ok=res.n_inliers >= min_inliers, R=res.R, t=res.t,
                     inliers=res.inliers, n_inliers=res.n_inliers)
