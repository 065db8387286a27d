"""Sim(3) operations + Horn closed-form similarity estimation.

Port of ``ygz_tpu/geometry/sim3.py``. Sim3 elements are (R [3,3], t [3],
s) acting as x -> s R x + t; every function takes leading batch dims in
place of the JAX package's vmap. The 7-DoF tangent is
xi = [upsilon(3), omega(3), sigma(1)] with a first-order retraction.

RANSAC draws its samples from an explicit ``torch.Generator`` (on its own
device: a CPU generator gives a CUDA caller the same hypotheses as a CPU
one), or takes them injected through ``samples=``.

``torch.linalg.svd``/``eigh`` raise on non-finite input on the CPU (and
check it with a host sync on CUDA); ``svd_finite``/``eigh_finite`` zero such
entries first, so a degenerate hypothesis scores no inliers instead of
raising.
"""
from __future__ import annotations

import torch

from .lie import _left_jacobian_inv, so3_exp, so3_left_jacobian, so3_log_safe
from .twoview import draw_samples


def _finite(A):
    return torch.where(torch.isfinite(A), A, torch.zeros_like(A))


def svd_finite(A, full_matrices=True):
    """Batched SVD (U, S, Vh) with non-finite entries zeroed first."""
    return torch.linalg.svd(_finite(A), full_matrices=full_matrices)


def eigh_finite(A):
    """Batched symmetric eigh (ascending w, V) with non-finite entries
    zeroed first."""
    return torch.linalg.eigh(_finite(A))


def _as(s, ref):
    return torch.as_tensor(s, dtype=ref.dtype, device=ref.device)


def sim3_apply(R, t, s, X):
    """s R X + t for X [..., N, 3]."""
    s = _as(s, X)
    return s[..., None, None] * (X @ R.transpose(-1, -2)) + t[..., None, :]


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    """(a * b)(x) = a(b(x)) = sa Ra (sb Rb x + tb) + ta."""
    sa, sb = _as(sa, ta), _as(sb, tb)
    return (Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta,
            sa * sb)


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    si = torch.reciprocal(_as(s, t))
    return Rt, -si[..., None] * (Rt @ t[..., None])[..., 0], si


def sim3_exp(xi):
    """First-order-consistent exp: [..., 7] = [u, w, sigma] -> (R, t, s)."""
    u, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = so3_left_jacobian(w)  # scale-coupling terms dropped (1st order)
    return so3_exp(w), (V @ u[..., None])[..., 0], torch.exp(sigma)


def sim3_log(R, t, s):
    w = so3_log_safe(R)
    u = (_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([u, w, torch.log(_as(s, t))[..., None]], -1)


def horn_sim3(Xa, Xb, mask, with_scale=True):
    """Closed-form similarity aligning Xa -> Xb: (R, t, s) minimizing
    ||s R Xa + t - Xb|| over masked rows (Sim3Solver::ComputeSim3's Horn
    method). Xa, Xb [..., N, 3], mask [..., N]."""
    w = mask.to(Xa.dtype)[..., None]
    n = torch.clamp(w.sum((-2, -1)), min=1.0)
    mu_a = (Xa * w).sum(-2) / n[..., None]
    mu_b = (Xb * w).sum(-2) / n[..., None]
    ac = (Xa - mu_a[..., None, :]) * w
    bc = (Xb - mu_b[..., None, :]) * w
    H = bc.transpose(-1, -2) @ ac / n[..., None, None]
    # the SVD's signs differ between libraries; R, t and s do not
    U, S, Vh = svd_finite(H)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vh))
    one = torch.ones_like(d)
    Dg = torch.stack([one, one, d], -1)
    R = U @ torch.diag_embed(Dg) @ Vh
    if with_scale:
        var_a = (ac * ac).sum((-2, -1)) / n
        s = (S * Dg).sum(-1) / torch.clamp(var_a, min=1e-12)
    else:
        s = torch.ones_like(n)
    t = mu_b - s[..., None] * (R @ mu_a[..., None])[..., 0]
    return R, t, s


def sim3_ransac(Xa, Xb, mask, generator=None, num_iters=300,
                uv_a=None, uv_b=None, proj_a=None, proj_b=None,
                th_a=9.21, th_b=9.21, with_scale=True, samples=None):
    """RANSAC over 3-point Horn hypotheses (Sim3Solver semantics: inliers by
    reprojection error in both frames when projections are given, else by
    3-D distance), then a Horn refit on the best inlier set.

    proj_a/proj_b: optional callables X [..., N, 3] -> uv [..., N, 2].
    samples: optional [S, 3] injected index sets. Returns (R, t, s,
    inliers [N] bool, n_inliers)."""
    if samples is None:
        samples = draw_samples(mask, num_iters, 3, generator)
    idx = samples.to(Xa.device).long()
    Rs, ts, ss = horn_sim3(Xa[idx], Xb[idx],
                           torch.ones(idx.shape, dtype=torch.bool,
                                      device=Xa.device), with_scale)

    def score(R, t, s):
        if proj_a is not None and uv_a is not None:
            Ri, ti, si = sim3_inv(R, t, s)
            ea = uv_a - proj_a(sim3_apply(Ri, ti, si, Xb))
            eb = uv_b - proj_b(sim3_apply(R, t, s, Xa))
            inl = (((ea * ea).sum(-1) < th_a) & ((eb * eb).sum(-1) < th_b)
                   & mask)
        else:
            e = sim3_apply(R, t, s, Xa) - Xb
            inl = ((e * e).sum(-1) < th_b) & mask
        return inl.sum(-1), inl

    counts, inls = score(Rs, ts, ss)
    best = torch.argmax(counts)
    R, t, s = horn_sim3(Xa, Xb, inls[best], with_scale)
    n_i, inl = score(R, t, s)
    return R, t, s, inl, n_i
