"""Batched Gauss-Newton / Levenberg-Marquardt optimizers for SLAM.

Port of ``ygz_tpu/backend/optim.py``: problems are fixed-capacity arrays of
residual blocks; local BA eliminates landmarks with a dense-block Schur
complement. ``lax.fori_loop``/``lax.scan`` become Python loops with the
same fixed iteration counts (no data-dependent exit: on the card one would
sync the host every iteration), vmaps become an explicit batch dimension,
``jax.ops.segment_sum`` becomes ``segment_sum`` below (a fixed summation
order on the card, so a run repeats bit for bit).

Constants follow the reference (Optimizer::PoseOptimization: 4 rounds x 10
iterations, chi2 gate 5.991 mono, Huber in the first two rounds;
LocalBundleAdjustment: 5 iterations, outlier drop, 10 more).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.lie import se3_exp, se3_mul

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _reproj_residual_jac3(R, t, X, uv, ur, bf, fx, fy, cx, cy):
    """Batched stereo-capable reprojection residual with rows (u, v, u_r),
    u_r = u - bf/z; observations with ur < 0 are monocular (third row 0).
    R [N, 3, 3] or [3, 3], t [N, 3] or [3], X [N, 3], uv [N, 2], ur [N].
    Pose perturbation is LEFT-multiplicative: dXc/dxi = [I | -Xc^].
    Returns r [N, 3], A [N, 3, 6] (pose), B [N, 3, 3] (point), z [N]."""
    Xc = (R @ X[..., None])[..., 0] + t
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    has = (ur >= 0).to(torch.float32)
    r = torch.stack([u - uv[:, 0], v - uv[:, 1], has * (u - bf * zi - ur)], 1)
    zero = 0.0 * zi
    row_u = torch.stack([fx * zi, zero, -fx * x * zi * zi], 1)
    row_v = torch.stack([zero, fy * zi, -fy * y * zi * zi], 1)
    row_r = (row_u + torch.stack([zero, zero, bf * zi * zi], 1)) * has[:, None]
    dpi = torch.stack([row_u, row_v, row_r], 1)               # [N, 3, 3]
    zz = 0.0 * z
    Xhat = torch.stack([torch.stack([zz, -z, y], 1),
                        torch.stack([z, zz, -x], 1),
                        torch.stack([-y, x, zz], 1)], 1)
    A = torch.cat([dpi, -(dpi @ Xhat)], 2)                    # [N, 3, 6]
    B = dpi @ R                                               # [N, 3, 3]
    return r, A, B, z


def _reproj_residual_jac(R, t, X, uv, fx, fy, cx, cy):
    """Monocular rows of _reproj_residual_jac3: r [N, 2], A [N, 2, 6],
    B [N, 2, 3], z [N]."""
    ur = torch.full(X.shape[:1], -1.0, dtype=X.dtype, device=X.device)
    r, A, B, z = _reproj_residual_jac3(R, t, X, uv, ur, 0.0, fx, fy, cx, cy)
    return r[:, :2], A[:, :2], B[:, :2], z


# ---- robust weights (reference include/RobustCost.h; production call
# sites use Huber)
TUKEY_B2 = 4.6851 ** 2
TDIST_DOF = 5.0


def _huber_weight(chi2, delta2):
    """Huber IRLS weight as a function of the squared error."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def tukey_weight(chi2, b2=TUKEY_B2):
    """Tukey biweight: (1 - chi2/b^2)^2 inside, 0 outside."""
    x = 1.0 - chi2 / b2
    return torch.where(chi2 <= b2, x * x, torch.zeros_like(chi2))


def tdist_weight(chi2, dof=TDIST_DOF):
    """Student-t IRLS weight: (dof + 1) / (dof + chi2)."""
    return (dof + 1.0) / (dof + chi2)


def robust_weight(chi2, kind: str = "huber", delta2=CHI2_MONO):
    """IRLS weight by kernel name ('unit' | 'huber' | 'tukey' | 'tdist')."""
    if kind == "unit":
        return torch.ones_like(chi2)
    if kind == "huber":
        return _huber_weight(chi2, delta2)
    if kind == "tukey":
        return tukey_weight(chi2, delta2 if delta2 else TUKEY_B2)
    if kind == "tdist":
        return tdist_weight(chi2)
    raise ValueError(f"unknown robust kernel: {kind}")


def solve_preconditioned(H, b):
    """Solve H x = b with symmetric Jacobi scaling (keeps float32 solves of
    normal equations whose entries span ~1e0..1e10 accurate)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H / (d[:, None] * d[None, :])
    # solve_ex: no host sync on the info check; a singular system gives
    # non-finite steps, as the reference's solve does
    return torch.linalg.solve_ex(Hs, b / d).result / d


def segment_sum(x, ids, n: int):
    """jax.ops.segment_sum: the rows of x summed into n segments by ids.
    On the card it is the accumulating ``index_put_``, which sorts the ids
    and sums each segment in that fixed order, so a run repeats bit for
    bit; ``index_add_`` there adds atomically in arrival order, which
    varies from run to run. On the CPU ``index_add_`` sums in row order."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.device.type == "cuda":
        return out.index_put_((ids.long(),), x, accumulate=True)
    return out.index_add_(0, ids, x)


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor
    chi2: torch.Tensor      # [N] final per-obs chi2


def pose_optimization(X, uv, inv_sigma2, valid, R0, t0, intr,
                      rounds: int = 4, iters_per_round: int = 10,
                      chi2_th: float = CHI2_MONO, ur=None, bf=0.0):
    """Pose-only batched GN with staged outlier gating.

    X [N, 3] world points; uv [N, 2]; inv_sigma2 [N]; valid [N];
    (R0, t0) world->cam. ur: optional [N] right-image u (-1 = mono)."""
    fx, fy, cx, cy = intr
    N = X.shape[0]
    if ur is None:
        ur = torch.full((N,), -1.0, dtype=torch.float32, device=X.device)
    th_obs = torch.where(ur >= 0,
                         torch.full_like(ur, CHI2_STEREO * chi2_th / CHI2_MONO),
                         torch.full_like(ur, chi2_th))
    eye6 = torch.eye(6, dtype=torch.float32, device=X.device)

    def rj(R, t):
        return _reproj_residual_jac3(R, t, X, uv, ur, bf, fx, fy, cx, cy)

    def chi2_of(R, t):
        r, _, _, z = rj(R, t)
        return (r * r).sum(1) * inv_sigma2, z

    R, t = R0, t0
    inliers = valid
    for rd in range(rounds):
        use_huber = rd < rounds - 2   # last two rounds: plain LSQ on inliers
        for _ in range(iters_per_round):
            r, A, _, z = rj(R, t)
            c2 = (r * r).sum(1) * inv_sigma2
            w = inv_sigma2 * inliers.to(torch.float32) * (z > 0.0)
            if use_huber:
                w = w * _huber_weight(c2, th_obs)
            Aw = A * w[:, None, None]
            H = torch.einsum("nai,naj->ij", Aw, A)
            b = torch.einsum("nai,na->i", Aw, r)
            H = H + 1e-8 * torch.trace(H) / 6.0 * eye6
            Rd, td = se3_exp(-solve_preconditioned(H, b))
            R, t = se3_mul(Rd, td, R, t)
        c2, z = chi2_of(R, t)
        inliers = valid & (c2 < th_obs) & (z > 0.0)
    c2, _ = chi2_of(R, t)
    return PoseOptResult(R=R, t=t, inliers=inliers, n_inliers=inliers.sum(),
                         chi2=c2)


class BAResult(NamedTuple):
    kf_R: torch.Tensor       # [P, 3, 3]
    kf_t: torch.Tensor       # [P, 3]
    points: torch.Tensor     # [L, 3]
    obs_inlier: torch.Tensor  # [O] bool
    total_chi2: torch.Tensor


def local_bundle_adjustment(kf_R, kf_t, fixed, points, pt_valid,
                            obs_p, obs_l, obs_uv, obs_inv_sigma2, obs_valid,
                            intr, n_poses: int, n_points: int,
                            phases=(5, 10), chi2_th: float = CHI2_MONO,
                            damping: float = 1e-3, obs_ur=None, bf=0.0):
    """Local BA: joint poses + points LM with a Schur complement.

    kf_R/kf_t [P] world->cam poses; fixed [P] bool anchors; points [L, 3];
    obs_* [O] observation table (pose idx, point idx, pixel, information,
    validity). Between phases, observations above the chi2 gate drop."""
    fx, fy, cx, cy = intr
    P, L = n_poses, n_points
    dev = points.device
    f32 = torch.float32
    O = obs_p.shape[0]
    if obs_ur is None:
        obs_ur = torch.full((O,), -1.0, dtype=f32, device=dev)
    th_obs = torch.where(
        obs_ur >= 0, torch.full_like(obs_ur, CHI2_STEREO * chi2_th / CHI2_MONO),
        torch.full_like(obs_ur, chi2_th))
    free = (~fixed).to(f32)
    obs_p = obs_p.long()
    obs_l = obs_l.long()
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    diag = torch.arange(P, device=dev)
    fm = free[:, None]

    def rj(kf_R, kf_t, points):
        return _reproj_residual_jac3(kf_R[obs_p], kf_t[obs_p], points[obs_l],
                                     obs_uv, obs_ur, bf, fx, fy, cx, cy)

    def chi2_all(kf_R, kf_t, points):
        r, _, _, z = rj(kf_R, kf_t, points)
        return (r * r).sum(1) * obs_inv_sigma2, z

    def block_diag(blocks):                      # [P, 6, 6] -> [P, 6, P, 6]
        D = torch.zeros(P, 6, P, 6, dtype=f32, device=dev)
        D[diag, :, diag, :] = blocks
        return D

    def one_iter(kf_R, kf_t, points, inlier, lam):
        r, A, B, z = rj(kf_R, kf_t, points)
        c2 = (r * r).sum(1) * obs_inv_sigma2
        w = (obs_inv_sigma2 * inlier.to(f32) * (z > 0.0)
             * _huber_weight(c2, th_obs))
        Aw = A * w[:, None, None]
        Bw = B * w[:, None, None]
        U = segment_sum(Aw.transpose(1, 2) @ A, obs_p, P)
        V = segment_sum(Bw.transpose(1, 2) @ B, obs_l, L)
        Wb = Aw.transpose(1, 2) @ B                               # [O, 6, 3]
        bp = -segment_sum((Aw.transpose(1, 2) @ r[..., None])[..., 0],
                          obs_p, P)
        bl = -segment_sum((Bw.transpose(1, 2) @ r[..., None])[..., 0],
                          obs_l, L)

        Vinv = torch.linalg.inv_ex(V + lam * eye3[None]).inverse
        M = segment_sum(Wb, obs_l * P + obs_p, L * P).reshape(L, P, 6, 3)
        T_ = torch.einsum("lpik,lkm->lpim", M, Vinv)              # [L,P,6,3]
        S = -torch.einsum("lpim,lqjm->piqj", T_, M)               # [P,6,P,6]
        S = S + block_diag(U + lam * eye6[None])
        g = bp - torch.einsum("lpim,lm->pi", T_, bl)
        # gauge / fixed poses: zero their rows and cols, identity diagonal
        S = S * fm[:, :, None, None] * fm[None, None, :, :]
        S = S + block_diag((1.0 - free)[:, None, None] * eye6[None])
        g = g * fm
        dp = solve_preconditioned(S.reshape(P * 6, P * 6),
                                  g.reshape(P * 6)).reshape(P, 6) * fm
        rhs = bl - torch.einsum("lpim,pi->lm", M, dp)
        dl = (Vinv @ rhs[..., None])[..., 0] * pt_valid[:, None]

        Rd, td = se3_exp(dp)
        newR, newt = se3_mul(Rd, td, kf_R, kf_t)
        newpts = points + dl
        old_c2, _ = chi2_all(kf_R, kf_t, points)
        new_c2, _ = chi2_all(newR, newt, newpts)
        wsel = inlier.to(f32)
        accept = (new_c2 * wsel).sum() < (old_c2 * wsel).sum()
        kf_R = torch.where(accept, newR, kf_R)
        kf_t = torch.where(accept, newt, kf_t)
        points = torch.where(accept, newpts, points)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-6, 1e3)
        return kf_R, kf_t, points, lam

    inlier = obs_valid & pt_valid[obs_l]
    lam = torch.tensor(damping, dtype=f32, device=dev)
    for it_count in phases:
        for _ in range(it_count):
            kf_R, kf_t, points, lam = one_iter(kf_R, kf_t, points, inlier,
                                               lam)
        c2, z = chi2_all(kf_R, kf_t, points)
        inlier = inlier & (c2 < th_obs) & (z > 0.0)
    c2, _ = chi2_all(kf_R, kf_t, points)
    total = torch.where(inlier, c2, torch.zeros_like(c2)).sum()
    return BAResult(kf_R=kf_R, kf_t=kf_t, points=points, obs_inlier=inlier,
                    total_chi2=total)
