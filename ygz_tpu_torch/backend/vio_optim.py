"""Visual-inertial NavState optimizers with a marginalized prior.

Port of ``ygz_tpu/backend/vio_optim.py`` (the reference's
Optimizer::PoseOptimization(Frame, Frame|KeyFrame, preint, gw, marg) and
LocalBundleAdjustmentNavState, IMU factor src/IMU/g2otypes.cpp:6-199):

  * ``vio_pose_optimization`` — one free 15-DoF NavState against a FIXED
    previous state (IMU preintegration factor + bias random walk +
    reprojection + optional prior);
  * ``vio_pose_optimization_pair`` — both NavStates free, a 15x15 prior on
    the previous one, reprojection on both frames, the previous state
    Schur-marginalized out after convergence into the next frame's prior;
  * ``vio_window_ba`` — a keyframe chain of NavStates and its landmarks,
    dense Schur over [W, 15] poses and [L, 3] points, chi2-gated steps.

Jacobians: the reprojection rows are analytic (the body pose enters
through Rcb / tcb; only the P and Phi columns are non-zero). The IMU, bias
and prior rows come from one reverse-mode pass per Gauss-Newton step over
copies of the residual, one copy per row (``_jac_rows``), where the JAX
package takes ``jax.jacfwd``: forward mode costs seconds at its first use
on CUDA. ``fori_loop``/``scan`` become Python loops with the same fixed
iteration counts; ``segment_sum`` becomes ``index_add_``. Cholesky,
inverse and solve take their ``_ex`` forms: a matrix they cannot factor
gives NaN, as in JAX, instead of an exception.

The frame optimizers form their 15x15 / 30x30 normal equations, the
solve and the Schur marginal in float64 from the float32 residuals and
Jacobians. Without a prior the pair system's velocity / accelerometer-bias
directions are nearly free: after Jacobi scaling its condition number
reaches ~1e8 on a 20 fps frame pair, beyond float32, where J^T J and the
solve turn those directions into rounding noise that the Gauss-Newton
iterations amplify (both packages diverge on such a pair in float32,
depending on the order of their sums).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.lie import hat, so3_exp, so3_log_safe
from ..geometry.sim3 import eigh_finite
from ..imu.preintegration import ACC_BIAS_RW2, GYR_BIAS_RW2, PreintState
from .optim import CHI2_MONO, _huber_weight, solve_preconditioned

HUBER2_PVR = 21.666    # 0.99 chi2, 9 DoF
HUBER2_BIAS = 16.812   # 6 DoF
HUBER2_PRIOR = 30.5779  # 15 DoF


class VioPoseResult(NamedTuple):
    P: torch.Tensor
    V: torch.Tensor
    R: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    marg_info: torch.Tensor  # [15, 15] posterior information = next prior


class VioPairResult(NamedTuple):
    P: torch.Tensor          # current-frame NavState (optimized)
    V: torch.Tensor
    R: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor    # [N] current-frame reprojection inliers
    n_inliers: torch.Tensor
    prior_mean: tuple        # next frame's prior mean = optimized cur state
    prior_info: torch.Tensor  # [15, 15] marginalized information for cur


class VioBAResult(NamedTuple):
    P: torch.Tensor     # [W, 3]
    V: torch.Tensor     # [W, 3]
    R: torch.Tensor     # [W, 3, 3]
    bg: torch.Tensor    # [W, 3]
    ba: torch.Tensor    # [W, 3]
    points: torch.Tensor
    total_chi2: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _inc(state, d):
    """Increment (P, V, R, bg, ba) by d [..., 15]; R is right-multiplied."""
    P, V, R, bg, ba = state
    return (P + d[..., 0:3], V + d[..., 3:6], R @ so3_exp(d[..., 6:9]),
            bg + d[..., 9:12], ba + d[..., 12:15])


def _nan_unless(ok, M):
    return torch.where(ok[..., None, None], M, torch.full_like(M, torch.nan))


def _cholesky(A):
    """Lower Cholesky factor; NaN where A is not positive definite (where
    JAX's cholesky returns NaN)."""
    L, info = torch.linalg.cholesky_ex(A)
    return _nan_unless(info == 0, L)


def _imu_sqrt_info(cov):
    """L with L L^T = inv(cov + 1e-10 I): the IMU factor is whitened as
    L^T r. cov [..., 9, 9]."""
    eye9 = torch.eye(9, dtype=cov.dtype, device=cov.device)
    info, err = torch.linalg.inv_ex(cov + 1e-10 * eye9)
    info = _nan_unless(err == 0, info)
    return _cholesky(0.5 * (info + info.transpose(-1, -2)))


def _bias_sqrt_w(dt):
    """[..., 6] square roots of the bias random walk's information."""
    dtc = torch.clamp(dt, min=1e-3)[..., None]
    return torch.sqrt(torch.cat([(1.0 / (GYR_BIAS_RW2 * dtc)).expand(
        dtc.shape[:-1] + (3,)), (1.0 / (ACC_BIAS_RW2 * dtc)).expand(
        dtc.shape[:-1] + (3,))], -1))


def _prior_sqrt(prior_info):
    pi = 0.5 * (prior_info + prior_info.T)
    eye = torch.eye(15, dtype=pi.dtype, device=pi.device)
    return _cholesky(pi + (1e-6 * torch.trace(pi) / 15.0 + 1e-8) * eye)


def _imu_factor(si, sj, pre, bias_lin_g, bias_lin_a, gw, imu_L, bias_L,
                correct_at_j=False):
    """Whitened preintegration residual [..., 9] and the weighted bias
    random walk [..., 6] between two states. The preintegration is
    bias-corrected at si's biases, or at sj's with correct_at_j (the
    single-state optimizer, whose previous state is fixed)."""
    Pi, Vi, Ri, bgi, bai = si
    Pj, Vj, Rj, bgj, baj = sj
    dt = pre.dt[..., None]
    dbg = (bgj if correct_at_j else bgi) - bias_lin_g
    dba = (baj if correct_at_j else bai) - bias_lin_a
    dP = pre.dP + _mv(pre.J_P_bg, dbg) + _mv(pre.J_P_ba, dba)
    dV = pre.dV + _mv(pre.J_V_bg, dbg) + _mv(pre.J_V_ba, dba)
    dR = pre.dR @ so3_exp(_mv(pre.J_R_bg, dbg))
    Rit = Ri.transpose(-1, -2)
    rP = _mv(Rit, Pj - Pi - Vi * dt - 0.5 * gw * dt * dt) - dP
    rV = _mv(Rit, Vj - Vi - gw * dt) - dV
    rR = so3_log_safe(dR.transpose(-1, -2) @ (Rit @ Rj))
    r_imu = _mv(imu_L.transpose(-1, -2), torch.cat([rP, rV, rR], -1))
    r_bias = bias_L * torch.cat([bgj - bgi, baj - bai], -1)
    return r_imu, r_bias


def _prior_residual(s, mean, prior_L, scale):
    P, V, R, bg, ba = s
    Pm, Vm, Rm, bgm, bam = mean
    e = torch.cat([P - Pm, V - Vm, so3_log_safe(Rm.transpose(-1, -2) @ R),
                   bg - bgm, ba - bam], -1)
    return scale * _mv(prior_L.transpose(-1, -2), e)


def _gram64(J, r):
    """J^T J and J^T r in float64 of [..., rows, n] float32 blocks summed
    over every leading dim."""
    J = J.reshape(-1, J.shape[-1]).double()
    r = r.reshape(-1).double()
    return J.T @ J, J.T @ r


def _gn_step(H, b):
    """The damped Gauss-Newton step -H^-1 b (float64 normal equations) as a
    float32 increment."""
    n = H.shape[0]
    H = H + 1e-8 * torch.trace(H) / n * torch.eye(n, dtype=H.dtype,
                                                   device=H.device)
    return (-solve_preconditioned(H, b)).float()


def _jac_rows(fn, n_out, n_in, batch=(), like=None):
    """Residual [*batch, n_out] and Jacobian [*batch, n_out, n_in] of
    fn(d) at d = 0, by ONE reverse-mode pass: fn gets n_out copies of the
    increment ([n_out, *batch, n_in]) and component k of copy k is summed,
    so the gradient of copy k is row k."""
    kw = dict(dtype=like.dtype, device=like.device)
    eye = torch.eye(n_out, **kw).reshape((n_out,) + (1,) * len(batch)
                                         + (n_out,))
    with torch.enable_grad():
        d = torch.zeros((n_out,) + tuple(batch) + (n_in,), **kw,
                        requires_grad=True)
        r = fn(d)
        g, = torch.autograd.grad((r * eye).sum(), d)
    return r[0].detach(), g.movedim(0, -2)


def _reproj_body(P, R, X, uv, Rcb, tcb, intr):
    """Reprojection through the body pose (P, R) (body->world) and the
    camera-from-body extrinsic (Rcb, tcb), with its analytic Jacobians:
    r [N, 2]; A [N, 2, 15] w.r.t. the NavState increment (P and Phi
    columns; R is right-multiplied); B [N, 2, 3] w.r.t. the point; z [N].
    P [3] or [N, 3], R [3, 3] or [N, 3, 3], X [N, 3], uv [N, 2]."""
    fx, fy, cx, cy = intr
    Rt = R.transpose(-1, -2)
    Xb = _mv(Rt, X - P)
    Xc = Xb @ Rcb.T + tcb
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    zi = 1.0 / torch.clamp(z, min=1e-6)
    r = torch.stack([fx * x * zi + cx - uv[:, 0],
                     fy * y * zi + cy - uv[:, 1]], -1)
    dz = zi * zi * (z > 1e-6).to(zi.dtype)   # max(z, 1e-6) is flat below
    zero = torch.zeros_like(zi)
    dpi = torch.stack([torch.stack([fx * zi, zero, -fx * x * dz], -1),
                       torch.stack([zero, fy * zi, -fy * y * dz], -1)], -2)
    G = dpi @ Rcb                            # d r / d Xb   [N, 2, 3]
    B = G @ Rt                               # d Xb / d X = R^T
    A = torch.cat([-B, torch.zeros_like(B), G @ hat(Xb),
                   torch.zeros_like(B), torch.zeros_like(B)], -1)
    return r, A, B, z


def vio_pose_optimization(cur, prev, pre: PreintState, bias_lin,
                          prior_mean, prior_info, has_prior,
                          pt_xyz, uv, inv_sigma2, valid,
                          Rcb, tcb, intr, gw,
                          rounds: int = 3, iters: int = 8):
    """Optimize the current frame's NavState.

    cur/prev/prior_mean: tuples (P, V, R, bg, ba) of TOTAL biases; prev is
    fixed. pre: preintegration prev->cur at bias_lin = (bg_lin, ba_lin).
    prior_info [15, 15]; has_prior: bool (a zero-weighted prior when
    False). pt_xyz [N, 3] world points, uv [N, 2], inv_sigma2 [N],
    valid [N]. Rcb/tcb: camera-from-body extrinsic. intr: (fx, fy, cx, cy).
    gw [3]. Returns VioPoseResult.
    """
    dev = pt_xyz.device
    bg_lin, ba_lin = bias_lin
    imu_L = _imu_sqrt_info(pre.cov)
    bias_L = _bias_sqrt_w(pre.dt)
    prior_L = _prior_sqrt(prior_info)
    prior_scale = torch.as_tensor(has_prior, device=dev).to(torch.float32)

    def small(d, st):
        s = _inc(st, d)
        r_imu, r_bias = _imu_factor(prev, s, pre, bg_lin, ba_lin, gw, imu_L,
                                    bias_L, correct_at_j=True)
        return torch.cat([r_imu, r_bias,
                          _prior_residual(s, prior_mean, prior_L,
                                          prior_scale)], -1)

    def normal_eq(st, inl_f, huber):
        """H, b of the stacked residual; the reprojection rows carry
        sqrt(inv_sigma2 * inlier * (z > 0.1)) and, under Huber, the square
        root of the IRLS weight once (as the JAX package weights them)."""
        r_s, J_s = _jac_rows(lambda d: small(d, st), 30, 15, like=pt_xyz)
        r, A, _, z = _reproj_body(st[0], st[2], pt_xyz, uv, Rcb, tcb, intr)
        w_r = torch.sqrt(inv_sigma2 * inl_f * (z > 0.1))
        r = r * w_r[:, None]
        A = A * w_r[:, None, None]
        H, b = _gram64(J_s, r_s)
        if huber:
            wu = torch.sqrt(_huber_weight((r * r).sum(1), CHI2_MONO))
            # one factor sqrt(w) on the rows: H += A^T diag(sqrt w) A
            s = torch.sqrt(wu)[:, None, None]
            Hr, br = _gram64(A * s, r * s[..., 0])
        else:
            Hr, br = _gram64(A, r)
        return H + Hr, b + br

    def reproj_chi2(st):
        r, _, _, z = _reproj_body(st[0], st[2], pt_xyz, uv, Rcb, tcb, intr)
        return (r * r).sum(1) * inv_sigma2, z

    state = cur
    inl = valid
    for rd in range(rounds):
        inl_f = inl.to(torch.float32)
        for _ in range(iters):
            state = _inc(state, _gn_step(*normal_eq(state, inl_f,
                                                    huber=rd < rounds - 1)))
        e2, z = reproj_chi2(state)
        inl = valid & (e2 < CHI2_MONO) & (z > 0.1)

    # posterior information = final Gauss-Newton Hessian
    H, _ = normal_eq(state, inl.to(torch.float32), huber=False)
    P, V, R, bg, ba = state
    return VioPoseResult(P=P, V=V, R=R, bg=bg, ba=ba, inliers=inl,
                         n_inliers=inl.sum(), marg_info=H.float())


def vio_pose_optimization_pair(cur, prev, pre: PreintState, bias_lin,
                               prior_mean, prior_info, has_prior,
                               Xp, uvp, is2p, validp,
                               Xc, uvc, is2c, validc,
                               Rcb, tcb, intr, gw,
                               rounds: int = 3, iters: int = 8):
    """Two-NavState frame optimization with marginalization of the
    previous state (the reference's PoseOptimization(Frame, Frame|KeyFrame,
    preint, gw, bComputeMarg), Optimizer.cc:278-616): both NavStates free,
    the 15x15 prior on the previous one, the IMU factor and the bias random
    walk between them, reprojection on both frames; after convergence the
    previous state is marginalized by Schur complement (computeMarginals,
    Optimizer.cc:598-613): prior_cur = H_cc - H_cp H_pp^-1 H_pc, mean =
    the optimized current state.

    cur/prev/prior_mean: (P, V, R, bg, ba). pre: preintegration prev->cur
    at bias_lin. Xp/uvp/is2p/validp: previous-frame points; Xc/...: current.
    """
    dev = Xc.device
    f32 = torch.float32
    bg_lin, ba_lin = bias_lin
    imu_L = _imu_sqrt_info(pre.cov)
    bias_L = _bias_sqrt_w(pre.dt)
    prior_L = _prior_sqrt(prior_info)
    prior_scale = torch.as_tensor(has_prior, device=dev).to(f32)

    def small(d, sp, sc):
        p = _inc(sp, d[..., :15])
        c = _inc(sc, d[..., 15:])
        r_imu, r_bias = _imu_factor(p, c, pre, bg_lin, ba_lin, gw, imu_L,
                                    bias_L)
        return torch.cat([_prior_residual(p, prior_mean, prior_L,
                                          prior_scale), r_imu, r_bias], -1)

    def reproj_rows(st, X, uv, is2, mask, wu):
        """Weighted reprojection rows and their [N, 2, 15] Jacobian."""
        r, A, _, z = _reproj_body(st[0], st[2], X, uv, Rcb, tcb, intr)
        w = torch.sqrt(is2 * mask * (z > 0.1)) * wu
        return r * w[:, None], A * w[:, None, None]

    def chi2_of(st, X, uv, is2):
        r, _, _, z = _reproj_body(st[0], st[2], X, uv, Rcb, tcb, intr)
        return (r * r).sum(-1) * is2, z

    def normal_eq(sp, sc, inlp, inlc, wup, wuc):
        r_s, J_s = _jac_rows(lambda d: small(d, sp, sc), 30, 30, like=Xc)
        rp, Ap = reproj_rows(sp, Xp, uvp, is2p, inlp, wup)
        rc, Ac = reproj_rows(sc, Xc, uvc, is2c, inlc, wuc)
        H, b = _gram64(J_s, r_s)
        Hp, bp = _gram64(Ap, rp)
        Hc, bc = _gram64(Ac, rc)
        H[:15, :15] += Hp
        H[15:, 15:] += Hc
        b[:15] += bp
        b[15:] += bc
        return H, b

    sp, sc = prev, cur
    inlp = validp.to(f32)
    inlc = validc.to(f32)
    onesp = torch.ones(Xp.shape[0], device=dev)
    onesc = torch.ones(Xc.shape[0], device=dev)
    for rd in range(rounds):
        for _ in range(iters):
            if rd < rounds - 1:
                wup = torch.sqrt(_huber_weight(chi2_of(sp, Xp, uvp, is2p)[0],
                                               CHI2_MONO))
                wuc = torch.sqrt(_huber_weight(chi2_of(sc, Xc, uvc, is2c)[0],
                                               CHI2_MONO))
            else:
                wup, wuc = onesp, onesc
            d = _gn_step(*normal_eq(sp, sc, inlp, inlc, wup, wuc))
            sp, sc = _inc(sp, d[:15]), _inc(sc, d[15:])
        c2p, zp = chi2_of(sp, Xp, uvp, is2p)
        c2c, zc = chi2_of(sc, Xc, uvc, is2c)
        inlp = (validp & (c2p < CHI2_MONO) & (zp > 0.1)).to(f32)
        inlc = (validc & (c2c < CHI2_MONO) & (zc > 0.1)).to(f32)

    # posterior information and Schur marginalization of the previous
    # state. The CURRENT frame's reprojection rows are left out of the
    # marginal: the caller re-adds those observations as the next step's
    # previous-frame edges, so the carried prior holds history + IMU +
    # previous-frame vision, each counted once.
    H, _ = normal_eq(sp, sc, inlp, torch.zeros_like(onesc), onesp, onesc)
    Hpp = H[:15, :15] + 1e-6 * torch.eye(15, dtype=H.dtype, device=dev)
    Hpc = H[:15, 15:]
    marg = H[15:, 15:] - Hpc.T @ torch.linalg.solve_ex(Hpp, Hpc).result
    marg = 0.5 * (marg + marg.T)
    # project to PSD: the Schur complement carries O(eps |H|) negative
    # eigenvalues that would NaN the next frame's prior Cholesky
    ew, EV = eigh_finite(marg)
    marg = (EV * torch.clamp(ew, min=0.0)[None, :]) @ EV.T
    marg = (0.5 * (marg + marg.T)).float()

    P, V, R, bg, ba = sc
    inl = inlc > 0
    return VioPairResult(P=P, V=V, R=R, bg=bg, ba=ba, inliers=inl,
                         n_inliers=inl.sum(), prior_mean=sc, prior_info=marg)


# ---------------------------------------------------------------------------
# Visual-inertial window bundle adjustment (the reference's
# LocalBundleAdjustmentNavState, Optimizer.cc:863-1279: a keyframe chain
# with a fixed anchor, preintegration edges along the chain, bias random
# walk edges, reprojection edges and landmark optimization)


def _imu_pair_residual(di, dj, si, sj, pre, bias_lin_g, bias_lin_a, gw,
                       imu_L, bias_L):
    """15-D stacked [preint (9, whitened), bias random walk (6, weighted)]
    residual of consecutive chain pairs, as a function of both 15-D
    increments (di, dj [..., 15])."""
    r_imu, r_bias = _imu_factor(_inc(si, di), _inc(sj, dj), pre, bias_lin_g,
                                bias_lin_a, gw, imu_L, bias_L)
    return torch.cat([r_imu, r_bias], -1)


def _reproj_ns(d15, dl, P, R, X, uv, Rcb, tcb, intr):
    """Reprojection residual [N, 2] through the body pose, as a function of
    the pose increment (only its P / Phi parts act) and the landmark
    increment; its Jacobians are _reproj_body's A and B."""
    P, R = P + d15[..., 0:3], R @ so3_exp(d15[..., 6:9])
    return _reproj_body(P, R, X + dl, uv, Rcb, tcb, intr)[0]


def vio_window_ba(P, V, R, bg, ba, fixed,
                  pre_fields, bias_lin_g, bias_lin_a,
                  points, pt_valid, obs_k, obs_l, obs_uv, obs_w,
                  Rcb, tcb, intr, gw,
                  n_win: int, n_points: int, iters: int = 8,
                  link_w=None):
    """Joint NavState-window + landmark Gauss-Newton with Schur elimination.

    P/V/R/bg/ba: [W, ...] window NavStates (chain order); fixed [W] bool.
    pre_fields: the PreintState fields of the W-1 chain links (dP, dV, dR,
    JPbg, JPba, JVbg, JVba, JRbg, cov, dt), each [W-1, ...].
    points [L, 3]; obs_*: [O] reprojection table (window index, point
    index, uv, weight; 0 = padding). link_w: optional [W-1] chain-link mask
    (0 = padding).
    """
    W, L = n_win, n_points
    dev = points.device
    f32 = torch.float32
    pre = PreintState(*pre_fields)
    free = (~fixed).to(f32)
    delta2 = CHI2_MONO
    obs_k = obs_k.long()
    obs_l = obs_l.long()
    imu_L = _imu_sqrt_info(pre.cov)
    bias_L = _bias_sqrt_w(pre.dt)
    ii = torch.arange(W - 1, device=dev)
    jj = ii + 1
    eye3 = torch.eye(3, device=dev)
    eye15 = torch.eye(15, device=dev)
    diag = torch.arange(W, device=dev)

    def seg(x, ids, n):
        return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                           device=dev).index_add_(0, ids, x)

    def block_diag(blocks):                     # [W, 15, 15] -> [W, 15, W, 15]
        D = torch.zeros(W, 15, W, 15, dtype=f32, device=dev)
        D[diag, :, diag, :] = blocks
        return D

    def links(st):
        si = tuple(a[ii] for a in st)
        sj = tuple(a[jj] for a in st)

        def fn(d):
            return _imu_pair_residual(d[..., :15], d[..., 15:], si, sj, pre,
                                      bias_lin_g, bias_lin_a, gw, imu_L,
                                      bias_L)
        return si, sj, fn

    def imu_residuals(st):
        si, sj, fn = links(st)
        r = fn(torch.zeros(W - 1, 30, device=dev))
        return r if link_w is None else r * link_w[:, None]

    def imu_rj(st):
        _, _, fn = links(st)
        r, J = _jac_rows(fn, 15, 30, (W - 1,), like=points)
        Ji, Jj = J[..., :15], J[..., 15:]
        if link_w is not None:
            r = r * link_w[:, None]
            Ji = Ji * link_w[:, None, None]
            Jj = Jj * link_w[:, None, None]
        return r, Ji, Jj

    def total_chi2(st, pts):
        """Robustified objective for step acceptance (a rejected step must
        not write into the map)."""
        r_imu = imu_residuals(st)
        r_uv = _reproj_body(st[0][obs_k], st[2][obs_k], pts[obs_l], obs_uv,
                            Rcb, tcb, intr)[0]
        c2 = (r_uv * r_uv).sum(1) * obs_w
        rob = torch.where(c2 <= delta2, c2,
                          2.0 * torch.sqrt(delta2 * torch.clamp(c2, min=1e-12))
                          - delta2)
        return rob.sum() + (r_imu * r_imu).sum()

    def one_iter(st, pts, lam):
        r_imu, Ji, Jj = imu_rj(st)
        r_uv, A, B, _ = _reproj_body(st[0][obs_k], st[2][obs_k], pts[obs_l],
                                     obs_uv, Rcb, tcb, intr)
        c2 = (r_uv * r_uv).sum(1) * obs_w
        w = obs_w * _huber_weight(c2, delta2)

        # normal equations: pose system [W, 15] + landmarks [L, 3]
        Aw = A * w[:, None, None]
        Bw = B * w[:, None, None]
        U = seg(Aw.transpose(1, 2) @ A, obs_k, W)
        Vl = seg(Bw.transpose(1, 2) @ B, obs_l, L) + lam * eye3
        Wb = Aw.transpose(1, 2) @ B                           # [O, 15, 3]
        bp = -seg((Aw.transpose(1, 2) @ r_uv[..., None])[..., 0], obs_k, W)
        bl = -seg((Bw.transpose(1, 2) @ r_uv[..., None])[..., 0], obs_l, L)
        M = seg(Wb, obs_l * W + obs_k, L * W).reshape(L, W, 15, 3)
        Vinv = torch.linalg.inv_ex(Vl).inverse
        T_ = torch.einsum("lpik,lkm->lpim", M, Vinv)
        S = -torch.einsum("lpim,lqjm->piqj", T_, M)
        S = S + block_diag(U + lam * eye15)
        g = bp - torch.einsum("lpim,lm->pi", T_, bl)

        # the IMU chain blocks of the pose system
        Hii = Ji.transpose(1, 2) @ Ji
        Hjj = Jj.transpose(1, 2) @ Jj
        Hij = Ji.transpose(1, 2) @ Jj
        gi = -(Ji.transpose(1, 2) @ r_imu[..., None])[..., 0]
        gj = -(Jj.transpose(1, 2) @ r_imu[..., None])[..., 0]
        flat = torch.zeros(W * W, 15, 15, device=dev)
        flat.index_add_(0, ii * W + ii, Hii)
        flat.index_add_(0, jj * W + jj, Hjj)
        flat.index_add_(0, ii * W + jj, Hij)
        flat.index_add_(0, jj * W + ii, Hij.transpose(1, 2))
        S = S + flat.reshape(W, W, 15, 15).permute(0, 2, 1, 3)
        g = g.index_add(0, ii, gi).index_add(0, jj, gj)

        # gauge / fixed states: zero their rows and cols, identity diagonal
        fm = free[:, None]
        S = S * fm[:, :, None, None] * fm[None, None, :, :]
        S = S + block_diag((1.0 - free)[:, None, None] * eye15)
        g = g * fm
        dp = solve_preconditioned(S.reshape(W * 15, W * 15),
                                  g.reshape(W * 15)).reshape(W, 15) * fm
        rhs = bl - torch.einsum("lpim,pi->lm", M, dp)
        dl = _mv(Vinv, rhs) * pt_valid[:, None]

        st2 = _inc(st, dp)
        pts2 = pts + dl
        # chi2-gated accept/rollback and LM damping
        old = total_chi2(st, pts)
        new = total_chi2(st2, pts2)
        acc = new < old
        st = tuple(torch.where(acc, a, b) for a, b in zip(st2, st))
        pts = torch.where(acc, pts2, pts)
        lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 8.0), 1e-6, 1e2)
        return st, pts, lam, torch.where(acc, new, old)

    st = (P, V, R, bg, ba)
    pts = points
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    chi = None
    for _ in range(iters):
        st, pts, lam, chi = one_iter(st, pts, lam)
    P, V, R, bg, ba = st
    return VioBAResult(P=P, V=V, R=R, bg=bg, ba=ba, points=pts,
                       total_chi2=chi)
