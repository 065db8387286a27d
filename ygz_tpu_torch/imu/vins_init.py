"""Visual-inertial initialization (VI-ORB / reference TryInitVIO).

Port of ``ygz_tpu/imu/vins_init.py``, the reference's three-step VINS
initialization (LocalMapping.cc:189-723, Optimizer::OptimizeInitialGyroBias):

  Step 1 — gyro bias: Gauss-Newton on the rotation-preintegration residual
    log((dR_meas exp(J_R_bg db))^T R_bw_i R_wb_{i+1}) over keyframe pairs,
    on the preintegrations' device. Its Jacobian comes from one
    reverse-mode pass over every pair (the JAX package takes
    ``jax.jacfwd``).
  Step 2 — linear [scale, gravity] from keyframe triplets (velocity
    elimination; host numpy float64 least squares, LocalMapping.cc:266-319).
  Step 3 — refinement with accelerometer bias and |g| = 9.81: gravity on
    the sphere, a linear solve for [scale, dtheta_xy, b_a] (host numpy,
    LocalMapping.cc:322-401).

The keyframe-pair preintegrations are one batched PreintState with a
leading [K-1] axis (imu.preintegration.preintegrate over the stacked link
windows).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..geometry.lie import so3_exp, so3_log_safe
from .preintegration import PreintState, _mv

GRAVITY_MAG = 9.810


class VinsInitResult(NamedTuple):
    ok: bool
    scale: float
    gravity_w: np.ndarray   # [3] in the (unscaled) vision world frame
    bg: np.ndarray          # [3]
    ba: np.ndarray          # [3]
    # quality diagnostics for the tracker's acceptance gate: the step-2
    # linear scale and the step-3 system's normalized residual
    scale_linear: float = 0.0
    res_norm: float = 0.0


def _host(pre: PreintState) -> dict:
    """The batched preintegration's fields as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in pre._asdict().items()}


def gyro_residuals_jac(bg, preints: PreintState, rel):
    """Rotation residuals r [3(K-1)] = log((dR exp(J_R_bg bg))^T rel) of
    the keyframe pairs and their Jacobian [3(K-1), 3] w.r.t. bg, by one
    reverse-mode pass: row k of pair i's block is the gradient of copy k's
    component k. rel [K-1, 3, 3] = R_bw_i R_wb_{i+1}."""
    eye = torch.eye(3, device=bg.device)[:, None, :]
    with torch.enable_grad():
        leaf = bg.expand(3, rel.shape[0], 3).clone().requires_grad_(True)
        dR_corr = preints.dR @ so3_exp(_mv(preints.J_R_bg, leaf))
        r3 = so3_log_safe(dR_corr.transpose(-1, -2) @ rel)
        g, = torch.autograd.grad((r3 * eye).sum(), leaf)
    return r3[0].detach().reshape(-1), g.permute(1, 0, 2).reshape(-1, 3)


def solve_gyro_bias(R_wb: Sequence[np.ndarray], preints: PreintState,
                    iters: int = 5) -> np.ndarray:
    """Step 1: bg minimizing the rotation-preintegration residuals over
    consecutive pairs.

    R_wb: [K] body->world rotations from vision (scale-free, exact).
    preints: the [K-1] consecutive pairs' preintegrations (at bg = 0).
    """
    dev = preints.dR.device
    R = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in R_wb]),
                        device=dev)
    rel = R[:-1].transpose(-1, -2) @ R[1:]          # R_bw_i R_wb_{i+1}
    bg = torch.zeros(3, device=dev)
    for _ in range(iters):
        r, J = gyro_residuals_jac(bg, preints, rel)
        H = J.T @ J + 1e-9 * torch.eye(3, device=dev)
        bg = bg - torch.linalg.solve_ex(H, J.T @ r).result
    return bg.cpu().numpy()


def solve_scale_gravity(c_w, q_w, R_wb, preints: PreintState):
    """Step 2: linear LSQ for [s, g] from triplets.

    c_w: [K, 3] camera centres from vision (unscaled); q_w: [K, 3] =
    R_wc t_cb body-offset terms (body position = s c + q); R_wb: [K]
    rotations; preints: [K-1]. Returns (s, g [3]).
    """
    p = _host(preints)
    K = len(c_w)
    A = []
    B = []
    for i in range(K - 2):
        dt12 = float(p["dt"][i])
        dt23 = float(p["dt"][i + 1])
        if dt12 <= 0 or dt23 <= 0:
            continue
        lam = dt23 / dt12
        c1, c2, c3 = c_w[i], c_w[i + 1], c_w[i + 2]
        q1, q2, q3 = q_w[i], q_w[i + 1], q_w[i + 2]
        R1 = R_wb[i]
        R2 = R_wb[i + 1]
        # s * [(c3-c2) - (c2-c1) lam] - g * (0.5 dt23 (dt12 + dt23)) = rhs
        col_s = (c3 - c2) - (c2 - c1) * lam
        col_g = -0.5 * dt23 * (dt12 + dt23) * np.eye(3)
        rhs = (-R1 @ p["dP"][i] * lam + R1 @ p["dV"][i] * dt23
               + R2 @ p["dP"][i + 1] + (q2 - q1) * lam - (q3 - q2))
        A.append(np.concatenate([col_s[:, None], col_g], axis=1))
        B.append(rhs)
    A = np.concatenate(A)          # [3T, 4]
    B = np.concatenate(B)          # [3T]
    x, *_ = np.linalg.lstsq(A, B, rcond=None)
    return float(x[0]), x[1:4]


def _so3_exp_f32(w):
    """float32 rotation of a host axis-angle vector."""
    return so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def refine_with_accel_bias(c_w, q_w, R_wb, preints: PreintState, g0):
    """Step 3: re-solve [s, dtheta_xy, ba] with |g| fixed at 9.81.

    Gravity is parameterized g = R_g exp(hat([dthx, dthy, 0])) gI with
    gI = [0, 0, -9.81] rotated into the initial estimate's direction.
    """
    gI = np.array([0.0, 0.0, -GRAVITY_MAG])
    gn = g0 / max(np.linalg.norm(g0), 1e-9)
    gIn = gI / np.linalg.norm(gI)
    v = np.cross(gIn, gn)
    s_ang = np.linalg.norm(v)
    c_ang = float(np.dot(gIn, gn))
    if s_ang < 1e-8:
        R_g = np.eye(3)
    else:
        R_g = _so3_exp_f32(v / s_ang * np.arctan2(s_ang, c_ang))
    g_base = R_g @ gI  # ~= g0 direction with the correct magnitude

    p = _host(preints)
    K = len(c_w)
    A = []
    B = []
    for i in range(K - 2):
        dt12 = float(p["dt"][i])
        dt23 = float(p["dt"][i + 1])
        if dt12 <= 0 or dt23 <= 0:
            continue
        lam = dt23 / dt12
        c1, c2, c3 = c_w[i], c_w[i + 1], c_w[i + 2]
        q1, q2, q3 = q_w[i], q_w[i + 1], q_w[i + 2]
        R1, R2 = R_wb[i], R_wb[i + 1]
        col_s = (c3 - c2) - (c2 - c1) * lam
        kg = -0.5 * dt23 * (dt12 + dt23)
        # g = g_base + R_g d(gI)/dth dth  ->  columns for dth (x, y only)
        Dg = -R_g @ hat_np(gI)
        col_th = kg * Dg[:, :2]
        # accel-bias columns: dP/dV corrected by J_*_ba @ ba
        col_ba = (-R1 @ p["J_P_ba"][i] * lam + R1 @ p["J_V_ba"][i] * dt23
                  + R2 @ p["J_P_ba"][i + 1]) * -1.0
        rhs = (-R1 @ p["dP"][i] * lam + R1 @ p["dV"][i] * dt23
               + R2 @ p["dP"][i + 1]
               + (q2 - q1) * lam - (q3 - q2) - kg * g_base)
        A.append(np.concatenate([col_s[:, None], col_th, col_ba], axis=1))
        B.append(rhs)
    A = np.concatenate(A)
    B = np.concatenate(B)
    x, *_ = np.linalg.lstsq(A, B, rcond=None)
    s = float(x[0])
    dth = np.array([x[1], x[2], 0.0])
    ba = x[3:6]
    g = R_g @ _so3_exp_f32(dth) @ gI
    res = float(np.linalg.norm(A @ x - B) / max(np.linalg.norm(B), 1e-9))
    return s, g, ba, res


def hat_np(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


def vins_initialize(c_w, R_wc, preints_bg0: PreintState, recompute_preint,
                    Tbc, min_scale: float = 1e-3) -> VinsInitResult:
    """Full VINS init.

    c_w: [K, 3] camera centres (vision scale); R_wc: [K] cam->world.
    preints_bg0: the [K-1] preintegrations at zero gyro bias.
    recompute_preint: callable(bg) -> the [K-1] preintegrations at bias bg
      (the reference recomputes after step 1, LocalMapping.cc:254-264).
    Tbc: [4, 4] body->camera extrinsic (the reference's Camera.Tbc, T_b_c:
      the camera pose in the body frame).
    """
    Tbc = np.asarray(Tbc)
    Rbc = Tbc[:3, :3]
    tbc = Tbc[:3, 3]
    # body rotation: R_wb = R_wc R_cb = R_wc Rbc^T
    R_wb = [np.asarray(R) @ Rbc.T for R in R_wc]
    # body position offset: p_wb = p_wc + R_wc t_cb, t_cb = -Rbc^T tbc
    t_cb = -Rbc.T @ tbc
    q_w = np.stack([np.asarray(R) @ t_cb for R in R_wc])

    bg = solve_gyro_bias(R_wb, preints_bg0)
    preints = recompute_preint(bg)
    s2, g2 = solve_scale_gravity(np.asarray(c_w), q_w, R_wb, preints)
    if not np.isfinite(s2) or s2 < min_scale:
        return VinsInitResult(False, 0.0, np.zeros(3), bg, np.zeros(3))
    s3, g3, ba, res = refine_with_accel_bias(np.asarray(c_w), q_w, R_wb,
                                             preints, g2)
    ok = np.isfinite(s3) and s3 > min_scale and np.all(np.isfinite(g3))
    return VinsInitResult(bool(ok), float(s3), g3.astype(np.float32),
                          bg.astype(np.float32), ba.astype(np.float32),
                          scale_linear=float(s2), res_norm=res)
