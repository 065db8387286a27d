"""Absolute trajectory error (ATE) evaluation — numpy port of the reference's
evaluation protocol (ORB-YGZ-SLAM scripts/evaluate_ate_euroc.py:48-80:
Horn closed-form alignment + RMSE; scripts/evaluate_ate_scale_euroc.py for the
7-DoF monocular variant with scale)."""
from __future__ import annotations

import numpy as np


def horn_align(model, data, with_scale=False):
    """Align `model` [N,3] to `data` [N,3]: find s, R, t minimizing
    ||s R model + t - data||. Returns (s, R [3,3], t [3])."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc / len(model)
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc ** 2).sum() / len(model)
        s = (S * np.diag(D)).sum() / var_m
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(est_xyz, gt_xyz, with_scale=False):
    """RMSE of aligned trajectories. Returns (rmse, aligned_est)."""
    s, R, t = horn_align(est_xyz, gt_xyz, with_scale)
    aligned = (s * (R @ np.asarray(est_xyz, np.float64).T)).T + t
    err = aligned - np.asarray(gt_xyz, np.float64)
    rmse = float(np.sqrt((err ** 2).sum(axis=1).mean()))
    return rmse, aligned


def rotation_angle_deg(Ra, Rb) -> float:
    """Angle of Ra Rb^T in degrees, in float64 via atan2 (arccos of a
    float32 trace reads a 1-ulp difference of R as ~0.1 deg)."""
    D = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = 0.5 * np.linalg.norm([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0],
                              D[1, 0] - D[0, 1]])
    return float(np.degrees(np.arctan2(s, 0.5 * (np.trace(D) - 1.0))))


def associate_timestamps(ts_a, ts_b, max_dt=0.02):
    """Greedy nearest-timestamp association (scripts/associate.py semantics).
    Returns index pairs [M,2]."""
    ts_a = np.asarray(ts_a)
    ts_b = np.asarray(ts_b)
    pairs = []
    used_b = set()
    order_b = np.argsort(ts_b)
    sb = ts_b[order_b]
    for ia, ta in enumerate(ts_a):
        j = np.searchsorted(sb, ta)
        best, bd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(sb):
                d = abs(sb[jj] - ta)
                if d <= bd and int(order_b[jj]) not in used_b:
                    best, bd = int(order_b[jj]), d
        if best >= 0:
            pairs.append((ia, best))
            used_b.add(best)
    return np.array(pairs, np.int64).reshape(-1, 2)
