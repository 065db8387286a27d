"""The plain reference that decides `correct`: numpy only, nothing of the
port.

The generator knows every frame's true pose and the surface every map
point should lie on, in float64 and in metres. The reference aligns what
the timed path returned to that truth and reduces it to the numbers the
cell's limits hold. The alignment follows the sensor: a monocular map has
no metric gauge, so its fit is 7-DoF (Umeyama/Horn with scale); a stereo
rig, a depth camera and an IMU give the metric scale, so theirs fixes the
scale at 1 (``with_scale=False``), as the port's dataset runners evaluate
them:

- ``lost_pct``: the share of the window's frames returned in a state other
  than OK, in % (a frame without a pose is what a user loses);
- ``ate_pct``: RMSE of the returned camera centres of the window's OK
  frames after one alignment, as % of their true path length;
- ``rpe_med_pct``: median over consecutive OK frames of the error of the
  returned frame-to-frame motion (scaled and rotated by that alignment), as
  % of the window's mean true frame-to-frame motion;
- ``scale_err_pct``: 100 |s - 1|, s the scale of the returned centres of
  the window's OK frames against the true ones by a 7-DoF fit, for every
  sensor (judged only where a cell's limits name it);
- ``map_err_med_pct``: median distance along z of the map's points from the
  true surface, after the alignment of the map's keyframe centres to their
  true centres, as % of the surface's depth (5 m).

``horn_align`` is a frozen copy of ``ygz_tpu_torch/eval/ate.py`` at
commit 9b79ab1 (the reference's evaluate_ate_scale_euroc.py protocol).
"""
from __future__ import annotations

import numpy as np

PLANE_Z = 5.0


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


def centres(R_cw, t_cw):
    """[N, 3] camera centres -R^T t of world->camera poses."""
    R_cw = np.asarray(R_cw, np.float64)
    t_cw = np.asarray(t_cw, np.float64)
    return -np.einsum("nji,nj->ni", R_cw, t_cw)


def surface_z(x, y, base=PLANE_Z, amp=0.5, period=4.0):
    """The surface the frames were rendered from (smooth_depth)."""
    w = 2.0 * np.pi / period
    return base + amp * np.sin(w * x) * np.sin(w * y)


def lost_pct(ok):
    """% of the frames (ok [N] bool: returned OK) returned without a
    pose."""
    ok = np.asarray(ok, bool)
    return 100.0 * float((~ok).sum()) / max(len(ok), 1)


def pose_numbers(frame_ids, ok, R_cw, t_cw, true_c, with_scale=True):
    """ate_pct, rpe_med_pct and scale_err_pct of the window's returned
    poses; frame_ids [N] consecutive-frame numbering, ok [N] bool, R_cw
    [N, 3, 3], t_cw [N, 3], true_c [N, 3]; `with_scale` False fixes the
    alignment's scale at 1 (a metric sensor). None where fewer than 3
    frames are OK."""
    frame_ids = np.asarray(frame_ids)
    ok = np.asarray(ok, bool)
    if ok.sum() < 3:
        return None
    est = centres(np.asarray(R_cw)[ok], np.asarray(t_cw)[ok])
    gt = np.asarray(true_c, np.float64)[ok]
    if not np.isfinite(est).all():
        return {"ate_pct": float("inf"), "rpe_med_pct": float("inf"),
                "scale_err_pct": float("inf")}
    s, R, t = horn_align(est, gt, with_scale=with_scale)
    aligned = (s * (R @ est.T)).T + t
    ate = float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))
    steps = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    ids = frame_ids[ok]
    pair = np.diff(ids) == 1
    d_est = (s * (R @ np.diff(est, axis=0).T)).T[pair]
    d_gt = np.diff(gt, axis=0)[pair]
    mean_step = float(steps[pair].mean()) if pair.any() else float("nan")
    rpe = np.linalg.norm(d_est - d_gt, axis=1) / mean_step
    return {"ate_pct": 100.0 * ate / float(steps.sum()),
            "rpe_med_pct": 100.0 * float(np.median(rpe)) if pair.any()
            else float("inf"),
            "scale_err_pct": scale_err_pct(est, gt)}


def scale_err_pct(est, gt):
    """100 |s - 1|, s the scale of the centres est [N, 3] against the true
    centres gt [N, 3]: the 7-DoF fit s R gt + t of the truth onto them, so
    a trajectory 1.25 times too large reads 25."""
    return 100.0 * abs(float(horn_align(gt, est, with_scale=True)[0]) - 1.0)


def map_err_med_pct(kf_c, kf_true_c, pts, with_scale=True):
    """Median |z - surface(x, y)| of map points pts [M, 3] after aligning
    the keyframe centres kf_c [K, 3] to their true centres (the scale fixed
    at 1 where `with_scale` is False), as % of the surface depth. None with
    fewer than 3 keyframes or no point."""
    if len(kf_c) < 3 or len(pts) == 0:
        return None
    s, R, t = horn_align(kf_c, kf_true_c, with_scale=with_scale)
    P = (s * (R @ np.asarray(pts, np.float64).T)).T + t
    err = np.abs(P[:, 2] - surface_z(P[:, 0], P[:, 1]))
    return 100.0 * float(np.median(err)) / PLANE_Z


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) of the numbers against their
    limits, in the limits' order. A number that is missing (None), not
    finite or over its limit fails."""
    rows, correct = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        value = float("nan") if v is None else float(v)
        if not (np.isfinite(value) and value <= limit):
            correct = False
        rows.append((name, value, float(limit)))
    return correct, rows
