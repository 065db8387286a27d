"""The judgement by sensor: a monocular run is fitted with scale, a metric
sensor's with the scale fixed at 1, and scale_err_pct reads how far the
returned trajectory's scale is from the truth."""
import json

import numpy as np
import pytest

from slam_bench import harness, reference, scene

LAP = json.loads((harness.BENCH / "traffic" / "live.json").read_text())[
    "lap"]
LIMITS = {"lost_pct": 10.0, "ate_pct": 0.6, "rpe_med_pct": 12.0,
          "map_err_med_pct": 6.0}


# ---- frozen copy of slam_bench/reference.py's pose_numbers and
# map_err_med_pct before the judgement followed the sensor (commit 6f7a89d)
def _frozen_pose_numbers(frame_ids, ok, R_cw, t_cw, true_c):
    frame_ids = np.asarray(frame_ids)
    ok = np.asarray(ok, bool)
    if ok.sum() < 3:
        return None
    est = reference.centres(np.asarray(R_cw)[ok], np.asarray(t_cw)[ok])
    gt = np.asarray(true_c, np.float64)[ok]
    if not np.isfinite(est).all():
        return {"ate_pct": float("inf"), "rpe_med_pct": float("inf")}
    s, R, t = reference.horn_align(est, gt, with_scale=True)
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
            else float("inf")}


def _frozen_map_err_med_pct(kf_c, kf_true_c, pts):
    if len(kf_c) < 3 or len(pts) == 0:
        return None
    s, R, t = reference.horn_align(kf_c, kf_true_c, with_scale=True)
    P = (s * (R @ np.asarray(pts, np.float64).T)).T + t
    err = np.abs(P[:, 2] - reference.surface_z(P[:, 0], P[:, 1]))
    return 100.0 * float(np.median(err)) / reference.PLANE_Z
# ---- end of the frozen copy


def scaled_run(scale=1.25, noise=0.0, seed=7):
    """A window of 300 frames and a map of 2,000 surface points in a frame
    rotated and moved from the truth's and `scale` times as large (with
    `noise` metres of noise on the centres): ids, ok, R_cw, t_cw, true
    centres, keyframe centres and their truth, points."""
    rng = np.random.default_rng(seed)
    lap = scene.Lap(LAP["seconds"], LAP["terms"], 11.0)
    ts = np.arange(300) / 20.0
    gt = lap.centre(ts)
    Rg = scene.rodrigues(np.array([0.3, -0.2, 0.9]))
    tg = np.array([1.0, -2.0, 0.5])

    def into(P):
        return scale * P @ Rg.T + tg

    est = into(gt) + noise * rng.standard_normal(gt.shape)
    R_cw = np.broadcast_to(np.eye(3), (300, 3, 3))
    xy = rng.uniform(-3.0, 3.0, (2000, 2))
    pts = np.c_[xy, reference.surface_z(xy[:, 0], xy[:, 1])]
    kf = np.arange(0, 300, 10)
    return (np.arange(300), np.ones(300, bool), R_cw, -est, gt, est[kf],
            gt[kf], into(pts))


def numbers(run, with_scale):
    ids, ok, R_cw, t_cw, gt, kf_c, kf_true, pts = run
    out = {"lost_pct": reference.lost_pct(ok)}
    out.update(reference.pose_numbers(ids, ok, R_cw, t_cw, gt,
                                      with_scale=with_scale))
    out["map_err_med_pct"] = reference.map_err_med_pct(
        kf_c, kf_true, pts, with_scale=with_scale)
    return out


def test_a_run_scaled_by_1_25_passes_7dof_and_fails_fixed_scale():
    run = scaled_run()
    seven = numbers(run, with_scale=True)
    fixed = numbers(run, with_scale=False)
    assert reference.judge(seven, LIMITS)[0], seven
    correct, rows = reference.judge(fixed, LIMITS)
    assert not correct
    failed = {n for n, v, lim in rows if not v <= lim}
    assert {"ate_pct", "rpe_med_pct", "map_err_med_pct"} <= failed
    assert seven["scale_err_pct"] == pytest.approx(25.0, abs=1e-9)
    assert fixed["scale_err_pct"] == seven["scale_err_pct"]
    # the fixed-scale fit of the true-sized run reads it as sound
    sound = numbers(scaled_run(scale=1.0), with_scale=False)
    assert reference.judge(sound, dict(LIMITS, scale_err_pct=1.0))[0], sound


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_the_monocular_numbers_are_as_before_bit_for_bit(noise):
    ids, ok, R_cw, t_cw, gt, kf_c, kf_true, pts = scaled_run(noise=noise)
    ok = ok.copy()
    ok[[5, 6, 100]] = False
    now = reference.pose_numbers(ids, ok, R_cw, t_cw, gt)
    then = _frozen_pose_numbers(ids, ok, R_cw, t_cw, gt)
    assert now["ate_pct"] == then["ate_pct"]
    assert now["rpe_med_pct"] == then["rpe_med_pct"]
    assert reference.map_err_med_pct(kf_c, kf_true, pts) == \
        _frozen_map_err_med_pct(kf_c, kf_true, pts)


def test_scale_err_reads_the_trajectory_against_the_truth():
    gt = np.random.default_rng(3).standard_normal((50, 3))
    assert reference.scale_err_pct(0.8 * gt + 1.0, gt) == pytest.approx(20.0)
    assert reference.scale_err_pct(gt, gt) == pytest.approx(0.0, abs=1e-9)
