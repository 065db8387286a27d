"""Synthesized dataset trees in the EuRoC, TUM RGB-D and KITTI layouts.

Writes rendered frames (``utils/synthetic.py``) to disk as the readers of
``io/datasets.py`` and the reference's dataset mains expect them, with the
port's PNG encoder (``io/png.py``) and adaptive row filters, as libpng
writes the datasets' own files, and a settings file in the reference's
cv::FileStorage style. For the tests and ``chip_smoke.py``; no real dataset
is needed.
"""
from __future__ import annotations

import os

import numpy as np

from ..io import png


def _write_png(path, arr):
    png.write_png(path, arr, filters="adaptive")


def _ns(t: float) -> int:
    return int(round(t * 1e9))


def _quat_wxyz(R_wc):
    from ..system import _quat_wxyz

    return _quat_wxyz(R_wc)


def write_euroc(root, frames, poses, fps=20.0, t0=10.0, right=None,
                imu=None):
    """<root>/mav0/{cam0[,cam1],state_groundtruth_estimate0[,imu0]}: u8
    frames (and right views) at `fps` from t0 seconds, the ground truth
    of each (R, t) world->cam pose (camera centre and orientation), and
    `imu` rows (t, gyro[3], acc[3]) when given."""
    mav = os.path.join(root, "mav0")
    stamps = [_ns(t0 + i / fps) for i in range(len(frames))]
    for cam, views in (("cam0", frames), ("cam1", right)):
        if views is None:
            continue
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        rows = ["#timestamp [ns],filename"]
        for ns, img in zip(stamps, views):
            _write_png(os.path.join(mav, cam, "data", f"{ns}.png"), img)
            rows.append(f"{ns},{ns}.png")
        _write(os.path.join(mav, cam, "data.csv"), rows)
    gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    for ns, (R, t) in zip(stamps, poses):
        R = np.asarray(R, np.float64)
        c = -R.T @ np.asarray(t, np.float64)
        q = _quat_wxyz(R.T)
        gt.append(",".join([str(ns), *_floats(c), *_floats(q)]))
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    _write(os.path.join(gt_dir, "data.csv"), gt)
    if imu is not None:
        os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
        rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
        for t, g, a in imu:
            rows.append(",".join([str(_ns(t0 + t)), *_floats(g),
                                  *_floats(a)]))
        _write(os.path.join(mav, "imu0", "data.csv"), rows)
    return root


def write_tum(root, rgb, depths, poses, fps=30.0, t0=1305031102.0,
              factor=5000.0, depth_lag=0.004):
    """<root>/{rgb,depth}/, rgb.txt, depth.txt, groundtruth.txt: [H, W, 3]
    u8 colour frames, metric depth maps as 16-bit PNGs at `factor` per
    metre, each depth stamped `depth_lag` s after its colour frame (the
    readers associate them by nearest timestamp)."""
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rgb_rows, depth_rows = ["# color images"], ["# depth maps"]
    gt = ["# timestamp tx ty tz qx qy qz qw"]
    for i, (img, depth, (R, t)) in enumerate(zip(rgb, depths, poses)):
        ts = t0 + i / fps
        ts_d = ts + depth_lag
        _write_png(os.path.join(root, "rgb", f"{ts:.6f}.png"), img)
        d16 = np.clip(np.round(np.asarray(depth, np.float64) * factor), 0,
                      65535).astype(np.uint16)
        _write_png(os.path.join(root, "depth", f"{ts_d:.6f}.png"), d16)
        rgb_rows.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_rows.append(f"{ts_d:.6f} depth/{ts_d:.6f}.png")
        R = np.asarray(R, np.float64)
        c = -R.T @ np.asarray(t, np.float64)
        q = _quat_wxyz(R.T)
        gt.append(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} {q[1]:.7f} "
                  f"{q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    _write(os.path.join(root, "rgb.txt"), rgb_rows)
    _write(os.path.join(root, "depth.txt"), depth_rows)
    _write(os.path.join(root, "groundtruth.txt"), gt)
    return root


def write_kitti(root, frames, fps=10.0, seq="00", right=None):
    """<root>/sequences/<seq>/{image_0[,image_1],times.txt}."""
    seq_dir = os.path.join(root, "sequences", seq)
    for cam, views in (("image_0", frames), ("image_1", right)):
        if views is None:
            continue
        os.makedirs(os.path.join(seq_dir, cam), exist_ok=True)
        for i, img in enumerate(views):
            _write_png(os.path.join(seq_dir, cam, f"{i:06d}.png"), img)
    _write(os.path.join(seq_dir, "times.txt"),
           [f"{i / fps:.6e}" for i in range(len(frames))])
    return root


def settings_yaml(fx, fy, cx, cy, width, height, fps, extra=None):
    """Settings text in the reference's style (%YAML:1.0, dotted keys) for
    a pinhole camera; `extra` maps more keys to their text (e.g.
    {"ORBextractor.keypointMode": "octree"})."""
    fx, fy, cx, cy, fps = _floats((fx, fy, cx, cy, fps))
    rows = ["%YAML:1.0", "", "# camera calibration and distortion",
            f"Camera.fx: {fx}", f"Camera.fy: {fy}", f"Camera.cx: {cx}",
            f"Camera.cy: {cy}", "", f"Camera.width: {int(width)}",
            f"Camera.height: {int(height)}", f"Camera.fps: {fps}", ""]
    rows += [f"{k}: {v}" for k, v in (extra or {}).items()]
    return "\n".join(rows) + "\n"


def _floats(xs):
    """Each value as the shortest text that reads back to it."""
    return [repr(float(x)) for x in xs]


def _write(path, rows):
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
