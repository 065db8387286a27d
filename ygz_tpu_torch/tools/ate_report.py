"""ATE table across the sensor modes on synthetic scenes.

Port of the JAX repository's ``tools/ate_report.py``. The BASELINE ATE
targets are held against the synthetic protocol: rendered scenes with and
without photometric nuisances (exposure gain and bias, pixel noise, motion
blur, occluders: ``utils/synthetic.Nuisance``), evaluated with the
Horn-aligned ATE RMSE of the reference's ``evaluate_ate_euroc.py``
(``eval/ate.py``).

Every mode runs with the bench's defaults (the async mapping worker, and
the 8-frame microbatched entry for mono), and the trajectories are read
through ``recovered_pose`` (relative to their keyframe, so BA and loop
corrections propagate). ``-step`` modes run on the terraced StepScene
(depth discontinuities, clean renders only). ``mono-loop`` is a 640-frame
square circuit at 640x480 whose return to the start must close a loop
through place recognition. The nuisanced ``mono-vi`` row runs
``--vi-runs`` times (its worker's timing moves its result) and reports
every run.

    python -m ygz_tpu_torch.tools.ate_report [--device cpu] [--modes mono]
        [--out build/ygz_tpu_torch/ATE_report.md]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import NamedTuple

import numpy as np

from . import centres, device_label, resolve_device, tracked_centres
from ..utils.cuda_build import BUILD_DIR

MODES = "mono,mono-step,mono-loop,stereo,rgbd,rgbd-step,mono-vi"
BASELINE_M = 0.2       # stereo baseline of the stereo rows
VI_FPS = 20.0
VI_FRAMES = 70
LOOP_FRAMES = 640


class ModeResult(NamedTuple):
    rmse: float
    ok: int             # frames tracked OK
    n: int              # frames
    align: str          # the alignment, and notes
    system: object
    loops: int = 0      # loops closed (mono-loop)
    events: tuple = ()  # LoopCloser.events (mono-loop)


def make_trajectory(n_frames, step=0.03):
    """Smooth sideways sweep with gentle yaw oscillation (the JAX tests'
    ``test_vo_e2e.make_trajectory``). Returns [(R, t)] world->camera."""
    import torch

    from ..geometry.lie import so3_exp

    poses = []
    for i in range(n_frames):
        yaw = 0.03 * np.sin(i * 0.15)
        pitch = 0.015 * np.sin(i * 0.09 + 1.0)
        w = np.array([pitch, yaw, 0.0], np.float32)
        R = so3_exp(torch.as_tensor(w)).numpy()
        c = np.array([step * i, 0.15 * np.sin(i * 0.1), 0.0], np.float32)
        poses.append((R, -R @ c))
    return poses


def _camera(scene, bf=0.0):
    from ..geometry.camera import Camera

    return Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                       scene.h, bf=bf)


def _ate(system, poses, with_scale):
    """(ATE RMSE, frames tracked OK) against world->camera poses."""
    from ..eval.ate import ate_rmse

    est, gt = tracked_centres(system, centres(poses))
    return float(ate_rmse(est, gt, with_scale=with_scale)[0]), len(est)


def run_mode(mode, nuisance, device, n_frames=50):
    """One row: `mode` on its scene, with or without nuisances."""
    from ..frontend.tracker import TrackerConfig
    from ..system import Sensor, System
    from ..utils.synthetic import Nuisance, SmoothScene, StepScene

    if mode == "mono-loop":
        return run_mono_loop(nuisance, device)
    if mode == "mono-vi":
        return run_mono_vi(nuisance, device)
    step = mode.endswith("-step")
    if step:
        mode = mode[: -len("-step")]
    scene = (StepScene if step else SmoothScene)(seed=11)
    nuis = Nuisance(seed=3) if nuisance else None
    poses = make_trajectory(n_frames)
    # the bench's configuration: async mapping tail, 8-frame microbatch
    cfg = TrackerConfig(async_mapping=True, track_batch=8)
    if mode == "mono":
        system = System(_camera(scene), Sensor.MONOCULAR, config=cfg,
                        device=device)
    elif mode == "stereo":
        system = System(_camera(scene, bf=scene.f * BASELINE_M),
                        Sensor.STEREO, config=cfg, device=device)
    elif mode == "rgbd":
        system = System(_camera(scene), Sensor.RGBD, config=cfg,
                        device=device)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    states = []
    buf_img, buf_ts = [], []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        if nuis is not None:
            img = nuis.apply(img, i)
        if mode == "mono":
            buf_img.append(img)
            buf_ts.append(i * 0.05)
            if len(buf_img) == 8:
                states += [s for s, _ in system.track_monocular_batch(
                    buf_img, buf_ts)]
                buf_img, buf_ts = [], []
            continue
        if mode == "stereo":
            imgR = scene.render(R, t - np.array([BASELINE_M, 0.0, 0.0],
                                                np.float32))
            if nuis is not None:
                imgR = nuis.apply(imgR, 10000 + i)
            state, _ = system.track_stereo(img, imgR, timestamp=i * 0.05)
        else:
            state, _ = system.track_rgbd(img, scene.depth(R, t),
                                         timestamp=i * 0.05)
        states.append(state)
    for im, ts in zip(buf_img, buf_ts):
        states.append(system.track_monocular(im, timestamp=ts)[0])
    system.shutdown()

    with_scale = mode == "mono"
    rmse, _ = _ate(system, poses, with_scale)
    ok = sum(1 for s in states if s == "OK")
    align = "7-DoF (mono scale)" if with_scale else "6-DoF (metric)"
    return ModeResult(rmse, ok, len(poses), align, system)


def run_mono_vi(nuisance, device, n_frames=VI_FRAMES):
    """Mono-inertial along the VI tests' trajectory with its exact IMU;
    6-DoF ATE (metric after VINS init)."""
    from ..frontend.tracker import TrackerConfig
    from ..system import Sensor, System
    from ..utils.synthetic import Nuisance, SmoothScene, pose_fn, synth_imu

    scene = SmoothScene(seed=11)
    nuis = Nuisance(seed=3) if nuisance else None
    system = System(_camera(scene), Sensor.MONO_VI,
                    config=TrackerConfig(kf_max_gap=8, async_mapping=True),
                    device=device, vins_init_kfs=6, vins_init_time=1.2)
    states = []
    for i in range(n_frames):
        t = i / VI_FPS
        R, tt = pose_fn(t)
        img = scene.render(R, tt)
        if nuis is not None:
            img = nuis.apply(img, i)
        imu = synth_imu((i - 1) / VI_FPS, t) if i > 0 else []
        states.append(system.track_mono_vi(img, imu, timestamp=t)[0])
    system.shutdown()
    rmse, _ = _ate(system, [pose_fn(i / VI_FPS) for i in range(n_frames)],
                   with_scale=False)
    ok = sum(1 for s in states if s == "OK")
    return ModeResult(rmse, ok, n_frames, "6-DoF (metric after VINS init)",
                      system)


def run_mono_loop(nuisance, device, n_frames=LOOP_FRAMES):
    """A square circuit over the scene: four legs long enough that they do
    not share view frustums, so the final approach to the start is
    covisibility-disconnected from the recent chain and re-binds the start
    region only through place recognition; a loop closure must fire, and
    the trajectory after the correction is evaluated. (An out-and-back
    sweep does not close a loop here or in the reference: the turn keeps
    the same surface in view and covisibility never breaks.)"""
    import torch

    from ..frontend.tracker import TrackerConfig
    from ..geometry.lie import so3_exp
    from ..system import Sensor, System
    from ..utils.synthetic import Nuisance, SmoothScene

    # the texture covers the D x D circuit and the view's span
    scene = SmoothScene(seed=11, tex_size=2400)
    nuis = Nuisance(seed=3) if nuisance else None
    cfg = TrackerConfig(async_mapping=True, track_batch=8)
    system = System(_camera(scene), Sensor.MONOCULAR, config=cfg,
                    device=device)

    D = 11.0                      # leg length in world units (view ~7)
    leg = n_frames // 4
    corners = [(0.0, 0.0), (D, 0.0), (D, D), (0.0, D), (0.0, 0.0)]

    def pose(i):
        k = min(i // leg, 3)
        a = (i - k * leg) / leg
        x0, y0 = corners[k]
        x1, y1 = corners[k + 1]
        yaw = 0.05 * np.sin(i * 0.11)
        R = so3_exp(torch.as_tensor(np.array(
            [0.02 * np.sin(i * 0.07), yaw, 0.0], np.float32))).numpy()
        c = np.array([x0 + (x1 - x0) * a, y0 + (y1 - y0) * a,
                      0.15 * np.sin(i * 0.05)], np.float32)
        return R, (-R @ c).astype(np.float32)

    poses = [pose(i) for i in range(n_frames)]
    buf_img, buf_ts = [], []
    for i, (R, t) in enumerate(poses):
        img = scene.render(R, t)
        if nuis is not None:
            img = nuis.apply(img, i)
        buf_img.append(img)
        buf_ts.append(i * 0.05)
        if len(buf_img) == 8:
            system.track_monocular_batch(buf_img, buf_ts)
            buf_img, buf_ts = [], []
    for im, ts in zip(buf_img, buf_ts):
        system.track_monocular(im, timestamp=ts)
    system.shutdown()

    rmse, ok = _ate(system, poses, with_scale=True)
    loops = system.tracker.n_loops_closed
    align = f"7-DoF; loops closed: {loops}"
    if loops < 1:
        align += " (NO LOOP FIRED)"
    events = tuple(system.tracker.loop_closer.events) \
        if system.tracker.loop_closer is not None else ()
    return ModeResult(rmse, ok, n_frames, align, system, loops, events)


@contextlib.contextmanager
def keyframe_log(tracker_cls):
    """Within the block, log tracker_cls's keyframe decisions as (frame,
    tracked inliers) and its keyframes as (frame, tracked points the
    keyframe is made with); yields (created, decided). The class is
    patched, so a tracker created inside the block is logged too."""
    created, decided = [], []
    need, create = tracker_cls._need_new_keyframe, \
        tracker_cls._create_keyframe

    def need_logged(self, ts, n_inliers, *args):
        decided.append((self.frame_id, int(n_inliers)))
        return need(self, ts, n_inliers, *args)

    def create_logged(self, pyr, ts, R, t, ids, *args):
        created.append((self.frame_id, len(ids)))
        return create(self, pyr, ts, R, t, ids, *args)

    tracker_cls._need_new_keyframe = need_logged
    tracker_cls._create_keyframe = create_logged
    try:
        yield created, decided
    finally:
        tracker_cls._need_new_keyframe = need
        tracker_cls._create_keyframe = create


def weak_keyframe_stalls(created, decided, max_gap):
    """Keyframes made under weak tracking (< 50 tracked points) after which
    none came for max_gap frames while the tracker saw at least twice their
    points: [(frame, points, frames to the next keyframe, median
    inliers)]."""
    out = []
    for (f, n), (f_next, _) in zip(created, created[1:]):
        seen = [m for g, m in decided if f < g < f_next]
        if n < 50 and f_next - f >= max_gap and seen \
                and np.median(seen) >= 2 * n:
            out.append((f, n, f_next - f, float(np.median(seen))))
    return out


def write_table(path, rows, device):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# ATE accuracy table (synthetic protocol)\n\n")
        f.write(f"Device: {device}. `python -m ygz_tpu_torch.tools."
                "ate_report`: rendered scenes with and without photometric "
                "nuisances, Horn-aligned ATE RMSE as in the reference's "
                "evaluate_ate_euroc.py. Every mode runs with the bench's "
                "defaults (async mapping, and the 8-frame microbatch for "
                "mono); poses are read after every correction through "
                "recovered_pose. mono-loop is the 640-frame square circuit "
                "(4 x 11-unit legs) closed by a live loop closure; the "
                "50-frame rows span ~1.5 world units (scene depth ~5). "
                "'-step' rows run on the terraced StepScene (clean "
                "renders). The nuisanced mono-vi row reports every "
                "run.\n\n")
        f.write("| mode | nuisances | ATE RMSE | frames OK | alignment |\n")
        f.write("|---|---|---|---|---|\n")
        for mode, nu, rmse, ok, n, align in rows:
            f.write(f"| {mode} | {nu} | {rmse:.4f} | {ok}/{n} | {align} |\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(BUILD_DIR / "ATE_report.md"))
    ap.add_argument("--vi-runs", type=int, default=6,
                    help="repetitions of the nuisanced mono-vi row")
    ap.add_argument("--modes", default=MODES)
    ap.add_argument("--frames", type=int, default=50,
                    help="frames of the mono, stereo and RGB-D rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    for mode in args.modes.split(","):
        for nuisance in (False, True):
            if mode.endswith("-step") and nuisance:
                continue
            reps = args.vi_runs if (mode == "mono-vi" and nuisance) else 1
            rmses = []
            for rep in range(reps):
                t0 = time.time()
                res = run_mode(mode, nuisance, device, args.frames)
                rmses.append(res.rmse)
                print(f"{mode:10s} nuis={nuisance} run {rep + 1}/{reps}: "
                      f"ATE {res.rmse:.4f}  ({res.ok}/{res.n} OK, "
                      f"{time.time() - t0:.0f}s)", flush=True)
            align, rmse = res.align, res.rmse
            if reps > 1:
                align += (f"; {reps} runs: "
                          + ", ".join(f"{r:.3f}" for r in rmses))
                rmse = float(np.median(rmses))
            rows.append((mode, "yes" if nuisance else "no", rmse, res.ok,
                         res.n, align))
    write_table(args.out, rows, device_label(device))
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
