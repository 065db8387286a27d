"""Long-sequence endurance run with live loop closures.

Port of the JAX repository's ``tools/long_sequence.py``. A 2,000+ frame
synthetic two-square circuit at EuRoC cadence (20 fps) through the whole
system: microbatched tracking (the frame step replayed as a CUDA graph on
the card), the async mapping worker, BoW indexing and loop closing. The
path laps square A, then square B on the other side of the origin; each
lap's legs are long enough to be covisibility-disconnected, so both returns
to the origin present as loop closures. Mild photometric nuisances are on
by default: on clean renders the direct tracker drifts too little to break
covisibility with the old map, and a revisit re-binds without a loop.

Gates: frames OK > 0.9 of the frames and 7-DoF ATE < 0.25 (the run fails
otherwise). Also written: map growth past the initial 256-keyframe
capacity, the drain time of the mapping worker at shutdown, the loops
closed, and each closure's trajectory ATE just before and just after its
correction (``loop_events``).

    python -m ygz_tpu_torch.tools.long_sequence [--frames 2240]
        [--device cpu] [--out build/ygz_tpu_torch/longrun.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

from . import device_label, resolve_device, tracked_centres
from ..utils.cuda_build import BUILD_DIR

W, H, F = 752, 480, 458.0
D_LEG = 11.0          # leg length at the design length
DESIGN_FRAMES = 2240  # frames the D_LEG legs are sized for; shorter runs
#                       scale the legs down so the camera's speed per frame
#                       (what tracking sees) does not depend on the length


def leg_length(n_total):
    return D_LEG * min(1.0, n_total / DESIGN_FRAMES)


def pose(i, n_total):
    """Two-square circuit: square A ((0,0)->(D,0)->(D,D)->(0,D)->back),
    then square B mirrored through the origin. EuRoC-like lateral motion
    with yaw/pitch wobble against a ~5-unit-deep scene; world->camera."""
    import torch

    from ..geometry.lie import so3_exp

    D = leg_length(n_total)
    wp = [(0, 0), (D, 0), (D, D), (0, D), (0, 0),
          (-D, 0), (-D, -D), (0, -D), (0, 0)]
    n_legs = len(wp) - 1
    leg = n_total / n_legs
    k = min(int(i // leg), n_legs - 1)
    a = (i - k * leg) / leg
    x0, y0 = wp[k]
    x1, y1 = wp[k + 1]
    yaw = 0.05 * np.sin(i * 0.11)
    pitch = 0.02 * np.sin(i * 0.07)
    R = so3_exp(torch.as_tensor(
        np.array([pitch, yaw, 0.0], np.float32))).numpy()
    c = np.array([x0 + (x1 - x0) * a, y0 + (y1 - y0) * a,
                  0.15 * np.sin(i * 0.05)], np.float32)
    return R, (-R @ c).astype(np.float32)


def trajectory_ate(system, gt_centres):
    """7-DoF ATE of the frames tracked OK so far (nan below 10 frames)."""
    from ..eval.ate import ate_rmse

    est, gt = tracked_centres(system, list(gt_centres))
    if len(est) < 10:
        return float("nan")
    return float(ate_rmse(est, gt, with_scale=True)[0])


@contextlib.contextmanager
def record_closures(system, gt_centres, log=print):
    """Within the block, every loop `system`'s LoopCloser accepts records its
    trajectory ATE at detection (``ate_pre``) and after the correction
    (``ate_post``) into its event; yields the list of those events.

    The wrapper runs on the mapping worker under the map lock (re-entrant:
    ``recovered_pose`` takes it again). It probes ``detect`` once before
    the real call and restores the consistency groups and the detection
    count after the probe, so the real call sees them as ``detect`` alone
    would have left them. `gt_centres` may grow while the run goes on.

    The class is patched, not an instance: the tracker creates its closer
    when the map initializes and again after a reset, both inside the
    block; the identity test leaves other systems' closers alone."""
    from ..backend.loopclosing import LoopCloser

    events = []
    real = LoopCloser.process_keyframe

    def recorded(self, smap, kf, bow_vec):
        if self is not system.tracker.loop_closer:
            return real(self, smap, kf, bow_vec)
        n_before = len(self.events)
        groups, n_detect = list(self._consistent_groups), self.n_detect
        cand = self.detect(smap, kf, bow_vec)
        self._consistent_groups, self.n_detect = groups, n_detect
        pre = None if cand is None else trajectory_ate(system, gt_centres)
        fired = real(self, smap, kf, bow_vec)
        if fired and len(self.events) > n_before:
            ev = self.events[-1]
            ev["ate_pre"] = None if pre is None else round(pre, 4)
            ev["ate_post"] = round(trajectory_ate(system, gt_centres), 4)
            events.append(ev)
            log(f"  loop closed: {ev}")
        return fired

    LoopCloser.process_keyframe = recorded
    try:
        yield events
    finally:
        LoopCloser.process_keyframe = real


def run(n, device, batch=8, nuisance=True, log=print):
    """Track the n-frame circuit; returns the JSON record."""
    from ..eval.ate import ate_rmse, horn_align
    from ..frontend.tracker import TrackerConfig
    from ..geometry.camera import Camera
    from ..system import Sensor, System
    from ..utils.synthetic import Nuisance, SmoothScene

    # the texture covers both squares (span 2 * D_LEG) plus ~8 units of
    # view margin at 60 px per unit
    tex = int(2 * (leg_length(n) + 8.0) * 60)
    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=tex)
    nuis = Nuisance(seed=3) if nuisance else None
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, W, H)
    # kf_max_gap=6 forces >= n/6/2 keyframes, so the 256-keyframe capacity
    # is exceeded well before the end (map growth under test)
    cfg = TrackerConfig(async_mapping=True, track_batch=batch, kf_max_gap=6)
    system = System(cam, Sensor.MONOCULAR, config=cfg, device=device)

    gt_centres = []
    t0 = time.perf_counter()
    t_render = 0.0
    buf_img, buf_ts = [], []
    with record_closures(system, gt_centres, log) as loop_events:
        for i in range(n):
            R, t = pose(i, n)
            t1 = time.perf_counter()
            img = np.clip(scene.render(R, t), 0, 255).astype(np.uint8)
            if nuis is not None:
                img = np.clip(nuis.apply(img.astype(np.float32), i), 0,
                              255).astype(np.uint8)
            t_render += time.perf_counter() - t1
            gt_centres.append(-R.T @ t)
            buf_img.append(img)
            buf_ts.append(i * 0.05)
            if len(buf_img) == batch:
                system.track_monocular_batch(buf_img, buf_ts)
                buf_img, buf_ts = [], []
            if i and i % 400 == 0:
                st = system.tracker.stats()
                log(f"frame {i}: kf={st['n_kf']} pt={st['n_pt']} "
                    f"loops={st['n_loops_closed']} "
                    f"{i / (time.perf_counter() - t0 - t_render):.1f} fps "
                    f"(excl. render)")
        for im, ts in zip(buf_img, buf_ts):
            system.track_monocular(im, ts)
        track_s = time.perf_counter() - t0 - t_render
        t2 = time.perf_counter()
        system.shutdown()
        drain_s = time.perf_counter() - t2

    st = system.tracker.stats()
    est, gt = tracked_centres(system, gt_centres)
    scale, _, _ = horn_align(est, gt, with_scale=True)
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    smap = system.map
    return {
        "frames": n,
        "frames_ok": len(est),
        "ok_fraction": round(len(est) / n, 4),
        "ate_rmse_7dof": round(float(rmse), 4),
        "ate_scale": round(float(scale), 4),
        "n_keyframes_final": st["n_kf"],
        "map_grew_past_initial_capacity": bool(smap.max_kf > 256),
        "max_kf_capacity_final": int(smap.max_kf),
        "n_points_final": st["n_pt"],
        "n_loops_closed": st["n_loops_closed"],
        "loop_events": loop_events,
        "nuisances": nuis is not None,
        "track_wall_s": round(track_s, 1),
        "track_fps_excl_render": round(n / track_s, 2),
        "mapping_drain_s": round(drain_s, 1),
        "render_s": round(t_render, 1),
        "ba_dropped": st["ba_dropped"],
        "platform": "cuda" if device.startswith("cuda") else "cpu",
        "device": device_label(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=DESIGN_FRAMES)
    ap.add_argument("--out", default=str(BUILD_DIR / "longrun.json"))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--no-nuisance", action="store_true",
                    help="clean renders (drift may be too small for any "
                         "loop to present)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = run(args.frames, device, args.batch, not args.no_nuisance)
    print(json.dumps(out, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    n = args.frames
    if not out["frames_ok"] > 0.9 * n:
        raise RuntimeError(f"only {out['frames_ok']}/{n} frames OK")
    if not out["ate_rmse_7dof"] < 0.25:
        raise RuntimeError(f"ATE {out['ate_rmse_7dof']}")
    return out


if __name__ == "__main__":
    main()
