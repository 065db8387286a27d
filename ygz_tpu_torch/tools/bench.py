"""Tracking benchmark: the headline ``tracking_fps_per_chip`` JSON line.

Port of the JAX repository's ``bench.py``. Steady-state
``System.track_monocular_batch`` throughput over an EuRoC-cadence synthetic
752x480 sequence (drone-like ~1 m/s at 20 fps: 5 cm and ~0.025 rad of yaw
per frame): the whole per-frame system (pyramid, sparse alignment and
direct local-map tracking replayed as one CUDA graph per frame, host
bookkeeping) and the keyframe tail (extraction, triangulation, fusion,
local BA, culling, BoW, loop detection) on the async mapping worker, with
``TrackerConfig(async_mapping=True, track_batch=32)``. The first
``--warm`` frames are fed in clamped windows of one chunk; the timed ones in
slices of three chunks, then ``shutdown()`` is timed as
``mapping_drain_s``. ``device_pipeline_fps`` is the frame step alone over 12
chunks with each chunk read one behind.

Baseline: the reference tracks at ~20 ms per frame (~50 fps,
``BASELINE.md``); ``vs_baseline`` = fps / 50.

Prints ONE JSON line and writes it to ``--out``. The 7-DoF ATE of the timed
frames must stay under 3% of their path (the run fails otherwise); the
share of timed frames OK is printed beside the 0.95 bar, not held to it:
the mapping tails race the chunks in flight, so it moves with the threads'
timing (181/240 and 238/240 on the same code).

    python -m ygz_tpu_torch.tools.bench [--device cpu] [--frames 240]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple

import numpy as np

from . import centres, device_label, resolve_device, sync, tracked_centres
from ..utils.cuda_build import BUILD_DIR

W, H, F = 752, 480, 458.0
BATCH = 32
N_FRAMES = 240
WARM_FRAMES = 48
PIPELINE_CHUNKS = 12
BASELINE_FPS = 50.0
OK_BAR = 0.95        # frames OK of the timed ones (VERDICT.md item 3)
ATE_BOUND = 0.03     # 7-DoF ATE as a share of the timed path


def so3_np(w):
    """Rodrigues in numpy (float32), as the JAX bench renders its poses."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                  [-k[1], k[0], 0]], np.float32)
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * (K @ K)).astype(np.float32)


def euroc_pose(i):
    yaw = 0.12 * np.sin(i * 0.21)
    pitch = 0.04 * np.sin(i * 0.13)
    R = so3_np(np.array([pitch, yaw, 0.0], np.float32))
    c = np.array([0.05 * i, 0.25 * np.sin(i * 0.09),
                  0.3 * np.sin(i * 0.05)], np.float32)
    return R, (-R @ c).astype(np.float32)


def render_frames(total):
    """(frames [total, H, W] uint8, poses): SmoothScene seed 11 with a
    texture wide enough for the whole run (x reaches 0.05 * 288 = 14.4
    units, plus ~8.5 units of view half-span at 60 px per unit)."""
    from ..utils.synthetic import SmoothScene

    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=3000)
    poses = [euroc_pose(i) for i in range(total)]
    frames = np.stack([np.clip(scene.render(R, t), 0, 255).astype(np.uint8)
                       for R, t in poses])
    return frames, poses


def camera():
    from ..geometry.camera import Camera

    return Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)


class TimedRun(NamedTuple):
    system: object
    slices: list        # (frames, seconds) per timed slice
    secs: float         # timed window
    drain_s: float      # shutdown()
    t_start: float      # perf_counter at the timed window's start


def run_timed(frames, device, batch=BATCH, warm=WARM_FRAMES,
              instrument=None):
    """The timed loop: System(MONOCULAR, TrackerConfig(async_mapping=True,
    track_batch=batch)); frames[:warm] in clamped windows of `batch`, the
    rest in slices of 3 * batch, then shutdown(). `instrument(system)` is
    called before the first frame."""
    from ..frontend.tracker import TrackerConfig
    from ..system import Sensor, System

    system = System(camera(), Sensor.MONOCULAR, device=device,
                    config=TrackerConfig(async_mapping=True,
                                         track_batch=batch))
    if instrument is not None:
        instrument(system)
    frames = list(frames)
    ts = [i * 0.05 for i in range(len(frames))]
    for i in range(0, warm, batch):
        j = min(i + batch, warm)
        system.track_monocular_batch(frames[i:j], ts[i:j])
    sync(device)
    # slices of 3 chunks: within a slice track_batch resumes chunked
    # dispatch right after a fallback recovery
    step = 3 * batch
    slices = []
    t0 = time.perf_counter()
    i = warm
    while i < len(frames):
        t1 = time.perf_counter()
        n = len(system.track_monocular_batch(frames[i: i + step],
                                             ts[i: i + step]))
        slices.append((n, time.perf_counter() - t1))
        i += n
    secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    system.shutdown()
    return TimedRun(system, slices, secs, time.perf_counter() - t1, t0)


def device_pipeline_fps(device, batch=BATCH, n_chunks=PIPELINE_CHUNKS):
    """The frame step alone at B = batch (pyramid, sparse alignment, direct
    tracking, the carry chain), no host bookkeeping: n_chunks chunks of
    random frames against a 512-point cache through a FrameStepper, each
    chunk's outputs read one chunk behind. On the card every frame is a
    graph replay, the frames go up and the outputs come back through the
    stepper's pinned staging without blocking. Returns (fps, host launch
    calls of one chunk on the card, None on the CPU)."""
    import torch

    from ..frontend.framestep import build_pyramid_stacked, make_carry, \
        pack_cache_np
    from ..frontend.framestep_graph import FrameStepper
    from ..utils.profiling import launch_calls

    intr = (F, F, W / 2.0 - 0.5, H / 2.0 - 0.5)
    rng = np.random.default_rng(0)
    cap = 512
    imgs = np.stack([rng.uniform(0, 255, (H, W)).astype(np.uint8)
                     for _ in range(batch)])
    X = np.stack([rng.uniform(-2, 2, cap), rng.uniform(-1.5, 1.5, cap),
                  rng.uniform(4, 9, cap)], 1).astype(np.float32)
    uv = np.stack([intr[0] * X[:, 0] / X[:, 2] + intr[2],
                   intr[1] * X[:, 1] / X[:, 2] + intr[3]], 1).astype(
                       np.float32)
    cache = torch.as_tensor(pack_cache_np(
        X, np.ones(cap, bool),
        rng.uniform(0, 255, (cap, 20, 20)).astype(np.float32),
        uv, np.zeros(cap, np.int32),
        np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1)),
        np.zeros((cap, 3), np.float32)), device=device)
    pyr0 = build_pyramid_stacked(torch.as_tensor(imgs[0], device=device),
                                 None, 4)
    carry = make_carry(pyr0, np.eye(3), np.zeros(3), uv, X,
                       np.ones(cap, bool))
    stepper = FrameStepper(H, W, cap, intr, device=device)

    def chunk(carry):
        return stepper.step_batch(imgs, carry, cache)

    carry, outs_fn, _ = chunk(carry)
    outs_fn()
    pending = None
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        carry, outs_fn, _ = chunk(carry)
        if pending is not None:          # consume one chunk behind
            _ = pending().sum()
        pending = outs_fn
    _ = pending().sum()
    fps = n_chunks * batch / (time.perf_counter() - t0)
    calls = (launch_calls(lambda: chunk(carry)) if device.startswith("cuda")
             else None)
    return fps, calls


def summarize(run: TimedRun, poses, warm, pipeline, device):
    """The bench's JSON record of a timed run."""
    from ..eval.ate import ate_rmse

    system = run.system
    n_timed = sum(n for n, _ in run.slices)
    recs = list(system.trajectory)
    n_ok = sum(1 for rec in recs[warm:] if rec.state == "OK")
    pf_ms = np.asarray([s / n * 1e3 for n, s in run.slices])
    gt_c = centres(poses)
    est, gt = tracked_centres(system, gt_c, start=warm)
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite poses in the timed trajectory")
    rmse = (float(ate_rmse(est, gt, with_scale=True)[0]) if len(est) >= 3
            else float("nan"))
    path = np.asarray(gt_c[warm:])
    length = float(np.linalg.norm(np.diff(path, axis=0), axis=1).sum())
    stats = system.tracker.stats()
    fps = n_timed / run.secs
    pipeline_fps, calls = pipeline
    return {
        "metric": "tracking_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "p50_frame_ms": round(float(np.percentile(pf_ms, 50)), 2),
        "p90_frame_ms": round(float(np.percentile(pf_ms, 90)), 2),
        "max_frame_ms": round(float(pf_ms.max()), 2),
        "mapping_drain_s": round(run.drain_s, 3),
        "device_pipeline_fps": round(pipeline_fps, 2),
        "frames_ok": n_ok,
        "frames_timed": n_timed,
        "ok_fraction": round(n_ok / n_timed, 4),
        "ok_bar": OK_BAR,
        "ok_bar_met": bool(n_ok >= OK_BAR * n_timed),
        "frames_logged": len(recs),
        "n_keyframes": stats["n_kf"],
        "ate_rmse_7dof": round(rmse, 5),
        "path_length": round(length, 4),
        "ate_share_of_path": round(rmse / length, 5),
        "stage_ms": {k: round(v, 2) for k, v in stats["stage_ms"].items()},
        "launch_calls_per_chunk": calls,
        "device": device_label(device),
    }


def check(out):
    """The bench's gate: 7-DoF ATE of the timed frames < 3% of their path."""
    if not out["ate_rmse_7dof"] < ATE_BOUND * out["path_length"]:
        raise RuntimeError(f"bench: ATE {out['ate_rmse_7dof']} >= "
                           f"{ATE_BOUND:.0%} of the path "
                           f"({out['path_length']})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help="timed frames")
    ap.add_argument("--warm", type=int, default=WARM_FRAMES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--pipeline-chunks", type=int, default=PIPELINE_CHUNKS)
    ap.add_argument("--out", default=str(BUILD_DIR / "bench.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    frames, poses = render_frames(args.warm + args.frames)
    run = run_timed(frames, device, args.batch, args.warm)
    pipeline = device_pipeline_fps(device, args.batch, args.pipeline_chunks)
    out = summarize(run, poses, args.warm, pipeline, device)
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    check(out)
    return out


if __name__ == "__main__":
    main()
