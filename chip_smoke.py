"""Chip smoke test: drive the PyTorch port's monocular VO path on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the hand-written CUDA kernels from ygz_tpu_torch/csrc/;
  2. check each kernel against its plain PyTorch version on the card
     (bit-exact) at the shapes the main path gives it, and time both;
  3. render an EuRoC-cadence 752x480, f=458 sequence of 160 frames (numpy),
     with one sudden exposure drop, and run System.track_monocular over it
     on the card; count kernel launches;
  4. check the result: frames OK after init, new keyframes, the feature
     fallback ladder recovering the under-exposed frame, 7-DoF ATE against
     the ground truth, and the frame step on the card against the same step
     on the CPU for a few frames.
The last line is {"ok": true, "device": {...}}. Needs CUDA; imports nothing
of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H, F = 752, 480, 458.0
N_FRAMES = 160
# an auto-exposure jump: frame 80 comes out at 0.4x brightness. Direct
# tracking (photometric) loses it and the feature fallback ladder (ORB,
# invariant to it) must recover the pose.
DARK_FRAME, DARK_GAIN = 80, 0.4
LEVEL_SHAPES = [(480, 752), (240, 376), (120, 188), (60, 94)]


def euroc_pose(i):
    """Drone-like ~1 m/s at 20 fps: 5 cm + gentle yaw/pitch per frame (the
    JAX package's bench.py sequence)."""
    from ygz_tpu_torch.geometry.lie import so3_exp
    import torch

    w = np.array([0.04 * np.sin(i * 0.13), 0.12 * np.sin(i * 0.21), 0.0],
                 np.float32)
    R = so3_exp(torch.as_tensor(w)).numpy()
    c = np.array([0.05 * i, 0.25 * np.sin(i * 0.09), 0.3 * np.sin(i * 0.05)],
                 np.float32)
    return R, (-R @ c).astype(np.float32)


def render_sequence(n):
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    # the texture must cover the whole run (x reaches 0.05 * n units plus
    # the view's half-span at 60 px per unit)
    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=3000)
    poses = [euroc_pose(i) for i in range(n)]
    frames = [scene.render_u8(R, t) for R, t in poses]
    if n > DARK_FRAME:
        frames[DARK_FRAME] = (frames[DARK_FRAME] * DARK_GAIN).astype(np.uint8)
    return scene, poses, frames


def time_cuda(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_fast_kernel(frame):
    """Kernel vs plain version on the four pyramid levels of a real frame
    at both thresholds of the path; returns the kernel's record."""
    import torch
    from ygz_tpu_torch.ops import fast
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked
    from ygz_tpu_torch.ops.image import unstack_pyramid

    stack = build_pyramid_stacked(torch.as_tensor(frame, device="cuda"),
                                  None, 4)
    levels = [lv.contiguous() for lv in unstack_pyramid(stack, 4, height=H)]
    if [tuple(lv.shape) for lv in levels] != LEVEL_SHAPES:
        raise RuntimeError(f"level shapes {[lv.shape for lv in levels]}")
    max_err = 0.0
    rows = []
    for lv in levels:
        for th in (20.0, 7.0):
            got = fast.fast_score_map(lv, th)
            want = fast.fast_score_map_torch(lv, th)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                raise RuntimeError(f"fast_score kernel differs from the plain "
                                   f"version at {tuple(lv.shape)} th={th}: "
                                   f"max |err| {err}")
            if int((got > 0).sum()) == 0:
                raise RuntimeError(f"no corners at {tuple(lv.shape)} th={th}")
        ms = time_cuda(lambda: fast.fast_score_map(lv, 20.0), 200)
        plain_ms = time_cuda(lambda: fast.fast_score_map_torch(lv, 20.0), 50)
        rows.append((tuple(lv.shape), ms, plain_ms))
        print(f"fast_score {lv.shape[0]}x{lv.shape[1]} th=20: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms (bit-exact at th 20, 7)")
    return {"name": "fast_score", "route": "cuda",
            "source": "ygz_tpu_torch/csrc/fast_score.cu",
            "replaces": "ygz_tpu/ops/pallas_fast.py:76",
            "max_abs_err": max_err, "ms": rows[0][1], "plain_ms": rows[0][2]}


def run_main_path(frames, device):
    """System.track_monocular over the frames; returns (system, states,
    frames on which the fallback ladder ran, seconds)."""
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import System, Sensor
    from ygz_tpu_torch.frontend.tracker import TrackerConfig

    cam = Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)
    cfg = TrackerConfig(enable_loop_closing=False,
                        enable_relocalization=False, async_mapping=False)
    system = System(cam, Sensor.MONOCULAR, config=cfg, device=device)
    states, ladder = [], []
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        states.append(system.track_monocular(img, i * 0.05)[0])
        if "fb_motion" in system.tracker.debug:
            ladder.append(i)
    return system, states, ladder, time.perf_counter() - t0


def check_result(system, states, ladder, poses):
    """Frames OK after init, keyframes, the fallback ladder's recovery of
    the dark frame, 7-DoF ATE."""
    from ygz_tpu_torch.eval.ate import ate_rmse

    if "OK" not in states:
        raise RuntimeError("the tracker never initialized")
    first = states.index("OK")
    after = states[first:]
    frac_ok = sum(s == "OK" for s in after) / len(after)
    n_new_kf = system.map.n_kf - 2
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite poses in the trajectory")
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    print(f"init at frame {first}; frames OK after init: "
          f"{sum(s == 'OK' for s in after)}/{len(after)} ({frac_ok:.3f}); "
          f"last frame {states[-1]}")
    print(f"keyframes: {system.map.n_kf} created ({n_new_kf} beyond the "
          f"initial two), {int(system.map.kf_valid[:system.map.n_kf].sum())} "
          f"alive; map points {int(system.map.pt_valid[:system.map.n_pt].sum())}")
    print(f"ATE RMSE (7-DoF aligned, {len(est)} poses): {rmse:.5f} over a "
          f"{length:.3f} path ({100 * rmse / length:.3f}%)")
    print(f"fallback ladder ran on frames {ladder}: "
          f"{[states[i] for i in ladder]}")
    if DARK_FRAME not in ladder or states[DARK_FRAME] != "OK":
        raise RuntimeError(f"the fallback ladder did not recover the dark "
                           f"frame {DARK_FRAME}")
    if frac_ok < 0.8 or states[-1] != "OK":
        raise RuntimeError(f"tracking: {frac_ok:.3f} of frames OK after init, "
                           f"last frame {states[-1]}")
    if n_new_kf < 3:
        raise RuntimeError(f"only {n_new_kf} keyframes beyond the initial two")
    if not rmse < 0.03 * length:
        raise RuntimeError(f"ATE {rmse:.5f} >= 3% of the path ({length:.3f})")


def check_step_vs_cpu(system, frames):
    """The frame step on the card against the same step on the CPU, from
    the tracker's final carry and cache, over the given frames."""
    import torch
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.frontend.framestep import (FrameCarry, frame_step,
                                                  unpack_out)

    tr = system.tracker
    cap = tr.cfg.max_track
    pred = tr._no_pred
    carries = {"cuda": tr._carry,
               "cpu": FrameCarry(*(a.cpu() for a in tr._carry))}
    caches = {"cuda": tr._snap[1], "cpu": tr._snap[1].cpu()}
    worst_rot = worst_t = 0.0
    worst_mask = 1.0
    for img in frames:
        outs = {}
        for dev in ("cuda", "cpu"):
            carries[dev], packed = frame_step(
                torch.as_tensor(img, device=dev), carries[dev], caches[dev],
                pred.to(dev), None, tr.intr)
            outs[dev] = unpack_out(packed.cpu().numpy(), cap)
        a, b = outs["cuda"], outs["cpu"]
        worst_rot = max(worst_rot, rotation_angle_deg(a.R, b.R))
        worst_t = max(worst_t, float(np.abs(a.t - b.t).max()))
        worst_mask = min(worst_mask, float((a.tracked == b.tracked).mean()),
                         float((a.visible == b.visible).mean()))
    print(f"frame step cuda vs cpu over {len(frames)} frames: rotation "
          f"{worst_rot:.2e} deg, translation {worst_t:.2e}, masks "
          f"{worst_mask:.4f} equal")
    # float32 sums run in another order on the card (and index_add_ uses
    # atomics): poses agree to ~1e-5; 1e-3 leaves room for a KLT point
    # that flips at its convergence threshold
    if worst_rot > 0.05 or worst_t > 1e-3 or worst_mask < 0.99:
        raise RuntimeError("frame step on the card disagrees with the CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    import ygz_tpu_torch  # noqa: F401  (pins float32: TF32 off)
    from ygz_tpu_torch.ops import fast
    from ygz_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.build("fast_score", verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scene, poses, frames = render_sequence(N_FRAMES + 3)
    print(f"rendered {len(frames)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    record = check_fast_kernel(frames[0])

    fast.fast_score_map.launches = 0
    system, states, ladder, secs = run_main_path(frames[:N_FRAMES], "cuda")
    torch.cuda.synchronize()
    record["launches"] = fast.fast_score_map.launches
    print(f"main path: {N_FRAMES} frames in {secs:.2f} s "
          f"({1e3 * secs / N_FRAMES:.2f} ms/frame mean); fast_score "
          f"launches {record['launches']}")
    if record["launches"] == 0:
        raise RuntimeError("the main path never launched the fast_score "
                           "kernel")
    print(system.tracker.timer.report())
    check_result(system, states, ladder, poses[:N_FRAMES])
    check_step_vs_cpu(system, frames[N_FRAMES:])

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
