"""Chip smoke test: drive the PyTorch port's SLAM on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the hand-written CUDA kernels from ygz_tpu_torch/csrc/;
  2. check each kernel against its plain PyTorch version on the card
     (bit-exact) at the shapes the main path gives it, and time both: the
     single-threshold FAST-10 map per pyramid level, and the fused
     extraction front (one launch per stacked pyramid) against the
     composite it replaced (two score launches per level + the eager
     merge and NMS), in turns in this call;
  3. render an EuRoC-cadence 752x480, f=458 sequence of 160 frames (numpy),
     with one sudden exposure drop, and run System.track_monocular over it
     on the card with the default configuration (BoW, relocalization and
     loop closing on, the shipped vocabulary); count kernel launches (one
     fused launch per extraction);
  4. check the result: frames OK after init, new keyframes, the feature
     fallback ladder recovering the under-exposed frame, 7-DoF ATE against
     the ground truth, every alive keyframe in the BoW index, and the frame
     step on the card against the same step on the CPU for a few frames;
  5. global BA on two copies of the final map, card vs CPU;
  6. relocalization: black frames until LOST, then an earlier view, which
     must relocalize near its true pose and keep tracking (kernel launches
     counted on this path too);
  7. PnP and Sim3 RANSAC on the same hypotheses, card vs CPU;
  8. loop correction at EuRoC size: a 13-keyframe chain whose last keyframe
     sees the first one's landmarks as drifted duplicates; compute_sim3 must
     recover the drift and correct() must close the seam and fuse them, the
     same on the card and on the CPU;
  9. stereo: System.track_stereo over 40 rectified pairs at the EuRoC stereo
     rig's geometry (752x480, f=435.2, bf=47.906), 20 fps; one-frame init,
     frames OK, metric ATE (6-DoF, no scale) and span, stereo observations
     in the BA problem, one fused FAST launch per extraction; then the
     disparity search of one keyframe's 1024 features, card vs CPU;
  10. RGB-D: the fused FAST front held bit-exact on the TUM camera's
     640x480 pyramid (frames 0 and 23); then System.track_rgbd over 46
     frames with depth maps at that camera's geometry (f=517.3, the virtual
     baseline), 30 fps; the same checks, depth-seeded points in every
     keyframe, and the first frame steps after the one-frame init, card vs
     CPU;
  11. mono-VI: System.track_mono_vi over 260 frames of the EuRoC cam0
     geometry along the JAX VI tests' trajectory (0.6 m/s, 20 fps) with its
     exact 200 Hz IMU and the default settings; two blank-frame outages (12
     frames with a corrupted accelerometer, then 2 s); VINS init, metric
     span, gravity, the recovery gate after dead-reckoning (and its
     re-anchor branch), the escalation past DR_MAX_S, recovery;
     then one pair optimization, one NavState window BA and the VINS
     initialization recorded from the run, card vs CPU.
The last line is {"ok": true, "device": {...}}. Needs CUDA; imports nothing
of JAX. `python3 chip_smoke.py --paths-only` builds the kernel and times
only the monocular, stereo and RGB-D paths (for comparing two trees in one
call).
"""
from __future__ import annotations

import collections
import contextlib
import copy
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
# relocalization: revisit the view of frame 120 after a blackout; the bound
# on the recovered camera centre is 1% of the path (~0.083 on 8.33)
REVISIT, RELOC_BOUND = 120, 0.01
LEVEL_SHAPES = [(480, 752), (240, 376), (120, 188), (60, 94)]
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# operations per pixel of the kernels' arithmetic (csrc/fast_score.cu): the
# arc test is 16 differences, the side test (4 min, 3 max, a compare), 16
# sign flips and the sliding minimum (44 min + 15 max); a threshold is a
# subtract, a compare and an add; the merge a compare, an add and a select;
# the separable NMS 5 max, a compare and a select
ARC_OPS, TH_OPS, MERGE_OPS, NMS_OPS = 16 + 8 + 16 + 59, 3, 3, 7
# the stereo and RGB-D phases: the EuRoC stereo rig (examples/
# stereo_euroc.py: f, bf = baseline * f) and the TUM fr1 camera (examples/
# rgbd_tum.py: fx; its distortion dropped, as the renderer draws
# undistorted views), each centred on the synthetic scene
STEREO_F, STEREO_BF = 435.2046959714599, 47.90639384423901
TUM_W, TUM_F = 640, 517.306408
# cut from 80 and 92 to keep the whole smoke near half its time limit
# with the mono-VI phase; 46 > kf_max_gap: RGB-D makes >= 1 keyframe
# beyond KF 0 whatever its inlier counts
N_STEREO_FRAMES, N_RGBD_FRAMES = 40, 46
# mono-VI: the JAX VI tests' trajectory (ygz_tpu_torch/utils/synthetic.py
# pose_fn) at 20 fps. VINS init needs its 5 s chain (~frame 102) and may be
# rejected at a few keyframes, so the first outage starts at 150: 12 blank
# frames with the accelerometer corrupted by N(0, 4 m/s^2) from seed 7;
# the second is 40 blank frames (2 s, twice DR_MAX_S)
N_VI_FRAMES, VI_FPS = 260, 20.0
VI_OUT1, VI_OUT2 = (150, 162), (190, 230)


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
    """Mean ms per call by CUDA events over `iters` calls after a warm-up
    (for a launch through ctypes this is the host's issue rate once it
    exceeds the device time)."""
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


def device_time(fn, iters):
    """(device ms per call, device kernels per call) by torch.profiler over
    `iters` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in dev)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return 1e-3 * us / iters, sum(e.count for e in dev) / iters


def bound(n_bytes, n_ops):
    """(least ms on the card, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def interior(h, w):
    """Pixels off the 3-px frame, the ones that run the arc test."""
    return max(h - 6, 0) * max(w - 6, 0)


def stacked_pyramid(frame):
    import torch
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked

    return build_pyramid_stacked(torch.as_tensor(frame, device="cuda"), None,
                                 4)


def check_fast_kernel(frame):
    """Single-threshold kernel vs plain version on the four pyramid levels
    of a real frame at both thresholds of the extractor; returns the
    kernel's record (times at level 0, every level printed)."""
    import torch
    from ygz_tpu_torch.ops import fast
    from ygz_tpu_torch.ops.image import unstack_pyramid

    levels = [lv.contiguous()
              for lv in unstack_pyramid(stacked_pyramid(frame), 4, height=H)]
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
        h, w = lv.shape
        row = {"shape": [h, w],
               "event_ms": time_cuda(lambda: fast.fast_score_map(lv, 20.0),
                                     200),
               "plain_event_ms": time_cuda(
                   lambda: fast.fast_score_map_torch(lv, 20.0), 50),
               "ms": device_time(lambda: fast.fast_score_map(lv, 20.0),
                                 200)[0],
               "plain_ms": device_time(
                   lambda: fast.fast_score_map_torch(lv, 20.0), 20)[0]}
        row["bound_ms"], row["bound_by"] = bound(
            8 * h * w, interior(h, w) * (ARC_OPS + TH_OPS))
        rows.append(row)
        print(f"fast_score {h}x{w} th=20: device {1e3 * row['ms']:.3f} us "
              f"(bound {1e3 * row['bound_ms']:.3f} us by {row['bound_by']}, "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it), plain "
              f"{1e3 * row['plain_ms']:.3f} us; CUDA events per call "
              f"{row['event_ms']:.5f} ms kernel, {row['plain_event_ms']:.5f} "
              f"ms plain (bit-exact at th 20, 7)")
    return {"name": "fast_score", "route": "cuda",
            "source": "ygz_tpu_torch/csrc/fast_score.cu",
            "replaces": "ygz_tpu/ops/pallas_fast.py:76",
            "max_abs_err": max_err, "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
            "event_ms": rows[0]["event_ms"],
            "bound_ms": rows[0]["bound_ms"],
            "bound_us": 1e3 * rows[0]["bound_ms"],
            "bound_by": rows[0]["bound_by"], "library_ms": None,
            "levels": rows}


def composite_front(stack, height):
    """The extraction front as the extractor ran it before the fused
    kernel: per level two single-threshold launches, the eager merge and
    nonmax_3x3, stacked like the fused output."""
    import torch
    from ygz_tpu_torch.ops import fast
    from ygz_tpu_torch.ops.image import stack_rows, unstack_pyramid

    out = torch.zeros_like(stack)
    offs, _ = stack_rows(height, stack.shape[1], 4)
    for o, lv in zip(offs, unstack_pyramid(stack, 4, height=height)):
        img = lv.contiguous()
        hi = fast.fast_score_map(img, 20.0)
        lo = fast.fast_score_map(img, 7.0)
        out[o: o + img.shape[0], : img.shape[1]] = fast.nonmax_3x3(
            torch.where(hi > 0, hi + 1000.0, lo))
    return out


def hold_fast_corners(frame, label):
    """Fused front vs its plain version (and vs the composite) on the
    stacked pyramid of one frame, at the frame's own size, bit-exact;
    returns the max |err| against the plain version."""
    import torch
    from ygz_tpu_torch.ops import fast

    height = frame.shape[0]
    stack = stacked_pyramid(frame)
    got = fast.fast_corner_maps(stack, height, 4, 20.0, 7.0)
    want = fast.fast_corner_maps_torch(stack, height, 4, 20.0, 7.0)
    old = composite_front(stack, height)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.equal(got, want) and torch.equal(got, old)):
        raise RuntimeError(f"fast_corners kernel differs on {label}: max "
                           f"|err| {err} against the plain version")
    n_hi = int((got > 1000).sum())
    n_lo = int(((got > 0) & (got <= 1000)).sum())
    print(f"fast_corners {label} ({frame.shape[1]}x{height}): bit-exact "
          f"against the plain version and the composite; {n_hi} high- and "
          f"{n_lo} low-threshold corners after NMS")
    if n_hi + n_lo == 0:
        raise RuntimeError(f"no corners on {label}")
    return err


def check_fast_corners(frames):
    """hold_fast_corners on frame 0 and the dark frame; then the composite
    and the fused launch timed in turns; returns the record."""
    from ygz_tpu_torch.ops import fast

    max_err = max(hold_fast_corners(frames[i], f"frame {i}")
                  for i in (0, DARK_FRAME))
    stack = stacked_pyramid(frames[0])
    fused = lambda: fast.fast_corner_maps(stack, H, 4, 20.0, 7.0)  # noqa: E731
    comp = lambda: composite_front(stack, H)  # noqa: E731
    ev = [time_cuda(f, 200) for f in (comp, fused, fused, comp)]
    dev = [device_time(f, 200) for f in (comp, fused, fused, comp)]
    plain_ms, plain_n = device_time(
        lambda: fast.fast_corner_maps_torch(stack, H, 4, 20.0, 7.0), 20)
    pixels = sum(h * w for h, w in LEVEL_SHAPES)
    ops = (sum(interior(h, w) for h, w in LEVEL_SHAPES)
           * (ARC_OPS + 2 * TH_OPS + MERGE_OPS) + pixels * NMS_OPS)
    # the level pixels read once; the whole stacked map (pad zeros
    # included) written once
    n_bytes = 4 * (pixels + stack.numel())
    bound_ms, bound_by = bound(n_bytes, ops)
    ms = 0.5 * (dev[1][0] + dev[2][0])
    comp_ms = 0.5 * (dev[0][0] + dev[3][0])
    print(f"fast_corners vs composite in turns (composite, fused, fused, "
          f"composite): CUDA events {[round(e, 5) for e in ev]} ms per "
          f"extraction; device {[round(1e3 * d[0], 3) for d in dev]} us; "
          f"device kernels per extraction {[d[1] for d in dev]}")
    print(f"fast_corners: device {1e3 * ms:.3f} us per extraction, bound "
          f"{1e3 * bound_ms:.3f} us by {bound_by} ({n_bytes} B, {ops} "
          f"operations; {100 * bound_ms / ms:.1f}% of it); composite "
          f"{1e3 * comp_ms:.3f} us over {dev[0][1]:.0f} kernels; plain "
          f"version {1e3 * plain_ms:.3f} us over {plain_n:.0f} kernels")
    return {"name": "fast_corners", "route": "cuda",
            "source": "ygz_tpu_torch/csrc/fast_score.cu",
            "replaces": "ygz_tpu/ops/pallas_fast.py:76",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "event_ms": 0.5 * (ev[1] + ev[2]),
            "composite_ms": comp_ms, "composite_event_ms": 0.5 * (ev[0]
                                                                  + ev[3]),
            "composite_launches_per_extraction": dev[0][1],
            "launches_per_extraction": dev[1][1],
            "bound_ms": bound_ms, "bound_us": 1e3 * bound_ms,
            "bound_by": bound_by, "library_ms": None}


@contextlib.contextmanager
def counted_extractions():
    """Counts OrbExtractor calls (keyframe extraction included) while the
    block runs: one list entry per call, the name of the calling function
    (the bootstrap, keyframe extraction, the fallback ladder,
    relocalization)."""
    from ygz_tpu_torch.frontend.extractor import OrbExtractor

    calls = []
    real = OrbExtractor.__call__

    def counted(self, *args, **kw):
        calls.append(sys._getframe(1).f_code.co_name)
        return real(self, *args, **kw)

    OrbExtractor.__call__ = counted
    try:
        yield calls
    finally:
        OrbExtractor.__call__ = real


def euroc_camera():
    from ygz_tpu_torch.geometry.camera import Camera

    return Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)


def run_main_path(frames, device, cfg=None):
    """System.track_monocular over the frames (default TrackerConfig unless
    given); returns (system, states, frames on which the fallback ladder
    ran, seconds)."""
    from ygz_tpu_torch.system import System, Sensor

    system = System(euroc_camera(), Sensor.MONOCULAR, config=cfg,
                    device=device)
    states, ladder = [], []
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        states.append(system.track_monocular(img, i * 0.05)[0])
        if "fb_motion" in system.tracker.debug:
            ladder.append(i)
    return system, states, ladder, time.perf_counter() - t0


def check_result(system, states, ladder, poses):
    """Frames OK after init, keyframes, the fallback ladder's recovery of
    the dark frame, 7-DoF ATE, the BoW index. Returns the 7-DoF alignment
    (s, R, t) of the estimated camera centres onto the ground truth and the
    path length."""
    from ygz_tpu_torch.eval.ate import ate_rmse, horn_align

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
    tr = system.tracker
    smap = system.map
    n = smap.n_kf
    alive = smap.kf_valid[:n]
    indexed = tr.bow_index.kf_valid[:n]
    print(f"BoW index: {int(indexed.sum())} keyframes for {int(alive.sum())} "
          f"alive; loop detect calls {tr.loop_closer.n_detect}, loops closed "
          f"{tr.n_loops_closed}")
    if (alive & ~indexed).any() or (indexed & ~alive).any():
        raise RuntimeError(f"BoW index {np.nonzero(indexed)[0]} != alive "
                           f"keyframes {np.nonzero(alive)[0]}")
    if tr.loop_closer.n_detect != n - 2:
        raise RuntimeError(f"{tr.loop_closer.n_detect} detect calls for "
                           f"{n - 2} new keyframes")
    return horn_align(est, gt, with_scale=True), length


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


def check_global_ba(system):
    """Global BA on two copies of the final map, on the card and on the
    CPU: keyframe rotations within 0.01 deg; translations and points within
    1e-3 once the CPU map is brought to the card map's scale. Only
    keyframe 0 is fixed (the JAX package's gauge), so the monocular scale
    is free, and the two devices' float32 sums, in another order, settle
    it up to ~1e-3 apart, which alone moves a point 2 units out by 2e-3;
    the scale must agree within 1e-2."""
    from ygz_tpu_torch.backend.mapping import LocalMapper
    from ygz_tpu_torch.eval.ate import rotation_angle_deg

    smap = system.map
    pyr = smap.kf_pyr
    smap.kf_pyr = [None] * len(pyr)        # global BA reads no pyramid
    maps = [copy.deepcopy(smap), copy.deepcopy(smap)]
    smap.kf_pyr = pyr
    ms = []
    for dev, m in zip(("cuda", "cpu"), maps):
        mapper = LocalMapper(system.cam, device=dev)
        t0 = time.perf_counter()
        mapper.global_ba(m)
        ms.append(1e3 * (time.perf_counter() - t0))
    a, b = maps
    kfs = np.nonzero(a.kf_valid[: a.n_kf])[0]
    pts = np.nonzero(a.pt_valid[: a.n_pt])[0]
    if not (np.isfinite(a.pt_xyz[pts]).all() and np.isfinite(a.kf_t).all()):
        raise RuntimeError("global BA on the card gave non-finite values")
    rot = max(rotation_angle_deg(a.kf_R[k], b.kf_R[k]) for k in kfs)
    raw = (float(np.abs(a.kf_t[kfs] - b.kf_t[kfs]).max()),
           float(np.abs(a.pt_xyz[pts] - b.pt_xyz[pts]).max()))
    # the one free gauge: the scale taking the CPU map onto the card map
    s = float((a.kf_t[kfs] * b.kf_t[kfs]).sum() / (b.kf_t[kfs] ** 2).sum())
    dt = float(np.abs(a.kf_t[kfs] - s * b.kf_t[kfs]).max())
    dp = float(np.abs(a.pt_xyz[pts] - s * b.pt_xyz[pts]).max())
    moved = float(np.abs(a.pt_xyz[pts] - smap.pt_xyz[pts]).max())
    print(f"global BA ({len(kfs)} keyframes, {len(pts)} points): card "
          f"{ms[0]:.2f} ms, CPU {ms[1]:.2f} ms; card vs CPU: rotation "
          f"{rot:.2e} deg; scale card/CPU {s:.7f}; at that scale "
          f"translation {dt:.2e}, points {dp:.2e} (raw {raw[0]:.2e}, "
          f"{raw[1]:.2e}; points moved up to {moved:.2e})")
    if rot > 0.01 or abs(s - 1.0) > 1e-2 or dt > 1e-3 or dp > 1e-3:
        raise RuntimeError("global BA on the card disagrees with the CPU")


def check_relocalization(system, frames, poses, align, length):
    """Three black frames must lose the tracker; the view of frame REVISIT
    must then relocalize it within 3 tries, its camera centre (through the
    main run's 7-DoF alignment) within RELOC_BOUND of the path of the true
    one, and the 10 frames after it must all track. Returns the fused FAST
    launches on this path."""
    from ygz_tpu_torch.ops import fast

    ts = len(system.trajectory) * 0.05
    fast.fast_score_map.launches = 0
    fast.fast_corner_maps.launches = 0
    black = np.zeros_like(frames[0])
    for _ in range(3):
        state = system.track_monocular(black, ts)[0]
        ts += 0.05
    if state != "LOST":
        raise RuntimeError(f"black frames left the tracker {state}")
    attempts = []
    for _ in range(3):
        before = fast.fast_corner_maps.launches
        t0 = time.perf_counter()
        state, T = system.track_monocular(frames[REVISIT], ts)
        attempts.append((1e3 * (time.perf_counter() - t0),
                         fast.fast_corner_maps.launches - before))
        ts += 0.05
        if state == "OK":
            break
    else:
        raise RuntimeError(f"no relocalization in 3 tries on the view of "
                           f"frame {REVISIT}")
    s, R, t = align
    c_est = s * R @ (-T[:3, :3].T @ T[:3, 3]) + t
    R_gt, t_gt = poses[REVISIT]
    err = float(np.linalg.norm(c_est - (-R_gt.T @ t_gt)))
    forward = []
    for k in range(1, 11):
        forward.append(system.track_monocular(frames[REVISIT + k], ts)[0])
        ts += 0.05
    launches = fast.fast_corner_maps.launches
    print(f"relocalization: LOST after 3 black frames; OK on try "
          f"{len(attempts)} at the view of frame {REVISIT}: camera centre "
          f"{err:.5f} from the truth (bound {RELOC_BOUND * length:.5f}); "
          f"attempts (ms, fused FAST launches) {attempts}; next 10 frames "
          f"{forward}; fused FAST launches on this path {launches}, "
          f"single-threshold {fast.fast_score_map.launches}; "
          f"'relocalize' stage mean "
          f"{system.tracker.timer.mean_ms()['relocalize']:.2f} ms")
    if err > RELOC_BOUND * length:
        raise RuntimeError(f"relocalized {err:.5f} from the true pose")
    if forward != ["OK"] * 10:
        raise RuntimeError(f"tracking after relocalization: {forward}")
    if any(a[1] < 1 for a in attempts) or fast.fast_score_map.launches:
        raise RuntimeError("a relocalization attempt did not go through "
                           "the fused fast_corners kernel")
    return launches


def stereo_sequence(n):
    """n rectified u8 pairs along euroc_pose (20 fps) on the JAX stereo
    tests' scene (SmoothScene seed 22)."""
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    scene = SmoothScene(seed=22, w=W, h=H, f=STEREO_F, tex_size=2000)
    poses = [euroc_pose(i) for i in range(n)]
    pairs = [tuple(np.clip(v, 0, 255).astype(np.uint8)
                   for v in scene.render_pair(R, t, STEREO_BF / STEREO_F))
             for R, t in poses]
    return poses, pairs


def rgbd_sequence(n):
    """n u8 frames with their metric depth maps on the JAX RGB-D test's
    scene (SmoothScene seed 13): the EuRoC path at two-thirds of its step
    per frame, as a 30 fps camera moving as fast would see it."""
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    scene = SmoothScene(seed=13, w=TUM_W, h=H, f=TUM_F, tex_size=2000)
    poses = [euroc_pose(2.0 * i / 3.0) for i in range(n)]
    return poses, [(scene.render_u8(R, t), scene.depth(R, t))
                   for R, t in poses]


def run_depth_path(sensor, frames, device):
    """System.track_stereo ("stereo": (left, right) pairs, 20 fps) or
    System.track_rgbd ("rgbd": (image, depth), 30 fps) over the frames
    with the default TrackerConfig. Returns (system, states, depth points
    seeded per keyframe, seconds)."""
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System

    if sensor == "stereo":
        cam = Camera.make(STEREO_F, STEREO_F, W / 2.0 - 0.5, H / 2.0 - 0.5,
                          W, H, bf=STEREO_BF)
        system = System(cam, Sensor.STEREO, device=device)
        track, dt = system.track_stereo, 0.05
    else:
        cam = Camera.make(TUM_F, TUM_F, TUM_W / 2.0 - 0.5, H / 2.0 - 0.5,
                          TUM_W, H)
        system = System(cam, Sensor.RGBD, device=device)
        track, dt = system.track_rgbd, 1.0 / 30.0
    tr = system.tracker
    seeded = {}
    seed = tr._create_depth_points

    def counted(smap, kf, pyr):
        seeded[kf] = seed(smap, kf, pyr)
        return seeded[kf]

    tr._create_depth_points = counted
    states = []
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(frames):
        states.append(track(a, b, i * dt)[0])
    return system, states, seeded, time.perf_counter() - t0


def check_depth_result(sensor, system, states, seeded, poses):
    """One-frame init, frames OK, metric ATE (6-DoF aligned without scale)
    and span against the ground truth with the JAX tests' bounds, and the
    depth sources: stereo observations that reach the BA problem (stereo),
    depth-seeded points in every keyframe and the keyframes beyond KF 0
    that kf_max_gap forces (RGB-D)."""
    from ygz_tpu_torch.eval.ate import ate_rmse

    frac_ok = states.count("OK") / len(states)
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    if not np.isfinite(est).all():
        raise RuntimeError(f"{sensor}: non-finite poses in the trajectory")
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    span = float(np.linalg.norm(est[-1] - est[0])
                 / np.linalg.norm(gt[-1] - gt[0]))
    smap = system.map
    kfs = np.nonzero(smap.kf_valid[: smap.n_kf])[0].tolist()
    o_ur = smap.observations(kfs, smap.points_in_kfs(kfs))[4]
    n_stereo = int((o_ur >= 0).sum())
    unseeded = [k for k in range(smap.n_kf) if not seeded.get(k)]
    ate_bound, span_bound = (0.033, 0.10) if sensor == "stereo" \
        else (0.04, 0.05)
    print(f"{sensor}: frame 0 {states[0]}; frames OK {states.count('OK')}/"
          f"{len(states)} ({frac_ok:.3f}); last frame {states[-1]}; "
          f"keyframes {smap.n_kf} ({len(kfs)} alive); map points "
          f"{int(smap.pt_valid[: smap.n_pt].sum())}; depth points seeded per "
          f"keyframe {[seeded.get(k, 0) for k in range(smap.n_kf)]}; stereo "
          f"(u, v, u_r) observations in the BA problem {n_stereo} of "
          f"{len(o_ur)}")
    print(f"{sensor}: metric ATE RMSE (6-DoF aligned, no scale, {len(est)} "
          f"poses) {rmse:.5f} over a {length:.3f} path "
          f"({100 * rmse / length:.3f}%, bound {100 * ate_bound:.1f}%); span "
          f"ratio {span:.5f} (bound 1 +- {span_bound})")
    if states[0] != "OK" or frac_ok < 0.9 or states[-1] != "OK":
        raise RuntimeError(f"{sensor} tracking: frame 0 {states[0]}, "
                           f"{frac_ok:.3f} OK, last {states[-1]}")
    if not rmse < ate_bound * length or abs(span - 1.0) > span_bound:
        raise RuntimeError(f"{sensor}: metric ATE {rmse:.5f} or span "
                           f"{span:.5f} out of bounds")
    if sensor == "stereo" and n_stereo <= 200:
        raise RuntimeError(f"stereo: {n_stereo} stereo observations in BA")
    forced = (len(states) - 1) // system.tracker.cfg.kf_max_gap
    if sensor == "rgbd" and (smap.n_kf - 1 < forced or unseeded):
        raise RuntimeError(f"rgbd: {smap.n_kf - 1} keyframes beyond KF 0, "
                           f"keyframes {unseeded} without depth points")


def check_stereo_match(system, pairs):
    """The disparity search of the newest keyframe's features (512 tracked
    + 512 new) against its frame's right image, card vs CPU: disparities
    within 1e-3 px where both accept, ok >= 99% equal. Returns the
    timings."""
    import torch
    from ygz_tpu_torch.ops.image import level0
    from ygz_tpu_torch.ops.stereo import stereo_match_features

    smap = system.map
    kf = max(k for k in range(smap.n_kf)
             if smap.kf_valid[k] and smap.kf_pyr[k] is not None)
    right = pairs[int(smap.kf_frame_id[kf])][1]
    args = {dev: (level0(smap.kf_pyr[kf], H).to(dev),
                  torch.as_tensor(right, dtype=torch.float32, device=dev),
                  torch.as_tensor(smap.kf_feat_uv[kf], device=dev),
                  torch.as_tensor(smap.kf_feat_valid[kf], device=dev))
            for dev in ("cuda", "cpu")}
    out, host_ms = {}, {}
    for dev in ("cuda", "cpu"):
        stereo_match_features(*args[dev])
        t0 = time.perf_counter()
        for _ in range(5):
            res = stereo_match_features(*args[dev])
            out[dev] = [a.cpu().numpy() for a in res]
        host_ms[dev] = 1e3 * (time.perf_counter() - t0) / 5
    (dg, og), (dc, oc) = out["cuda"], out["cpu"]
    both = og & oc
    gap = float(np.abs(dg - dc)[both].max()) if both.any() else 0.0
    same = float((og == oc).mean())
    fn = lambda: stereo_match_features(*args["cuda"])  # noqa: E731
    dev_ms, n_kernels = device_time(fn, 20)
    rec = {"n": len(dg), "valid": int(smap.kf_feat_valid[kf].sum()),
           "ok_card": int(og.sum()), "ok_cpu": int(oc.sum()),
           "max_disp_gap_px": gap, "ok_equal": same, "device_ms": dev_ms,
           "kernels_per_call": n_kernels, "event_ms": time_cuda(fn, 20),
           "host_ms": host_ms["cuda"], "cpu_ms": host_ms["cpu"]}
    print(f"stereo_match_features on keyframe {kf} ({rec['n']} features, "
          f"{rec['valid']} valid) card vs CPU: accepted {rec['ok_card']} / "
          f"{rec['ok_cpu']}, ok {same:.4f} equal, disparities {gap:.2e} px "
          f"apart where both accept; device {dev_ms:.4f} ms over "
          f"{n_kernels:.0f} kernels per call, CUDA events "
          f"{rec['event_ms']:.4f} ms, host {rec['host_ms']:.3f} ms per "
          f"call with its readback (CPU {rec['cpu_ms']:.3f} ms)")
    if gap > 1e-3 or same < 0.99 or rec["ok_card"] < 0.5 * rec["valid"]:
        raise RuntimeError("stereo_match_features on the card disagrees "
                           "with the CPU")
    return rec


def vi_sequence():
    """Frames and per-frame IMU of the mono-VI run: blank (128) frames in
    both outages, the first one's accelerometer corrupted."""
    from ygz_tpu_torch.utils.synthetic import SmoothScene, pose_fn, synth_imu

    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=3000)
    rng = np.random.default_rng(7)
    blank = np.full((H, W), 128, np.uint8)
    poses, frames, imus = [], [], []
    for i in range(N_VI_FRAMES):
        t = i / VI_FPS
        R, tt = pose_fn(t)
        poses.append((R, tt))
        dark = VI_OUT1[0] <= i < VI_OUT1[1] or VI_OUT2[0] <= i < VI_OUT2[1]
        frames.append(blank if dark else scene.render_u8(R, tt))
        imu = synth_imu((i - 1) / VI_FPS, t) if i > 0 else []
        if VI_OUT1[0] <= i < VI_OUT1[1]:
            imu = [(ts, om, ac + rng.normal(0, 4.0, 3).astype(np.float32))
                   for ts, om, ac in imu]
        imus.append(imu)
    return poses, frames, imus


def _map(x, fn, np_fn=None):
    """fn applied to every tensor (np_fn, where given, to every numpy
    array) of a nest of tuples, lists and dicts."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, np.ndarray) and np_fn is not None:
        return np_fn(x)
    if isinstance(x, dict):
        return {k: _map(v, fn, np_fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn, np_fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, fn, np_fn) for v in x)
    return x


class Recorder:
    """Wraps a function of the VI tracker's module and keeps host copies of
    its arguments at the calls `keep` accepts (only the latest with
    last=True), to replay them on the card and on the CPU."""

    def __init__(self, module, name, keep, last=False):
        self.module, self.name, self.keep = module, name, keep
        self.last = last
        self.real = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        if self.keep(self, args, kw):
            # copies: the map's pose arrays are views the BA rewrites
            call = _map((args, kw), lambda t: t.detach().cpu().clone(),
                        np.copy)
            self.calls = [call] if self.last else self.calls + [call]
        return self.real(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.real)


def run_vi_path(frames, imus, device, record=False):
    """System.track_mono_vi over the frames with the default settings.
    Returns (system, states, per-frame dead-reckoning / VINS debug, first
    VINS-ready frame, seconds, recorders)."""
    from ygz_tpu_torch.frontend import vi_tracker
    from ygz_tpu_torch.system import Sensor, System

    system = System(euroc_camera(), Sensor.MONO_VI, device=device)
    tr = system.tracker
    rec = {}
    if record:
        # the last pair optimization before the first outage, the first
        # NavState window BA at the full window, the accepted VINS init
        # (with the chain windows its preintegrations came from)
        rec = {"pair": Recorder(vi_tracker, "vio_pose_optimization_pair",
                                lambda r, a, k: tr.frame_id < VI_OUT1[0],
                                last=True),
               "ba": Recorder(vi_tracker, "vio_window_ba",
                              lambda r, a, k: not r.calls
                              and k["n_win"] == tr.W_CAP),
               "vins": Recorder(vi_tracker, "vins_initialize",
                                lambda r, a, k: True)}
        real_init = tr._try_vins_init

        def try_init():
            windows = [tr._kf_imu[k] for k in tr._kf_order[1:]]
            n = len(rec["vins"].calls)
            real_init()
            if len(rec["vins"].calls) > n:
                rec["vins"].calls[-1] += (windows,)
        tr._try_vins_init = try_init
    states, debug, ready_at = [], [], None
    t0 = time.perf_counter()
    try:
        for i, (img, imu) in enumerate(zip(frames, imus)):
            states.append(system.track_mono_vi(img, imu, i / VI_FPS)[0])
            debug.append({k: v for k, v in tr.debug.items()
                          if k.startswith(("dr_", "vins"))})
            if ready_at is None and tr.vio_ready:
                ready_at = i
    finally:
        for r in rec.values():
            r.restore()
    return system, states, debug, ready_at, time.perf_counter() - t0, rec


def check_vi_result(system, states, debug, ready_at, poses):
    """The JAX VI tests' bounds: VINS init (before the first outage),
    gravity, the metric span of the clean segment after init; after the
    corrupted first outage the recovery gate's decision (re-anchor exactly
    when the dead-reckoned state is more than DR_REANCHOR_GAP_M from the
    visual pose) and the error after recovery; bounded dead-reckoning and
    escalation in the second outage, recovery at the end. Then the
    re-anchor branch itself, on the run's tracker."""
    from ygz_tpu_torch.eval.ate import ate_rmse
    from ygz_tpu_torch.utils.synthetic import G_W

    tr = system.tracker
    est = np.array([-r.R.T @ r.t for r in system.trajectory])
    gt = np.array([-R.T @ t for R, t in poses])
    ok = np.array([s == "OK" for s in states])
    if not np.isfinite(est[ok]).all():
        raise RuntimeError("mono-VI: non-finite poses in the trajectory")
    a, b = VI_OUT1
    c, d = VI_OUT2
    print(f"mono-VI: VINS init at frame {ready_at} (scale "
          f"{tr.vins_scale}, bg {tr.bg}, ba {tr.ba}); frames OK "
          f"{int(ok.sum())}/{len(states)}; per segment: clean 0-{a - 1} "
          f"{int(ok[:a].sum())}/{a}, outage 1 {int(ok[a:b].sum())}/{b - a}, "
          f"clean {int(ok[b:c].sum())}/{c - b}, outage 2 "
          f"{int(ok[c:d].sum())}/{d - c}, clean {int(ok[d:].sum())}/"
          f"{len(states) - d}; keyframes {system.map.n_kf} "
          f"({int(system.map.kf_valid[: system.map.n_kf].sum())} alive)")
    if ready_at is None or ready_at >= a:
        raise RuntimeError(f"mono-VI: VINS init at {ready_at}, not before "
                           f"the first outage (frame {a})")
    g = tr.gravity_w
    cosg = float(np.dot(g, G_W) / (np.linalg.norm(g) * np.linalg.norm(G_W)))
    post = [i for i in range(ready_at + 3, a) if ok[i]]
    span = float(np.linalg.norm(est[post[-1]] - est[post[0]])
                 / np.linalg.norm(gt[post[-1]] - gt[post[0]]))
    rmse7, _ = ate_rmse(est[ok], gt[ok], with_scale=True)
    raw = float(np.sqrt((np.linalg.norm(est[ok] - gt[ok], axis=1) ** 2)
                        .mean()))
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())

    def median_err(lo, hi):
        """Median position error of the OK frames in [lo, hi) (the JAX
        dead-reckoning test's recovery measure)."""
        e = [float(np.linalg.norm(est[i] - gt[i]))
             for i in range(lo, hi) if ok[i]]
        return float(np.median(e)) if e else float("inf")

    gate = [i for i in range(b, c) if "dr_gap" in debug[i]]
    gap = debug[gate[0]]["dr_gap"] if gate else float("nan")
    reanchored = bool(gate) and "dr_reanchored" in debug[gate[0]]
    err1 = median_err(c - 10, c)
    escalated = [i for i in range(c, d) if "dr_escalated" in debug[i]]
    ok2 = int(ok[c:d].sum())
    tail_err = median_err(len(states) - 10, len(states))
    print(f"mono-VI: gravity {g} (cos {cosg:.5f} to the truth, bound "
          f"0.985); span over frames {post[0]}-{post[-1]} {span:.5f} "
          f"(bound 1 +- 0.12); ATE over {int(ok.sum())} OK frames: 7-DoF "
          f"{rmse7:.5f}, unaligned {raw:.5f} ({100 * raw / length:.3f}% of "
          f"the {length:.3f} path)")
    print(f"mono-VI: outage 1: recovery gate at frames {gate}, gap "
          f"{gap:.4f} m to the dead-reckoned state (re-anchor above "
          f"{tr.DR_REANCHOR_GAP_M}): re-anchored {reanchored}; median "
          f"position error of frames {c - 10}-{c - 1} {err1:.4f} m (bound "
          f"0.30); outage 2: {ok2}/{d - c} OK (bound 24), escalated at "
          f"frames {escalated}; last frame {states[-1]}; median position "
          f"error of the last 10 frames {tail_err:.4f} m (bound 0.30)")
    if cosg <= 0.985 or abs(span - 1.0) >= 0.12:
        raise RuntimeError("mono-VI: gravity or metric span out of bounds")
    if not gate or reanchored != (gap > tr.DR_REANCHOR_GAP_M):
        raise RuntimeError(f"mono-VI: the recovery gate after outage 1 "
                           f"(frames {gate}, gap {gap}, re-anchored "
                           f"{reanchored})")
    if not ok[c - 1] or err1 >= 0.30:
        raise RuntimeError(f"mono-VI: after outage 1 frame {c - 1} "
                           f"{states[c - 1]}, error {err1:.4f}")
    if ok2 > 24 or not escalated:
        raise RuntimeError(f"mono-VI: outage 2 {ok2} OK, escalations "
                           f"{escalated}")
    if states[-1] != "OK" or tail_err >= 0.30:
        raise RuntimeError(f"mono-VI: last frame {states[-1]}, tail error "
                           f"{tail_err:.4f}")

    # the re-anchor branch: the last frame's visual pose against a
    # dead-reckoned state 0.6 m away adopts the visual pose, unfused
    rec = system.trajectory[-1]
    R_vis, P_vis = tr._cam_to_body(rec.R, rec.t)
    tr._ns = (P_vis + np.float32([0.6, 0.0, 0.0]), tr._ns[1], tr._ns[2])
    tr._dr_frames, tr.debug = 1, {}
    none = np.zeros(0, np.int64)
    fused = tr._fuse_pose(rec.R, rec.t, none, np.zeros((0, 2)), none)
    moved = float(np.abs(tr._ns[0] - P_vis).max())
    print(f"mono-VI: forced 0.6 m dead-reckoning gap: re-anchored "
          f"{tr.debug.get('dr_reanchored')}, NavState {moved:.2e} from the "
          f"visual pose")
    if fused is not None or abs(tr.debug.get("dr_reanchored", 0.0) - 0.6) \
            > 1e-5 or moved > 1e-6:
        raise RuntimeError("mono-VI: the re-anchor branch did not adopt the "
                           "visual pose")


def check_vi_numerics(rec, vins_scale, devices=("cuda", "cpu")):
    """One pair optimization, one NavState window BA and the VINS
    initialization, recorded from the card run, replayed on the card and on
    the CPU: P within 1e-4, R within 1e-3 deg (pair), states within 1e-4
    (window BA), scale within 1e-4 relative (VINS init; the card's replay
    also within 1e-4 of the run's own scale). The card's pair optimization
    and window BA are profiled too: device time and kernels per call."""
    import torch
    from ygz_tpu_torch.backend.vio_optim import (vio_pose_optimization_pair,
                                                 vio_window_ba)
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.imu.preintegration import preintegrate
    from ygz_tpu_torch.imu.vins_init import vins_initialize

    def replay(fn, call):
        out, ms, prof = [], [], ""
        for dev in devices:
            a, k = _map(call, lambda t: t.to(dev))
            t0 = time.perf_counter()
            res = _map(fn(*a, **k), lambda t: t.cpu().numpy())
            out.append(res)
            ms.append(1e3 * (time.perf_counter() - t0))
            if dev == "cuda":
                dms, n = device_time(lambda: fn(*a, **k), 2)
                prof = f" (card: device {dms:.3f} ms over {n:.0f} kernels)"
        return out, ms, prof

    if not (rec["pair"].calls and rec["ba"].calls and rec["vins"].calls):
        raise RuntimeError(f"mono-VI: nothing recorded to replay: "
                           f"{[(k, len(r.calls)) for k, r in rec.items()]}")
    (g, c), ms, prof = replay(vio_pose_optimization_pair,
                              rec["pair"].calls[-1])
    dP = float(np.abs(g.P - c.P).max())
    dV = float(np.abs(g.V - c.V).max())
    dR = rotation_angle_deg(g.R, c.R)
    print(f"vio_pose_optimization_pair card vs CPU: P {dP:.2e}, V {dV:.2e}, "
          f"R {dR:.2e} deg, inliers {float((g.inliers == c.inliers).mean()):.4f}"
          f" equal; card {ms[0]:.1f} ms, CPU {ms[1]:.1f} ms{prof}")
    if dP > 1e-4 or dR > 1e-3:
        raise RuntimeError("the pair optimization on the card disagrees "
                           "with the CPU")
    (g, c), ms, prof = replay(vio_window_ba, rec["ba"].calls[0])
    gaps = [float(np.abs(a - b).max()) for a, b in zip(g[:5], c[:5])]
    W = rec["ba"].calls[0][1]["n_win"]
    print(f"vio_window_ba (W {W}) card vs CPU: P/V/R/bg/ba "
          f"{[f'{x:.2e}' for x in gaps]}, points "
          f"{float(np.abs(g.points - c.points).max()):.2e}, total chi2 "
          f"{float(g.total_chi2):.4f} / {float(c.total_chi2):.4f}; card "
          f"{ms[0]:.1f} ms, CPU {ms[1]:.1f} ms{prof}")
    if max(gaps) > 1e-4:
        raise RuntimeError("the NavState window BA on the card disagrees "
                           "with the CPU")
    (c_w, R_wc, _, _, Tbc), _, windows = rec["vins"].calls[-1]
    n = int(np.stack([w[3] for w in windows]).sum(-1).max())
    out, ms = [], []
    for dev in devices:
        stacked = [torch.as_tensor(np.stack(a), device=dev)
                   for a in zip(*windows)]

        def preints(bg):
            return preintegrate(*stacked, torch.as_tensor(
                np.asarray(bg, np.float32), device=dev),
                torch.zeros(3, device=dev), n_steps=n)
        t0 = time.perf_counter()
        out.append(vins_initialize(c_w, R_wc, preints(np.zeros(3)), preints,
                                   Tbc))
        ms.append(1e3 * (time.perf_counter() - t0))
    g, c = out
    rel = abs(g.scale / c.scale - 1.0)
    print(f"vins_initialize ({len(windows) + 1} keyframes) card vs CPU: "
          f"scale {g.scale:.6f} / {c.scale:.6f} ({rel:.2e} relative; the "
          f"run's {vins_scale:.6f}), "
          f"gravity {float(np.abs(g.gravity_w - c.gravity_w).max()):.2e}, bg "
          f"{float(np.abs(g.bg - c.bg).max()):.2e}; card {ms[0]:.1f} ms, CPU "
          f"{ms[1]:.1f} ms")
    if not (g.ok and c.ok) or rel > 1e-4 or abs(g.scale / vins_scale - 1.0) \
            > 1e-4:
        raise RuntimeError("VINS initialization on the card disagrees with "
                           "the CPU")


def run_counted(fast, label, fn):
    """Runs fn with every kernel's launch count set to 0 and the
    extractor's calls counted; checks one fused launch per extraction and
    no single-threshold launch. Returns (fn's result, fused launches)."""
    import torch

    fast.fast_score_map.launches = 0
    fast.fast_corner_maps.launches = 0
    with counted_extractions() as extractions:
        out = fn()
    torch.cuda.synchronize()
    fused = fast.fast_corner_maps.launches
    single = fast.fast_score_map.launches
    by = collections.Counter(extractions)
    print(f"{label}: {len(extractions)} extractions ({dict(by)}), "
          f"fast_corners launches {fused}, single-threshold fast_score "
          f"launches {single}")
    if not extractions or fused != len(extractions) or single:
        raise RuntimeError(f"{label} did not make exactly one fast_corners "
                           f"launch per extraction")
    return out, fused


def check_ransac():
    """PnP (512 matches) and Sim3 (200 pairs) RANSAC, 30% outliers each,
    on the same hypotheses (drawn once on a CPU generator) on the card and
    on the CPU: R within 0.01 deg, t and s within 1e-3, inlier masks >= 99%
    equal, and both recover the truth."""
    import torch
    from ygz_tpu_torch.backend.pnp import pnp_ransac
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.geometry.lie import so3_exp
    from ygz_tpu_torch.geometry.sim3 import sim3_ransac
    from ygz_tpu_torch.geometry.twoview import draw_samples

    rng = np.random.default_rng(5)
    g = torch.Generator()
    g.manual_seed(0)
    intr = (F, F, W / 2.0 - 0.5, H / 2.0 - 0.5)
    n, n_out = 512, 154
    R = so3_exp(torch.tensor([0.1, -0.15, 0.05])).numpy()
    t = np.array([0.3, -0.2, 0.4], np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], 1).astype(np.float32)
    Xc = X @ R.T + t
    uv = np.stack([F * Xc[:, 0] / Xc[:, 2] + intr[2],
                   F * Xc[:, 1] / Xc[:, 2] + intr[3]], 1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:n_out] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)
    idx = draw_samples(valid, 300, 4, g)
    out, ms = [], []
    for dev in ("cuda", "cpu"):
        args = (torch.as_tensor(X, device=dev), torch.as_tensor(uv, device=dev),
                valid.to(dev), intr)
        t0 = time.perf_counter()
        r = pnp_ransac(*args, samples=idx.to(dev))
        out.append([a.cpu().numpy() for a in r])
        ms.append(1e3 * (time.perf_counter() - t0))
    (ok_g, R_g, t_g, in_g, _), (ok_c, R_c, t_c, in_c, _) = out
    pnp = (rotation_angle_deg(R_g, R_c), float(np.abs(t_g - t_c).max()),
           float((in_g == in_c).mean()))
    pnp_truth = (rotation_angle_deg(R_g, R), float(np.abs(t_g - t).max()))
    print(f"PnP RANSAC card vs CPU: rotation {pnp[0]:.2e} deg, translation "
          f"{pnp[1]:.2e}, inliers {pnp[2]:.4f} equal; card vs truth "
          f"{pnp_truth[0]:.4f} deg, {pnp_truth[1]:.2e}; card {ms[0]:.2f} ms, "
          f"CPU {ms[1]:.2f} ms (first calls)")
    if not (ok_g and ok_c) or pnp[0] > 0.01 or pnp[1] > 1e-3 \
            or pnp[2] < 0.99:
        raise RuntimeError("PnP RANSAC on the card disagrees with the CPU")
    if pnp_truth[0] > 0.5 or pnp_truth[1] > 0.05 or in_g[:n_out].any():
        raise RuntimeError("PnP RANSAC missed the true pose")

    n, n_out = 200, 60
    R = so3_exp(torch.tensor([0.2, -0.1, 0.3])).numpy()
    t, s = np.array([0.5, -0.2, 0.1], np.float32), 1.1
    Xa = rng.normal(size=(n, 3)).astype(np.float32) * 2
    Xb = (s * Xa @ R.T + t).astype(np.float32)
    Xb += rng.normal(0, 0.005, Xb.shape).astype(np.float32)
    Xb[:n_out] += rng.uniform(0.5, 2, (n_out, 3)).astype(np.float32)
    mask = torch.ones(n, dtype=torch.bool)
    idx = draw_samples(mask, 300, 3, g)
    out = []
    for dev in ("cuda", "cpu"):
        r = sim3_ransac(torch.as_tensor(Xa, device=dev),
                        torch.as_tensor(Xb, device=dev), mask.to(dev),
                        th_b=0.05, samples=idx.to(dev))
        out.append([a.cpu().numpy() for a in r])
    (R_g, t_g, s_g, in_g, _), (R_c, t_c, s_c, in_c, _) = out
    sim = (rotation_angle_deg(R_g, R_c), float(np.abs(t_g - t_c).max()),
           abs(float(s_g - s_c)), float((in_g == in_c).mean()))
    print(f"Sim3 RANSAC card vs CPU: rotation {sim[0]:.2e} deg, translation "
          f"{sim[1]:.2e}, scale {sim[2]:.2e}, inliers {sim[3]:.4f} equal; "
          f"card scale {float(s_g):.5f} (truth {s})")
    if sim[0] > 0.01 or sim[1] > 1e-3 or sim[2] > 1e-3 or sim[3] < 0.99:
        raise RuntimeError("Sim3 RANSAC on the card disagrees with the CPU")
    if rotation_angle_deg(R_g, R) > 0.1 or abs(float(s_g) - s) > 2e-3 \
            or in_g[:n_out].any():
        raise RuntimeError("Sim3 RANSAC missed the true similarity")


def loop_scenario(vocab, seed=12):
    """A 13-keyframe map at EuRoC geometry: KF0 binds 512 landmarks in
    view, KF1-11 are a chain of 512-feature keyframes, and KF12 sees KF0's
    landmarks again as drifted duplicates under a known Sim3, with KF0's
    descriptors. Returns (map, BoW index, kf, cand, true Sim3, n)."""
    import torch
    from ygz_tpu_torch.backend.bow import BowIndex
    from ygz_tpu_torch.backend.mapstate import SlamMap
    from ygz_tpu_torch.geometry.lie import so3_exp

    rng = np.random.default_rng(seed)
    cx, cy = W / 2.0 - 0.5, H / 2.0 - 0.5
    M = 1024
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M),
                  rng.uniform(4, 9, M)], -1).astype(np.float32)
    R = so3_exp(torch.tensor([0.02, -0.04, 0.03])).numpy()
    t, s = np.array([0.3, -0.1, 0.4], np.float32), 1.08
    Xd = (s * X @ R.T + t).astype(np.float32)

    def project(P):
        return np.stack([F * P[:, 0] / P[:, 2] + cx,
                         F * P[:, 1] / P[:, 2] + cy], -1).astype(np.float32)

    def inb(uv):
        return ((uv[:, 0] > 25) & (uv[:, 0] < W - 25) & (uv[:, 1] > 25)
                & (uv[:, 1] < H - 25))

    keep = np.nonzero(inb(project(X)) & inb(project(Xd)))[0][:512]
    X, Xd = X[keep], Xd[keep]
    n = len(X)
    desc = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    smap = SlamMap(max_kf=16, max_pt=4 * n, max_feat=512)

    def feats(uv, d):
        return {"uv": uv, "level": np.zeros(len(uv), np.int32),
                "angle": np.zeros(len(uv), np.float32), "desc": d,
                "valid": np.ones(len(uv), bool)}

    def landmarks(kf, P):
        ids = smap.alloc_points(n)
        smap.pt_xyz[ids] = P
        smap.pt_valid[ids] = True
        smap.pt_desc[ids] = desc
        smap.pt_ref_kf[ids] = kf
        smap.bind(kf, np.arange(n), ids)

    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    cand = smap.add_keyframe(eye, zero, feats(project(X), desc))
    landmarks(cand, X)
    for j in range(1, 12):
        smap.add_keyframe(eye, np.array([0.3 * j, 0, 0], np.float32), feats(
            rng.uniform(10, [W - 10, H - 10], (512, 2)).astype(np.float32),
            rng.integers(0, 2, (512, 256)).astype(np.uint8)))
    kf = smap.add_keyframe(eye, zero, feats(project(Xd), desc))
    landmarks(kf, Xd)
    bow = BowIndex(vocab, max_kf=16, max_feat=512, device="cpu")
    for k in range(smap.n_kf):
        wid, b = bow.quantize(smap.kf_feat_desc[k], smap.kf_feat_valid[k])
        bow.add_keyframe(k, b, feat_wid=wid)
    return smap, bow, kf, cand, (R, t, s), n


def check_loop_correction():
    """compute_sim3 + correct on the loop scenario, on the card and on the
    CPU: the drift recovered within the JAX test's bounds, the seam closed
    (median reprojection of the current keyframe's points < 4 px) and the
    duplicates fused; card and CPU fuse the same count and agree on the
    keyframe poses within 1e-3."""
    from ygz_tpu_torch.backend.bow import (default_vocabulary_path,
                                           load_vocabulary)
    from ygz_tpu_torch.backend.loopclosing import LoopCloser
    from ygz_tpu_torch.eval.ate import rotation_angle_deg

    vocab = load_vocabulary(default_vocabulary_path())
    cam = euroc_camera()
    res = []
    for dev in ("cuda", "cpu"):
        smap, bow, kf, cand, (R0, t0, s0), n = loop_scenario(vocab)
        lc = LoopCloser(bow, cam, device=dev)
        t_a = time.perf_counter()
        out = lc.compute_sim3(smap, kf, cand)
        t_b = time.perf_counter()
        if out is None:
            raise RuntimeError(f"compute_sim3 found no Sim3 on {dev}")
        R, t, s, ni = out
        errs = (abs(s - s0), rotation_angle_deg(R, R0),
                float(np.abs(t - t0).max()))
        n_before = int(smap.pt_valid[: smap.n_pt].sum())
        lc.correct(smap, kf, cand, (R, t, s))
        t_c = time.perf_counter()
        fused = n_before - int(smap.pt_valid[: smap.n_pt].sum())
        slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0]
        Xc = (smap.pt_xyz[smap.kf_feat_pt[kf, slots]] @ smap.kf_R[kf].T
              + smap.kf_t[kf])
        uv = np.stack([F * Xc[:, 0] / Xc[:, 2] + cam.cx,
                       F * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)
        seam = float(np.median(np.linalg.norm(
            uv - smap.kf_feat_uv[kf, slots], axis=1)))
        res.append((smap, fused, 1e3 * (t_b - t_a), 1e3 * (t_c - t_b)))
        print(f"loop correction on {dev}: Sim3 with {ni} inliers, |s - s0| "
              f"{errs[0]:.2e}, rotation {errs[1]:.4f} deg, |t - t0| "
              f"{errs[2]:.2e}; fused {fused} of {n} duplicates; seam "
              f"{seam:.3f} px median; compute_sim3 {res[-1][2]:.2f} ms, "
              f"correct {res[-1][3]:.2f} ms")
        if errs[0] > 0.01 or errs[1] > 0.5 or errs[2] > 0.03:
            raise RuntimeError(f"compute_sim3 on {dev} missed the drift")
        if fused < 0.5 * n or seam > 4.0:
            raise RuntimeError(f"correct on {dev}: fused {fused}, seam "
                               f"{seam:.3f} px")
    (a, fa, *_), (b, fb, *_) = res
    K = a.n_kf
    dR = float(np.abs(a.kf_R[:K] - b.kf_R[:K]).max())
    dt = float(np.abs(a.kf_t[:K] - b.kf_t[:K]).max())
    print(f"loop correction card vs CPU: fused {fa} vs {fb}; keyframe poses "
          f"R {dR:.2e}, t {dt:.2e}")
    if fa != fb or dR > 1e-3 or dt > 1e-3:
        raise RuntimeError("loop correction on the card disagrees with the "
                           "CPU")


def time_paths(smi):
    """The tracked paths of the earlier slices (mono, stereo, RGB-D) at the
    smoke's depths, each with its stage report and nothing else: run as
    `chip_smoke.py --paths-only` from two trees in one call, in turns, to
    compare their host times on one card."""
    _, _, frames = render_sequence(N_FRAMES)
    st_poses, pairs = stereo_sequence(N_STEREO_FRAMES)
    rg_poses, rg_frames = rgbd_sequence(N_RGBD_FRAMES)
    runs = (("mono", lambda: run_main_path(frames, "cuda")),
            ("stereo", lambda: run_depth_path("stereo", pairs, "cuda")),
            ("rgbd", lambda: run_depth_path("rgbd", rg_frames, "cuda")))
    for label, fn in runs:
        system, states, _, secs = fn()
        print(f"{label} path: {len(states)} frames, {states.count('OK')} OK, "
              f"in {secs:.2f} s ({1e3 * secs / len(states):.2f} ms/frame "
              f"mean)")
        print(f"{label} path ({smi}) {system.tracker.timer.report()}")


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
    if sys.argv[1:] == ["--paths-only"]:
        time_paths(smi)
        return 0

    t0 = time.perf_counter()
    scene, poses, frames = render_sequence(N_FRAMES + 3)
    print(f"rendered {len(frames)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    score_rec = check_fast_kernel(frames[0])
    corners_rec = check_fast_corners(frames)

    (system, states, ladder, secs), corners_rec["launches"] = run_counted(
        fast, "main path", lambda: run_main_path(frames[:N_FRAMES], "cuda"))
    score_rec["launches"] = fast.fast_score_map.launches
    print(f"main path: {N_FRAMES} frames in {secs:.2f} s "
          f"({1e3 * secs / N_FRAMES:.2f} ms/frame mean)")
    print(f"main path ({smi}) {system.tracker.timer.report()}")
    align, length = check_result(system, states, ladder, poses[:N_FRAMES])
    check_step_vs_cpu(system, frames[N_FRAMES:])
    check_global_ba(system)
    corners_rec["launches_relocalization"] = check_relocalization(
        system, frames, poses, align, length)
    # the extractor no longer runs the single-threshold entry
    score_rec["launches_relocalization"] = fast.fast_score_map.launches
    check_ransac()
    check_loop_correction()

    t0 = time.perf_counter()
    st_poses, pairs = stereo_sequence(N_STEREO_FRAMES)
    rg_poses, rg_frames = rgbd_sequence(N_RGBD_FRAMES)
    print(f"rendered {len(pairs)} stereo pairs {W}x{H} and {len(rg_frames)} "
          f"RGB-D frames {TUM_W}x{H} in {time.perf_counter() - t0:.1f} s")
    # the RGB-D path runs the fused kernel on the TUM camera's pyramid
    # (480x640 .. 60x80): held bit for bit there too, outside the counted
    # runs
    corners_rec["max_abs_err"] = max(
        corners_rec["max_abs_err"],
        *(hold_fast_corners(rg_frames[i][0], f"RGB-D frame {i}")
          for i in (0, N_RGBD_FRAMES // 2)))
    for sensor, poses, seq in (("stereo", st_poses, pairs),
                               ("rgbd", rg_poses, rg_frames)):
        (dsys, dstates, seeded, secs), launches = run_counted(
            fast, f"{sensor} path", lambda: run_depth_path(sensor, seq,
                                                           "cuda"))
        corners_rec[f"launches_{sensor}"] = launches
        score_rec[f"launches_{sensor}"] = fast.fast_score_map.launches
        print(f"{sensor} path: {len(seq)} frames in {secs:.2f} s "
              f"({1e3 * secs / len(seq):.2f} ms/frame mean)")
        print(f"{sensor} path ({smi}) {dsys.tracker.timer.report()}")
        check_depth_result(sensor, dsys, dstates, seeded, poses)
        if sensor == "stereo":
            check_stereo_match(dsys, pairs)
    # the first frame steps after RGB-D's one-frame init, card vs CPU
    init_sys = run_depth_path("rgbd", rg_frames[:1], "cuda")[0]
    check_step_vs_cpu(init_sys, [img for img, _ in rg_frames[1:6]])

    t0 = time.perf_counter()
    vi_poses, vi_frames, vi_imus = vi_sequence()
    print(f"rendered {len(vi_frames)} mono-VI frames {W}x{H} with their IMU "
          f"in {time.perf_counter() - t0:.1f} s")
    (vsys, vstates, vdebug, ready_at, secs, rec), launches = run_counted(
        fast, "mono-VI path",
        lambda: run_vi_path(vi_frames, vi_imus, "cuda", record=True))
    corners_rec["launches_mono_vi"] = launches
    score_rec["launches_mono_vi"] = fast.fast_score_map.launches
    print(f"mono-VI path: {len(vi_frames)} frames in {secs:.2f} s "
          f"({1e3 * secs / len(vi_frames):.2f} ms/frame mean)")
    print(f"mono-VI path ({smi}) {vsys.tracker.timer.report()}")
    check_vi_result(vsys, vstates, vdebug, ready_at, vi_poses)
    check_vi_numerics(rec, vsys.tracker.vins_scale)

    print(json.dumps({"kernels": [score_rec, corners_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
