"""Chip smoke test: drive the PyTorch port's SLAM on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the hand-written CUDA kernels from ygz_tpu_torch/csrc/ (one
     nvcc per source, all started together);
  2. check each FAST kernel against its plain PyTorch version on the card
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
  5b. the distributed global BA (parallel/dist_ba.py) on copies of that
     map: sharded over 2 shards on the card against the dense solve (the
     free scale taken out; test_dist_ba.py's mapper bounds scaled by the
     ratio of the maps' extents), the same card vs CPU, the dense, 1-shard
     and 2-shard solves timed in turns (ms and launch calls per solve);
     two processes on the one card (parallel/worker.py, 2 shards each, a
     gloo group over localhost carrying CUDA tensors) against the
     in-process solve; TrackerConfig(mesh_devices=2) raising on a one-card
     machine; then the main path again with its mapper sharded over 2
     shards on the card (kernel launches counted on this run) and its
     global BA through the sharded step;
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
  3b. the batched async path (bench.py's headline configuration) through
     the port's bench (ygz_tpu_torch/tools/bench.py):
     System(TrackerConfig(async_mapping=True, track_batch=32)) over 48 warm
     and 240 timed frames of the same sequence without the exposure drop,
     track_monocular_batch in slices of 96, then shutdown(): the bench's
     JSON line (fps, frames OK beside the 0.95 bar, 7-DoF ATE of the timed
     frames < 3% of their path) with device_pipeline_fps (the frame step
     alone, 12 chunks of 32 graph replays read one behind), 7-DoF ATE over
     all frames, one fused FAST launch per extraction with the deferred
     ones on the mapping worker's stream, the tails' overlap with tracking;
     then the frame step replayed as a CUDA graph against the eager step
     (per frame from the same inputs, and chained in turns: ms and launches
     per frame). Every tracked path below replays the captured frame step
     too;
  3c. (between the bench and the graph check of 3b) the frame step's two
     Gauss-Newton kernels (csrc/pose_gn.cu, csrc/sparse_align.cu) and the
     direct tracker's kernel (csrc/direct_align.cu) against their plain
     versions on the card: at the main path's inputs, recorded from one
     eager frame step of the bench's tracker (which must launch pose_gn
     twice, sparse_align once and direct_align twice; one graph replay
     must run the same five), and at seeded edge cases (stereo rows, one
     row, 1,500 rows, points behind the camera, the PnP polish's gate, no
     valid row; two levels of 3 iterations, points on the level borders,
     no valid point; NaN patches, no valid point, points behind the
     camera, the refinement against a known pose); two launches repeating
     bit for bit; device and CUDA-event times against the plain versions,
     the bound and the time per step, and the replay's device time per
     frame. Every path counts the three kernels' wrapper launches;
  10b. the dataset runners from trees on disk, written with the port's PNG
     encoder under build/smoke_trees/: a EuRoC tree (the 160 frames of
     phase 3 without the exposure drop, its ground truth, a settings file
     with ORBextractor.keypointMode: octree) through
     examples/mono_euroc.py; a TUM RGB-D tree (phase 10's 46 frames as RGB
     PNGs with 16-bit depth at 5000 per metre, rgb.txt, depth.txt) through
     examples/rgbd_tum.py in grid mode with a settings file; a KITTI tree
     (60 frames 1241x376, f=718.856, examples/mono_kitti.py's default
     camera) through examples/mono_kitti.py. Frames OK, ATE, trajectory
     files, one fused FAST launch per extraction, each runner's median ms
     per frame and decode ms per frame. Then the octree extraction card vs
     CPU on frames 0 and 80 of the EuRoC tree; examples/mono_euroc.py's
     default camera (radtan distortion) with its graph replay, undistort
     remap inside, held bit-exact to the eager step over 10 frames, and at
     KITTI's shape the frame step card vs CPU and its replay bit-exact;
     the native PNG loader against io/png.py byte for byte where it
     builds, and which route decodes;
  11. mono-VI: System.track_mono_vi over 260 frames of the EuRoC cam0
     geometry along the JAX VI tests' trajectory (0.6 m/s, 20 fps) with its
     exact 200 Hz IMU and the default settings; two blank-frame outages (12
     frames with a corrupted accelerometer, then 2 s); VINS init, metric
     span, gravity, the recovery gate after dead-reckoning (and its
     re-anchor branch), the escalation past DR_MAX_S, recovery;
     then one pair optimization, one NavState window BA and the VINS
     initialization recorded from the run, card vs CPU, and the window
     BA's segment sums, sorted against atomic (repeatability and ms); then
     the run again up to the second outage, held bit for bit to the first;
  12. the live loop: tools/ate_report.py's run_mono_loop with nuisances
     (a 640-frame square circuit at 640x480, the async worker,
     track_batch=8): at least one loop closed on the mapping worker by
     detect -> compute_sim3 -> correct, frames OK > 0.9, 7-DoF ATE < 0.25,
     one fused FAST launch per extraction; each loop event, the keyframes
     and map.max_kf printed;
  13. the frame step's profile (tools/profile_framestep.py): host ms,
     device ms and kernels per call of each stage, and the replayed step.
The last line is {"ok": true, "device": {...}}. Needs CUDA; imports nothing
of JAX. It runs in PyTorch's default mode; the port's segment sums add in
a fixed order on the card, and a second mono-VI run is held bit for bit to
the first. `python3 chip_smoke.py --paths-only` builds the kernel and
times only the monocular, stereo and RGB-D paths (for comparing two trees
in one call); `--runners-only` runs only phase 10b.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np

# the peaks, the kernels' operation counts and their work, as the
# benchmark's rooflines count them
from slam_bench import roofline
from slam_bench.roofline import (ARC_OPS, MERGE_OPS, NMS_OPS, TH_OPS,
                                 interior, pose_gn_work, sparse_align_work)

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


def direct_align_work(n):
    """(bytes, operations) of the direct tracker's two launches per frame
    over n points, as slam_bench/metrics/direct_align_roofline.py counts
    them for the benchmark's direct_align_roofline."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "slam_bench", "metrics", "direct_align_roofline.py")
    spec = importlib.util.spec_from_file_location("direct_align_roofline",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.direct_align_work(n)


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
# the batched async path: bench.py's run (48 warm frames, 240 timed ones in
# slices of 3 chunks of 32) on the same sequence, and 20 frames past it for
# the eager step against the graph replay
BATCH, N_WARM, N_TIMED, N_TURN = 32, 48, 240, 20
# the runner phase: KITTI frames, and the distorted camera's frames
# tracked before its graph replay is held to the eager step
N_KITTI_FRAMES, N_DIST, N_DIST_TURN = 60, 30, 10
# PNG decodes timed per route and kind of file
N_PNG_TIMED = 8
# the distributed BA phase: test_dist_ba.py's mapper bounds were set on a
# map whose points fill [-2, 2] x [-1.5, 1.5] x [4, 9] uniformly, whose
# 5-95% box has a diagonal of 0.9 * sqrt(50); the smoke's map scales them
# by the ratio of the diagonals. Rotations, sharded vs dense: 0.05 deg
DIST_TEST_EXTENT, DIST_ROT_DEG = 0.9 * float(np.sqrt(50.0)), 0.05


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


def render_sequence(n, dark=True):
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    # the texture must cover the whole run (x reaches 0.05 * n units plus
    # the view's half-span at 60 px per unit)
    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=3000)
    poses = [euroc_pose(i) for i in range(n)]
    frames = [scene.render_u8(R, t) for R, t in poses]
    if dark:
        frames = with_dark_frame(frames)
    return scene, poses, frames


def with_dark_frame(frames):
    """The frames with frame DARK_FRAME at DARK_GAIN exposure."""
    frames = list(frames)
    if len(frames) > DARK_FRAME:
        frames[DARK_FRAME] = (frames[DARK_FRAME] * DARK_GAIN).astype(np.uint8)
    return frames


def check_segment_sums(call):
    """The recorded window BA on the card with the port's segment sums
    (sorted, a fixed order) and with atomic index_add_ in their place, in
    turns (sorted, atomic, atomic, sorted): ms per call, and whether each
    form repeats bit for bit. The sorted form must."""
    import torch
    from ygz_tpu_torch.backend import vio_optim

    def atomic(x, ids, n):
        return torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device).index_add_(0, ids, x)

    def flat(res):
        return np.concatenate([np.ravel(np.asarray(v, np.float64))
                               for v in res if isinstance(v, np.ndarray)])

    a, k = _map(call, lambda t: t.to("cuda"))
    sorted_sum = vio_optim.segment_sum
    outs = collections.defaultdict(list)
    ms = collections.defaultdict(list)
    try:
        for form in ("sorted", "atomic", "atomic", "sorted"):
            vio_optim.segment_sum = sorted_sum if form == "sorted" else atomic
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _map(vio_optim.vio_window_ba(*a, **k),
                       lambda t: t.cpu().numpy())
            ms[form].append(1e3 * (time.perf_counter() - t0))
            outs[form].append(flat(res))
    finally:
        vio_optim.segment_sum = sorted_sum
    same = {f: bool(np.array_equal(o[0], o[1])) for f, o in outs.items()}
    gap = float(np.abs(outs["sorted"][0] - outs["atomic"][0]).max())
    print(f"vio_window_ba segment sums on the card: sorted "
          f"{[round(x, 3) for x in ms['sorted']]} ms (repeats bit for bit: "
          f"{same['sorted']}), atomic index_add_ "
          f"{[round(x, 3) for x in ms['atomic']]} ms (repeats bit for bit: "
          f"{same['atomic']}); max |sorted - atomic| {gap:.2e}")
    if not same["sorted"]:
        raise RuntimeError("the sorted segment sums did not repeat")


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
    `iters` calls after a warm-up (utils/profiling.device_events)."""
    import torch
    from ygz_tpu_torch.utils.profiling import device_events

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, lost = device_events(fn, iters)
    if lost:
        print(f"  torch.profiler: no record for {lost} kernel launches of "
              f"{iters} calls (left out of the time)")
    return 1e-6 * sum(e.duration_ns() for e in dev) / iters, len(dev) / iters


def bound(n_bytes, n_ops):
    """(least ms on the card, "bytes" or "operations")."""
    secs, by = roofline.bound(n_bytes, n_ops)
    return 1e3 * secs, by


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
    relocalization), with "@worker" when the async mapping worker made it
    (a deferred keyframe extraction, on the worker's CUDA stream)."""
    from ygz_tpu_torch.frontend.extractor import OrbExtractor

    import threading

    calls = []
    real = OrbExtractor.__call__

    def counted(self, *args, **kw):
        name = sys._getframe(1).f_code.co_name
        worker = threading.current_thread().name == "ygz-mapping"
        calls.append(f"{name}@worker" if worker else name)
        return real(self, *args, **kw)

    OrbExtractor.__call__ = counted
    try:
        yield calls
    finally:
        OrbExtractor.__call__ = real


def euroc_camera():
    from ygz_tpu_torch.geometry.camera import Camera

    return Camera.make(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H)


def run_main_path(frames, device, cfg=None, mesh=None):
    """System.track_monocular over the frames (default TrackerConfig unless
    given; global BA sharded over `mesh` if given); returns (system,
    states, frames on which the fallback ladder ran, seconds)."""
    from ygz_tpu_torch.system import System, Sensor

    system = System(euroc_camera(), Sensor.MONOCULAR, config=cfg,
                    device=device)
    if mesh is not None:
        # TrackerConfig(mesh_devices=N) wants N cards (checked in
        # check_dist_ba); N shards on one card go to the mapper directly
        system.tracker.mapper.mesh = mesh
    states, ladder = [], []
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        states.append(system.track_monocular(img, i * 0.05)[0])
        if "fb_motion" in system.tracker.debug:
            ladder.append(i)
    return system, states, ladder, time.perf_counter() - t0


def tracked_centres(system, poses):
    """Camera centres of the frames tracked OK, as the map now places them,
    and their ground truth."""
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite poses in the trajectory")
    return est, gt


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
    est, gt = tracked_centres(system, poses)
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
                                                  pack_pred_np, unpack_out)

    tr = system.tracker
    cap = tr.cfg.max_track
    pred = torch.as_tensor(pack_pred_np())
    carries = {"cuda": tr._carry,
               "cpu": FrameCarry(*(a.cpu() for a in tr._carry))}
    caches = {"cuda": tr._snap.cache, "cpu": tr._snap.cache.cpu()}
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


def ba_copies(system, n):
    """n copies of the tracked map, without the pyramids global BA never
    reads."""
    smap = system.map
    pyr = smap.kf_pyr
    smap.kf_pyr = [None] * len(pyr)
    try:
        return [copy.deepcopy(smap) for _ in range(n)]
    finally:
        smap.kf_pyr = pyr


def map_gap(a, b):
    """How far map b is from map a over the alive keyframes and points:
    max rotation gap (deg); the scale s taking b onto a (keyframe 0 is the
    only fixed pose, so the monocular scale is free); translation and point
    gaps at that scale; the raw gaps."""
    from ygz_tpu_torch.eval.ate import rotation_angle_deg

    kfs = np.nonzero(a.kf_valid[: a.n_kf])[0]
    pts = np.nonzero(a.pt_valid[: a.n_pt])[0]
    if not (np.isfinite(a.pt_xyz[pts]).all() and np.isfinite(a.kf_t).all()
            and np.isfinite(b.pt_xyz[pts]).all()
            and np.isfinite(b.kf_t).all()):
        raise RuntimeError("global BA gave non-finite values")
    rot = max(rotation_angle_deg(a.kf_R[k], b.kf_R[k]) for k in kfs)
    s = float((a.kf_t[kfs] * b.kf_t[kfs]).sum() / (b.kf_t[kfs] ** 2).sum())
    return {"rot_deg": rot, "scale": s,
            "dt": float(np.abs(a.kf_t[kfs] - s * b.kf_t[kfs]).max()),
            "dp": float(np.abs(a.pt_xyz[pts] - s * b.pt_xyz[pts]).max()),
            "raw_dt": float(np.abs(a.kf_t[kfs] - b.kf_t[kfs]).max()),
            "raw_dp": float(np.abs(a.pt_xyz[pts] - b.pt_xyz[pts]).max())}


def check_global_ba(system):
    """Global BA on two copies of the final map, on the card and on the
    CPU: keyframe rotations within 0.01 deg; translations and points within
    1e-3 once the CPU map is brought to the card map's scale. Only
    keyframe 0 is fixed (the JAX package's gauge), so the monocular scale
    is free, and the two devices' float32 sums, in another order, settle
    it up to ~1e-3 apart, which alone moves a point 2 units out by 2e-3;
    the scale must agree within 1e-2."""
    from ygz_tpu_torch.backend.mapping import LocalMapper

    smap = system.map
    maps = ba_copies(system, 2)
    ms = []
    for dev, m in zip(("cuda", "cpu"), maps):
        mapper = LocalMapper(system.cam, device=dev)
        t0 = time.perf_counter()
        mapper.global_ba(m)
        ms.append(1e3 * (time.perf_counter() - t0))
    a, b = maps
    gap = map_gap(a, b)
    pts = np.nonzero(a.pt_valid[: a.n_pt])[0]
    moved = float(np.abs(a.pt_xyz[pts] - smap.pt_xyz[pts]).max())
    print(f"global BA ({int(a.kf_valid[: a.n_kf].sum())} keyframes, "
          f"{len(pts)} points): card "
          f"{ms[0]:.2f} ms, CPU {ms[1]:.2f} ms; card vs CPU: rotation "
          f"{gap['rot_deg']:.2e} deg; scale card/CPU {gap['scale']:.7f}; at "
          f"that scale translation {gap['dt']:.2e}, points {gap['dp']:.2e} "
          f"(raw {gap['raw_dt']:.2e}, {gap['raw_dp']:.2e}; points moved up "
          f"to {moved:.2e})")
    if (gap["rot_deg"] > 0.01 or abs(gap["scale"] - 1.0) > 1e-2
            or gap["dt"] > 1e-3 or gap["dp"] > 1e-3):
        raise RuntimeError("global BA on the card disagrees with the CPU")


def timed_global_ba(mapper, smap):
    """Host ms of one global BA on the card (it ends on its readback)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper.global_ba(smap)
    return 1e3 * (time.perf_counter() - t0)


def run_workers(n_proc, device, timeout=300):
    """The multi-process distributed BA: n_proc processes of
    ygz_tpu_torch/parallel/worker.py (two shards each) joined by a gloo
    group over localhost. Returns process 0's (total chi2, kf_t [P, 3], ms
    per solve, launch calls per solve); kills what it started on the way
    out."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ygz_tpu_torch.parallel.worker",
         f"127.0.0.1:{port}", str(n_proc), str(i), "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=timeout), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (_, err), rc in outs:
        if rc != 0:
            raise RuntimeError(f"a worker failed (rc {rc}):\n{err[-3000:]}")
    lines = [ln.split() for (out, _), _ in outs for ln in out.splitlines()
             if ln.strip()]
    res = [ln for ln in lines if ln[0] == "RESULT"]
    tim = [ln for ln in lines if ln[0] == "TIMING"]
    if len(res) != 1 or len(tim) != 1:
        raise RuntimeError(f"the workers printed {res} {tim}")
    return (float(res[0][1]),
            np.array([float(v) for v in res[0][2:]]).reshape(-1, 3),
            float(tim[0][1]), int(tim[0][2]))


def check_dist_ba(fast, smi, system, frames, poses, states):
    """The distributed global BA on the card (parallel/dist_ba.py), on
    copies of the main path's final map:
    (a) sharded over 2 shards on the card against the dense solve, the
        free scale taken out as in check_global_ba, to test_dist_ba.py's
        mapper bounds (keyframe translations 2e-3, points 2e-2) scaled by
        the ratio of the maps' extents, rotations within DIST_ROT_DEG;
        the dense, 1-shard and 2-shard solves timed in turns (host ms and
        launch calls per solve), each form repeating bit for bit;
    (b) the same 2-shard solve on the CPU: check_global_ba's bounds;
    (c) two processes on the one card (parallel/worker.py, 2 shards each,
        gloo carrying CUDA tensors through the host) against the
        in-process 4-shard card solve of the same problem (bit for bit or
        not) and the 2-shard one: kf_t within 1e-4, chi2 within 1%;
    (d) TrackerConfig(mesh_devices=2) raising the JAX package's ValueError
        where one card is visible;
    (e) the main path again with its mapper sharded over 2 shards on the
        card (FAST launches counted afresh), then its global BA through
        the sharded step: the states of the main path, ATE < 3% after.
    Returns the numbers and the run's (fused, single) FAST launches."""
    import torch
    from ygz_tpu_torch.backend.mapping import LocalMapper
    from ygz_tpu_torch.eval.ate import ate_rmse
    from ygz_tpu_torch.frontend.tracker import TrackerConfig
    from ygz_tpu_torch.parallel import worker
    from ygz_tpu_torch.parallel.dist_ba import Mesh
    from ygz_tpu_torch.system import Sensor, System
    from ygz_tpu_torch.utils.profiling import launch_calls

    cam = system.cam
    card = torch.device("cuda", 0)
    mappers = {"dense": LocalMapper(cam, device="cuda"),
               "1-shard": LocalMapper(cam, device="cuda", mesh=Mesh([card])),
               "2-shard": LocalMapper(cam, device="cuda",
                                      mesh=Mesh([card, card]))}
    order = ["dense", "1-shard", "2-shard", "2-shard", "1-shard", "dense"]
    maps = ba_copies(system, len(order) + 4)
    ms, solved = collections.defaultdict(list), collections.defaultdict(list)
    for label, m in zip(order, maps):
        ms[label].append(timed_global_ba(mappers[label], m))
        solved[label].append(m)
    calls = {}
    for label, m in zip(mappers, maps[len(order):]):
        calls[label] = launch_calls(lambda: mappers[label].global_ba(m))
    repeats = {label: all(np.array_equal(getattr(a, f), getattr(b, f))
                          for f in ("kf_R", "kf_t", "pt_xyz"))
               for label, (a, b) in solved.items()}
    a, b = solved["2-shard"][0], solved["dense"][0]
    pts = a.pt_xyz[np.nonzero(a.pt_valid[: a.n_pt])[0]]
    lo, hi = np.percentile(pts, [5, 95], axis=0)
    ratio = float(np.linalg.norm(hi - lo)) / DIST_TEST_EXTENT
    gap = map_gap(a, b)
    t_tol, p_tol = 2e-3 * ratio, 2e-2 * ratio
    print(f"distributed BA ({smi}): {len(pts)} points, extent "
          f"(5-95% box diagonal) {ratio:.4f}x test_dist_ba.py's map; "
          f"2-shard vs dense: rotation {gap['rot_deg']:.2e} deg, scale "
          f"{gap['scale']:.7f}, at that scale translation {gap['dt']:.2e} "
          f"(bound {t_tol:.2e}), points {gap['dp']:.2e} (bound "
          f"{p_tol:.2e}); raw {gap['raw_dt']:.2e}, {gap['raw_dp']:.2e}")
    print(f"distributed BA in turns {order}: host ms per solve "
          f"{[round(ms[lb][order[:i].count(lb)], 2) for i, lb in enumerate(order)]}; "
          f"launch calls per solve {calls}; repeats bit for bit {repeats}")
    if (gap["rot_deg"] > DIST_ROT_DEG or abs(gap["scale"] - 1.0) > 1e-2
            or gap["dt"] > t_tol or gap["dp"] > p_tol):
        raise RuntimeError("the sharded global BA disagrees with the dense "
                           "one")
    if not all(repeats.values()):
        raise RuntimeError(f"a global BA did not repeat: {repeats}")

    # (b) the 2-shard solve, card against CPU
    cpu_map = maps[-1]
    cpu_ms = timed_global_ba(LocalMapper(cam, device="cpu",
                                         mesh=Mesh(["cpu", "cpu"])), cpu_map)
    gap_cpu = map_gap(a, cpu_map)
    print(f"2-shard global BA card vs CPU (CPU {cpu_ms:.1f} ms): rotation "
          f"{gap_cpu['rot_deg']:.2e} deg, scale {gap_cpu['scale']:.7f}, "
          f"translation {gap_cpu['dt']:.2e}, points {gap_cpu['dp']:.2e} "
          f"(raw {gap_cpu['raw_dt']:.2e}, {gap_cpu['raw_dp']:.2e})")
    if (gap_cpu["rot_deg"] > 0.01 or abs(gap_cpu["scale"] - 1.0) > 1e-2
            or gap_cpu["dt"] > 1e-3 or gap_cpu["dp"] > 1e-3):
        raise RuntimeError("the sharded global BA on the card disagrees "
                           "with the CPU")

    # (c) two processes on the one card against the in-process solves
    t0 = time.perf_counter()
    chi2_mp, kf_t_mp, mp_ms, mp_calls = run_workers(2, "cuda")
    wall = time.perf_counter() - t0
    run4, r4 = worker.solve(Mesh([card] * 4))
    _, r2 = worker.solve(Mesh([card] * 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run4()
    torch.cuda.synchronize()
    ms4, calls4 = 1e3 * (time.perf_counter() - t0), launch_calls(run4)
    kf4, kf2 = r4.kf_t.cpu().numpy(), r2.kf_t.cpu().numpy()
    exact = bool(np.array_equal(kf_t_mp, kf4)
                 and chi2_mp == float(r4.total_chi2))
    d2 = float(np.abs(kf_t_mp - kf2).max())
    c2 = abs(chi2_mp - float(r2.total_chi2)) / max(float(r2.total_chi2), 1.0)
    print(f"two processes x 2 shards on one card (gloo, CUDA tensors; "
          f"{wall:.1f} s with start-up): {mp_ms:.2f} ms and {mp_calls} "
          f"launch calls per solve in process 0, against in-process 4 "
          f"shards {ms4:.2f} ms, {calls4} calls; equal to the in-process "
          f"4-shard solve bit for bit: {exact} (max |dkf_t| "
          f"{float(np.abs(kf_t_mp - kf4).max()):.2e}); against 2 shards: "
          f"kf_t {d2:.2e}, chi2 {c2:.2e} relative")
    if not (np.abs(kf_t_mp - kf4).max() <= 1e-4 and d2 <= 1e-4
            and c2 < 0.01):
        raise RuntimeError("the two-process solve disagrees with the "
                           "in-process one")

    # (d) the tracker's mesh wants one card per shard
    n_cards = torch.cuda.device_count()
    try:
        System(cam, Sensor.MONOCULAR,
               config=TrackerConfig(mesh_devices=n_cards + 1))
    except ValueError as e:
        print(f"TrackerConfig(mesh_devices={n_cards + 1}) with {n_cards} "
              f"card(s) visible raises: {e}")
        if str(e) != (f"mesh_devices={n_cards + 1} but only {n_cards} "
                      f"devices visible"):
            raise
    else:
        raise RuntimeError("mesh_devices beyond the visible cards did not "
                           "raise")

    # (e) the main path with its global BA sharded
    (dsys, dstates, _, secs), fused, single = run_counted(
        fast, "main path, mapper sharded over 2 shards on the card",
        lambda: run_main_path(frames, "cuda", mesh=Mesh([card, card])))
    mapper = dsys.tracker.mapper
    est, gt = tracked_centres(dsys, poses)
    before = ate_rmse(est, gt, with_scale=True)[0]
    gba_ms = timed_global_ba(mapper, dsys.map)
    est, gt = tracked_centres(dsys, poses)
    after = ate_rmse(est, gt, with_scale=True)[0]
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    same = dstates == states
    print(f"main path with the sharded mapper: {len(frames)} frames in "
          f"{secs:.2f} s, {dstates.count('OK')} OK, states equal to the "
          f"main path's: {same}; global BA through the sharded step "
          f"{gba_ms:.2f} ms (steps cached {list(mapper._dist_ba_cache)}); "
          f"ATE {before:.5f} -> {after:.5f} over {length:.3f} "
          f"({100 * after / length:.3f}%)")
    if not mapper._dist_ba_cache:
        raise RuntimeError("global BA did not dispatch the sharded step")
    if dstates[-1] != "OK" or not after < 0.03 * length:
        raise RuntimeError("the main path with the sharded mapper failed")
    rec = {"ms": {k: v for k, v in ms.items()}, "calls": calls,
           "vs_dense": gap, "extent_ratio": ratio, "card_vs_cpu": gap_cpu,
           "two_process": {"ms": mp_ms, "calls": mp_calls, "exact": exact,
                           "kf_t_vs_2_shard": d2, "chi2_vs_2_shard": c2},
           "in_process_4_shard": {"ms": ms4, "calls": calls4},
           "main_path": {"ate_before": before, "ate_after": after,
                         "gba_ms": gba_ms, "states_equal": same}}
    return rec, fused, single


def check_relocalization(system, frames, poses, align, length):
    """Three black frames must lose the tracker; the view of frame REVISIT
    must then relocalize it within 3 tries, its camera centre (through the
    main run's 7-DoF alignment) within RELOC_BOUND of the path of the true
    one, and the 10 frames after it must all track. Returns the fused and
    the single-threshold FAST launches on this path."""
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
    return launches, fast.fast_score_map.launches


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


def check_vi_repeat(first, frames, imus):
    """The mono-VI run again on the card up to the second outage (VINS
    init, the window BA, the first outage and its recovery gate), held bit
    for bit to the first: its outcome moves with any change in the order
    of a float sum."""
    n = VI_OUT2[0]
    first = first[:n]
    t0 = time.perf_counter()
    system = run_vi_path(frames[:n], imus[:n], "cuda")[0]
    secs = time.perf_counter() - t0
    again = [(r.state, r.R, r.t) for r in system.trajectory]
    states = [a[0] for a in first] == [b[0] for b in again]
    exact = states and all(np.array_equal(a[1], b[1])
                           and np.array_equal(a[2], b[2])
                           for a, b in zip(first, again))
    dt = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(first, again))
    print(f"mono-VI run again over frames 0-{n - 1} ({secs:.1f} s): states "
          f"equal {states}, bit-exact {exact}, max |dt| {dt:.2e}")
    if not exact:
        raise RuntimeError("mono-VI: a second run on the card differs from "
                           "the first")


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
    check_segment_sums(rec["ba"].calls[0])
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


def run_batch_path(frames, device):
    """bench.py's timed loop through the port's bench
    (ygz_tpu_torch/tools/bench.py run_timed: System(MONOCULAR,
    TrackerConfig(async_mapping=True, track_batch=BATCH)), the first N_WARM
    frames in calls of BATCH, the rest in slices of 3 * BATCH, then
    shutdown()). The mapping tails' and the frames' host times are logged
    to measure their overlap. Returns (the bench's TimedRun, states, tail
    intervals and frame completion times in the timed window)."""
    from ygz_tpu_torch.tools import bench

    tails, logged, trace = [], [], []

    def instrument(system):
        tr = system.tracker
        real_tail, real_log = tr._mapping_tail, tr._log
        real_consume = tr._consume_out

        def timed_tail(*args):
            t0 = time.perf_counter()
            try:
                return real_tail(*args)
            finally:
                tails.append((t0, time.perf_counter()))

        def timed_log(*args):
            real_log(*args)
            logged.append(time.perf_counter())

        def traced_consume(out, ids, *args, **kw):
            res = real_consume(out, ids, *args, **kw)
            trace.append((tr.frame_id, int(out.n_inliers), len(ids),
                          kw.get("batch_mode", False)))
            return res

        tr._mapping_tail, tr._log = timed_tail, timed_log
        tr._consume_out = traced_consume

    run = bench.run_timed(frames, device, BATCH, N_WARM, instrument)
    states = [rec.state for rec in run.system.trajectory]
    smap = run.system.map
    print(f"batched path trace: states "
          f"{''.join(s[0] for s in states)}; keyframes at frames "
          f"{[int(smap.kf_frame_id[k]) for k in range(smap.n_kf)]}; "
          f"(frame, inliers, cache, in a chunk) "
          f"{[t for t in trace if t[0] >= N_WARM]}")
    timed_tails = [(a, b) for a, b in tails if b > run.t_start]
    return run, states, timed_tails, [t for t in logged if t >= run.t_start]


def report_bench(run, poses):
    """The port bench's JSON line for the batched run, with the frame step
    alone (device_pipeline_fps: 12 chunks of B graph replays, read one
    behind) measured after it; held to the bench's ATE gate."""
    from ygz_tpu_torch.tools import bench

    fps, calls = bench.device_pipeline_fps("cuda", BATCH)
    out = bench.summarize(run, poses, N_WARM, (fps, calls), "cuda")
    print(json.dumps(out))
    print(f"device_pipeline_fps {fps:.2f} (B = {BATCH}, 12 chunks, read one "
          f"behind; {calls} host launch calls per chunk)")
    bench.check(out)
    return out


def check_batch_result(system, states, poses, secs, drain, tails, logged):
    """The batched async run: finite poses, 7-DoF ATE < 3% of the path
    over the OK frames, every deferred extraction run. Frames OK against
    0.95 of the timed ones (the bar VERDICT.md item 3 set for the JAX
    bench, whose own run tracked 233/288) and the last frame's state are
    printed beside that bar, not held to it: with the tails racing the
    chunks in flight, as in the JAX package, a keyframe's points reach the
    chunks dispatched after its tail has landed (ROADMAP, open questions).
    Prints fps, ms per frame, keyframes and the tails' overlap with
    tracking."""
    from ygz_tpu_torch.eval.ate import ate_rmse

    timed = states[N_WARM:]
    n_ok = sum(s == "OK" for s in timed)
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr_ = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr_)
            gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    if not np.isfinite(est).all():
        raise RuntimeError("non-finite poses in the batched trajectory")
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    smap = system.map
    n_timed = len(timed)
    print(f"batched async path: {n_timed} timed frames in {secs:.3f} s: "
          f"{n_timed / secs:.2f} fps, {1e3 * secs / n_timed:.2f} ms/frame "
          f"mean; shutdown drain {drain:.3f} s; frames OK {n_ok}/{n_timed} "
          f"({n_ok / n_timed:.4f}); last frame {states[-1]}; keyframes "
          f"{smap.n_kf} created, {int(smap.kf_valid[:smap.n_kf].sum())} "
          f"alive; ATE RMSE (7-DoF, {len(est)} poses) {rmse:.5f} over a "
          f"{length:.3f} path ({100 * rmse / length:.3f}%)")
    # overlap: the frames completed while a tail ran, and the tracking
    # rate inside the tails against outside them
    tail_s = sum(b - a for a, b in tails)
    gaps = np.diff(np.asarray(logged))
    mids = 0.5 * (np.asarray(logged[1:]) + np.asarray(logged[:-1]))
    inside = np.zeros(len(gaps), bool)
    for a, b in tails:
        inside |= (mids >= a) & (mids <= b)
    n_in = int(inside.sum())
    ms_in = 1e3 * float(gaps[inside].mean()) if n_in else float("nan")
    ms_out = 1e3 * float(gaps[~inside].mean()) if (~inside).any() \
        else float("nan")
    busy = sum(1 for a, b in tails
               if any(a <= t <= b for t in logged))
    print(f"mapping worker in the timed window: {len(tails)} tails, "
          f"{tail_s:.3f} s ({100 * tail_s / secs:.1f}% of it), mean "
          f"{1e3 * tail_s / max(len(tails), 1):.2f} ms; {n_in} frames "
          f"completed while a tail ran ({busy} of the tails saw tracking "
          f"progress); tracking {ms_in:.2f} ms/frame inside tails, "
          f"{ms_out:.2f} ms/frame outside")
    met = n_ok >= 0.95 * n_timed and states[-1] == "OK"
    print(f"batched async path against VERDICT.md's bar (frames OK >= 0.95 "
          f"of the timed ones, the last frame OK): "
          f"{'met' if met else 'NOT met'} ({n_ok}/{n_timed}, last "
          f"{states[-1]})")
    if not rmse < 0.03 * length:
        raise RuntimeError(f"batched path: ATE {rmse:.5f} >= 3% of the "
                           f"path ({length:.3f})")
    if smap.kf_feat_pending[: smap.n_kf].any():
        raise RuntimeError("a deferred keyframe extraction never ran")


def check_graph_vs_eager(system, frames, profiled=True):
    """The captured frame step against the eager frame_step on the card,
    from the tracker's final carry and cache over the given frames: per
    frame from the same inputs (poses within 1e-5, tracked and visible
    masks equal; bit-exact or not), then both chained over the frames in
    turns (eager, graph, graph, eager) for ms per frame, and, if
    `profiled`, torch.profiler for launches per frame. Returns the
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ygz_tpu_torch.frontend.framestep import (FrameCarry, frame_step,
                                                  unpack_out)
    from ygz_tpu_torch.utils.profiling import LAUNCH_CALLS

    tr = system.tracker
    stepper = tr._stepper
    graph = _a_graph(stepper)
    cap = tr.cfg.max_track
    cache = tr._snap.ready_cache()
    start = FrameCarry(*(a.clone() for a in graph.carry))

    def eager_run(carry, imgs):
        outs = []
        for img in imgs:
            carry, packed = frame_step(torch.as_tensor(img, device="cuda"),
                                       carry, cache, stepper.no_pred,
                                       graph.remap, tr.intr)
            outs.append(packed.cpu())
        return carry, outs

    def graph_run(carry, imgs):
        graph.load(carry, cache, stepper.no_pred)
        return graph.carry, [graph.step(torch.from_numpy(img)).cpu()
                             for img in imgs]

    # per frame, from the same inputs
    worst_R = worst_t = 0.0
    exact, masks = True, True
    carry = FrameCarry(*(a.clone() for a in start))
    for img in frames:
        new, (e,) = eager_run(carry, [img])
        _, (g,) = graph_run(carry, [img])
        a, b = unpack_out(e.numpy(), cap), unpack_out(g.numpy(), cap)
        worst_R = max(worst_R, float(np.abs(a.R - b.R).max()))
        worst_t = max(worst_t, float(np.abs(a.t - b.t).max()))
        masks &= bool(np.array_equal(a.tracked, b.tracked)
                      and np.array_equal(a.visible, b.visible))
        exact &= bool(torch.equal(e, g)) and all(
            torch.equal(x, y) for x, y in zip(new, graph.carry))
        carry = FrameCarry(*(x.clone() for x in new))
    # chained, in turns
    ms = {}
    for label, run in (("eager", eager_run), ("graph", graph_run),
                       ("graph", graph_run), ("eager", eager_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(FrameCarry(*(a.clone() for a in start)), frames)
        torch.cuda.synchronize()
        ms.setdefault(label, []).append(
            1e3 * (time.perf_counter() - t0) / len(frames))
    # launches per frame (host API calls) and device time per frame
    counts = {}
    runs = (("eager", eager_run), ("graph", graph_run)) if profiled else ()
    for label, run in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(FrameCarry(*(a.clone() for a in start)), frames[:5])
            torch.cuda.synchronize()
        ev = prof.key_averages()
        calls = collections.Counter()
        for e in ev:
            if e.key.startswith(LAUNCH_CALLS):
                calls[e.key] += e.count
        dev = sorted((e for e in ev
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
        dev_us = sum(e.self_device_time_total for e in dev)
        counts[label] = ({k: v / 5 for k, v in calls.items()},
                         1e-3 * dev_us / 5)
        if label == "graph":
            top = [(e.key[:60], round(e.self_device_time_total / 5, 1),
                    e.count / 5) for e in dev[:6]]
            print(f"frame step graph: device kernels per frame "
                  f"{sum(e.count for e in dev) / 5:.0f}; the heaviest "
                  f"(name, us per frame, launches per frame): {top}")
    rec = {"frames": len(frames), "bit_exact": exact,
           "max_abs_R": worst_R, "max_abs_t": worst_t, "masks_equal": masks,
           "eager_ms": ms["eager"], "graph_ms": ms["graph"]}
    for label, (calls, dev_ms) in counts.items():
        rec[f"{label}_calls"] = calls
        rec[f"{label}_device_ms"] = dev_ms
    print(f"frame step, graph vs eager on the card over {len(frames)} "
          f"frames: bit-exact {exact}; max |dR| {worst_R:.2e}, max |dt| "
          f"{worst_t:.2e}; masks equal {masks}")
    print(f"frame step in turns (eager, graph, graph, eager): ms/frame "
          f"{[round(v, 3) for v in ms['eager'][:1] + ms['graph']]} "
          f"{round(ms['eager'][1], 3)}; fps eager "
          f"{1e3 / np.mean(ms['eager']):.2f}, graph "
          f"{1e3 / np.mean(ms['graph']):.2f}")
    for label, (calls, dev_ms) in counts.items():
        print(f"frame step {label}: host launch calls per frame {calls}; "
              f"device time {dev_ms:.3f} ms per frame")
    if worst_R > 1e-5 or worst_t > 1e-5 or not masks:
        raise RuntimeError("the graph replay disagrees with the eager step")
    return rec


def pose_case(seed, n, stereo=False, behind=0, no_valid=False, unit=False):
    """A seeded pose problem (numpy): points before a camera ~3 deg and 7 cm
    from the start pose, 0.5-px noise, 1/8 gross outliers; optional stereo
    rows (40% of them mono), points behind the camera, no valid row, unit
    weights (the PnP polish)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 10, n)], 1).astype(np.float32)
    R = rodrigues(np.array([0.03, -0.04, 0.01]))
    t = np.array([0.1, -0.05, 0.2])
    Xc = X @ R.T + t
    uv = np.stack([F * Xc[:, 0] / Xc[:, 2] + W / 2 - 0.5,
                   F * Xc[:, 1] / Xc[:, 2] + H / 2 - 0.5], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    uv[: n // 8] += rng.uniform(20, 60, (n // 8, 2))
    if behind:
        X[n - behind:] = -X[n - behind:]
    is2 = (np.ones(n) if unit else 0.25 ** rng.integers(0, 4, n))
    valid = np.zeros(n, bool) if no_valid else rng.random(n) > 0.05
    ur = None
    if stereo:
        ur = uv[:, 0] - STEREO_BF / Xc[:, 2] + rng.normal(0, 0.3, n)
        ur[rng.random(n) < 0.4] = -1.0
    f32 = np.float32
    return dict(X=X, uv=uv.astype(f32), is2=is2.astype(f32), valid=valid,
                R0=rodrigues(np.array([0.07, -0.02, 0.04])).astype(f32),
                t0=(t + [0.05, -0.03, 0.04]).astype(f32),
                ur=None if ur is None else ur.astype(f32),
                bf=STEREO_BF if stereo else 0.0)


def rodrigues(w):
    th = float(np.linalg.norm(w))
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def pose_args(case, dev="cuda"):
    """pose_optimization's arguments (a dict) of a pose_case."""
    import torch

    t = {k: torch.as_tensor(case[k], device=dev)
         for k in ("X", "uv", "is2", "valid", "R0", "t0")}
    return dict(X=t["X"], uv=t["uv"], inv_sigma2=t["is2"], valid=t["valid"],
                R0=t["R0"], t0=t["t0"], intr=(F, F, W / 2 - 0.5, H / 2 - 0.5),
                ur=None if case["ur"] is None else torch.as_tensor(
                    case["ur"], device=dev), bf=case["bf"])


def hold_pose_gn(label, kw):
    """pose_optimization's kernel against its plain version on the same
    card inputs; returns max |err| of R and t (0 where both are
    non-finite)."""
    import torch
    from ygz_tpu_torch.backend import optim

    got = optim.pose_optimization(**kw)
    want = optim.pose_optimization_torch(**kw)
    torch.cuda.synchronize()
    g_inl, w_inl = got.inliers.cpu().numpy(), want.inliers.cpu().numpy()
    fin = [bool(torch.isfinite(r.R).all() and torch.isfinite(r.t).all())
           for r in (got, want)]
    n = int(kw["X"].shape[0])
    err = max(float((got.R - want.R).abs().max()),
              float((got.t - want.t).abs().max())) if fin[0] else 0.0
    print(f"pose_gn {label} (N={n}): max |dR|, |dt| {err:.2e}, inliers "
          f"{int(got.n_inliers)} / {int(want.n_inliers)} plain, finite "
          f"{fin[0]} / {fin[1]}")
    ok = fin[0] == fin[1] and int(got.n_inliers) == int(g_inl.sum())
    if not fin[1]:          # no valid row: non-finite in both, no inlier
        ok &= int(got.n_inliers) == 0
    elif n == 1:            # rank-deficient: the row is fitted and kept
        ok &= (g_inl.tolist() == w_inl.tolist()
               and float(got.chi2[0]) < 1e-3)
        err = 0.0
    else:
        # float32 sums in another order: the fixed point agrees to ~1e-7;
        # masks equal but for rows whose chi2 is within 1e-4 of the gate
        gate = kw.get("chi2_th", optim.CHI2_MONO)
        th = np.full(n, gate, np.float32)
        if kw.get("ur") is not None:
            th[kw["ur"].cpu().numpy() >= 0] = 7.815 * gate / optim.CHI2_MONO
        c2 = want.chi2.cpu().numpy()
        near = np.abs(c2 - th) <= 1e-4 * th
        ok &= (err < 1e-5 and np.array_equal(g_inl[~near], w_inl[~near])
               and np.allclose(got.chi2.cpu().numpy(), c2, atol=1e-2,
                               rtol=1e-3))
    if not ok:
        raise RuntimeError(f"pose_gn kernel disagrees with the plain version "
                           f"on {label}")
    return err


def hold_sparse_align(label, kw):
    """sparse_image_align's kernel against its plain version on the same
    card inputs; returns max |err| of R and t (0 when no point is valid)."""
    import torch
    from ygz_tpu_torch.frontend import sparse_align

    got = sparse_align.sparse_image_align(**kw)
    want = sparse_align.sparse_image_align_torch(**kw)
    torch.cuda.synchronize()
    fin = bool(torch.isfinite(want.R).all())
    err = max(float((got.R - want.R).abs().max()),
              float((got.t - want.t).abs().max())) if fin else 0.0
    res = (float(got.mean_res), float(want.mean_res))
    print(f"sparse_align {label} (N={int(kw['uv0'].shape[0])}, levels "
          f"{kw['levels']}, {kw['iters']} iterations): max |dR|, |dt| "
          f"{err:.2e}, n_meas {int(got.n_meas)} / {int(want.n_meas)} plain, "
          f"mean |r| {res[0]:.5f} / {res[1]:.5f}")
    if not fin:             # no valid point: no measurement, diagnostics 0
        ok = (int(got.n_meas) == int(want.n_meas) == 0
              and res[0] == res[1] == 0.0
              and not bool(torch.isfinite(got.R).all()))
    else:
        # float32 sums in another order; a point on a border line may flip
        ok = (err < 1e-5 and abs(int(got.n_meas) - int(want.n_meas)) <= 2
              and abs(res[0] - res[1]) < 1e-3)
    if not ok:
        raise RuntimeError(f"sparse_align kernel disagrees with the plain "
                           f"version on {label}")
    return err


def record_step_calls(system, img):
    """One eager frame step of `img` from the tracker's carry and cache on
    the card, with the arguments of its pose_optimization,
    sparse_image_align and track_local_map_direct calls recorded (as
    passed: the cache's strided columns, the carry pyramid's level views;
    an eager step writes none of them); returns (pose calls, align calls,
    direct calls, launches of each kernel in that step: pose_gn,
    sparse_align, direct_align)."""
    import torch
    from ygz_tpu_torch.backend import optim
    from ygz_tpu_torch.frontend import direct_tracker, framestep
    from ygz_tpu_torch.frontend import sparse_align

    tr = system.tracker
    stepper = tr._stepper
    calls = {"pose": [], "align": [], "direct": []}

    def recorder(key, fn, names):
        def rec(*args, **kw):
            calls[key].append({**dict(zip(names, args)), **kw})
            return fn(*args, **kw)
        return rec

    pose_names = ("X", "uv", "inv_sigma2", "valid", "R0", "t0", "intr")
    align_names = ("ref_pyr", "cur_pyr", "uv0", "X_ref", "valid", "intr",
                   "R_init", "t_init")
    direct_names = ("cur_pyr", "R_pred", "t_pred", "pt_xyz", "pt_valid",
                    "pt_patch", "pt_ref_uv", "pt_ref_level", "pt_ref_R",
                    "pt_ref_t", "intr")
    real = (direct_tracker.pose_optimization, framestep.sparse_image_align,
            framestep.track_local_map_direct)
    direct_tracker.pose_optimization = recorder(
        "pose", optim.pose_optimization, pose_names)
    framestep.sparse_image_align = recorder(
        "align", sparse_align.sparse_image_align, align_names)
    framestep.track_local_map_direct = recorder(
        "direct", direct_tracker.track_local_map_direct, direct_names)
    before = (optim.pose_optimization.launches,
              sparse_align.sparse_image_align.launches,
              direct_tracker.direct_align.launches)
    try:
        graph = _a_graph(stepper)
        carry = framestep.FrameCarry(*(a.clone() for a in graph.carry))
        framestep.frame_step(torch.as_tensor(img, device="cuda"), carry,
                             tr._snap.ready_cache(), stepper.no_pred,
                             graph.remap, tr.intr)
        torch.cuda.synchronize()
    finally:
        (direct_tracker.pose_optimization, framestep.sparse_image_align,
         framestep.track_local_map_direct) = real
    launches = (optim.pose_optimization.launches - before[0],
                sparse_align.sparse_image_align.launches - before[1],
                direct_tracker.direct_align.launches - before[2])
    return calls["pose"], calls["align"], calls["direct"], launches


def _a_graph(stepper):
    """A captured graph of the stepper: the per-frame one, else the chunk
    path's (a tracker that only ran track_batch)."""
    return stepper.graph if stepper.graph is not None else \
        stepper.batch_graph


def gn_kernel_names(system, frames):
    """pose_gn, sparse_align and direct_align kernels per graph replay of
    the tracker's frame step over the frames (torch.profiler's device
    records), from the graph's carry, which is put back afterwards; and
    the replay's device ms per frame (kernels and copies)."""
    import torch
    from ygz_tpu_torch.frontend.framestep import FrameCarry
    from ygz_tpu_torch.utils.profiling import device_events

    tr = system.tracker
    graph = _a_graph(tr._stepper)
    saved = FrameCarry(*(a.clone() for a in graph.carry))
    graph.load(None, tr._snap.ready_cache(), tr._stepper.no_pred)
    imgs = iter(frames)
    dev, _ = device_events(lambda: graph.step(torch.from_numpy(next(imgs))),
                           len(frames))
    graph.load(saved)
    names = [e.name() for e in dev]
    counts = tuple(sum(k in n for n in names) / len(frames)
                   for k in ("pose_gn_kernel", "sparse_align_kernel",
                             "direct_align_kernel"))
    return counts, 1e-6 * sum(e.duration_ns() for e in dev) / len(frames)


def time_gn(label, fn, plain, steps, n_bytes, n_ops):
    """Device and CUDA-event times of a kernel and its plain version at one
    call's inputs, the bound and us per GN step; returns a dict."""
    ms, kernels = device_time(fn, 50)
    plain_ms, plain_kernels = device_time(plain, 3)
    rec = {"ms": ms, "event_ms": time_cuda(fn, 50), "plain_ms": plain_ms,
           "plain_event_ms": time_cuda(plain, 3), "steps": steps,
           "us_per_step": 1e3 * ms / steps, "bytes": n_bytes,
           "operations": n_ops, "plain_kernels": plain_kernels,
           "kernels_per_call": kernels}
    rec["bound_ms"], rec["bound_by"] = bound(n_bytes, n_ops)
    rec["bound_us"] = 1e3 * rec["bound_ms"]
    print(f"{label}: device {1e3 * ms:.3f} us per call over {kernels:.0f} "
          f"kernel ({1e3 * ms / steps:.3f} us per GN step, {steps} dependent "
          f"steps); bound {rec['bound_us']:.4f} us by {rec['bound_by']} "
          f"({n_bytes} B, {n_ops} operations; "
          f"{100 * rec['bound_ms'] / ms:.2f}% of it); CUDA events "
          f"{1e3 * rec['event_ms']:.3f} us; plain version "
          f"{1e3 * plain_ms:.3f} us device over {plain_kernels:.0f} kernels, "
          f"{1e3 * rec['plain_event_ms']:.3f} us events")
    return rec


def direct_names_pts():
    """track_local_map_direct's seven per-point arguments, in order."""
    return ("pt_xyz", "pt_valid", "pt_patch", "pt_ref_uv", "pt_ref_level",
            "pt_ref_R", "pt_ref_t")


def plain_direct_passes(kw, R1, t1):
    """The plain version of the direct tracker's two passes (no pose GN):
    the setup at the prediction, align_all there and at (R1, t1), the
    merge."""
    import torch
    from ygz_tpu_torch.frontend import direct_tracker as dt
    from ygz_tpu_torch.ops.image import stack_and_height

    stack, h0 = stack_and_height(kw["cur_pyr"], 4)
    pts = tuple(kw[k] for k in direct_names_pts())
    _, lvl, warped, wok = dt._warp_setup(
        h0, stack.shape[1], kw["R_pred"], kw["t_pred"], *pts, kw["intr"], 4)
    align_all = dt._make_align_all(stack, h0, pts[0], pts[1], warped, wok,
                                   lvl, kw["intr"], 4)
    uv, ok = align_all(kw["R_pred"], kw["t_pred"])
    uv2, ok2 = align_all(R1, t1)
    return torch.where(ok[:, None], uv, uv2), ok | ok2


def hold_direct(label, kw):
    """track_local_map_direct's kernel (two launches) and
    refine_matches_core's (one, at the prediction as a known pose) against
    their plain versions on the same card inputs: ok on >= 99% of the
    points, uv within 1e-3 px at the search level on >= 99% of those
    aligned in both and within 0.1 px on all (a point at the 0.03-px test
    may stop one step earlier or later), visible equal on >= 99%, the pose
    within 1e-4. Returns the largest uv difference at the search level."""
    import torch
    from ygz_tpu_torch.frontend import direct_tracker as dt

    got = dt.track_local_map_direct(**kw)
    want = dt.track_local_map_direct_torch(**kw)
    ref = {k.replace("_pred", "_cur"): v for k, v in kw.items()}
    r_got = dt.refine_matches_core(**ref)
    r_want = dt.refine_matches_core_torch(**ref)
    torch.cuda.synchronize()
    scale = 2.0 ** want.level.float()
    errs, oks = [], []
    for (ug, og), (uw, ow) in (((got.uv, got.aligned),
                                (want.uv, want.aligned)),
                               (r_got, r_want)):
        both = og & ow
        d = ((ug - uw).abs().max(1).values / scale)[both].cpu().numpy()
        errs.append(d)
        oks.append(float((og == ow).float().mean()))
    d = np.concatenate(errs)
    n_al = int(want.aligned.sum())
    err_pose = max(float((got.R - want.R).abs().max()),
                   float((got.t - want.t).abs().max())) if n_al >= 8 else 0.0
    vis = float((got.visible == want.visible).float().mean())
    print(f"direct_align {label} (N={int(kw['pt_xyz'].shape[0])}): aligned "
          f"{int(got.aligned.sum())} / {n_al} plain (agree {oks[0]:.4f}), "
          f"refined {int(r_got[1].sum())} / {int(r_want[1].sum())} (agree "
          f"{oks[1]:.4f}); |duv| at the level: median "
          f"{np.median(d) if len(d) else 0:.2e}, max "
          f"{d.max() if len(d) else 0:.2e}, over 1e-3 on "
          f"{int((d >= 1e-3).sum())} of {len(d)}; max |dR|, |dt| "
          f"{err_pose:.2e}; visible agree {vis:.4f}; inliers "
          f"{int(got.n_inliers)} / {int(want.n_inliers)}")
    ok = (min(oks) >= 0.99 and vis >= 0.99 and err_pose < 1e-4
          and (not len(d) or ((d < 1e-3).mean() >= 0.99 and d.max() < 0.1)))
    if not ok:
        raise RuntimeError(f"direct_align kernel disagrees with the plain "
                           f"version on {label}")
    return float(d.max()) if len(d) else 0.0


def check_gn_kernels(system, frames):
    """The frame step's two Gauss-Newton kernels (csrc/pose_gn.cu,
    csrc/sparse_align.cu) and the direct tracker's (csrc/direct_align.cu)
    against their plain versions on the card: at seeded edge cases and at
    the main path's inputs (recorded from one eager frame step of the
    tracker's 512-point cache); two launches repeating bit for bit; one
    eager step launching 2 + 1 + 2 of them and one graph replay running
    2 + 1 + 2; times, bounds and us per step, the replay's device time per
    frame. Returns the three kernel records."""
    import torch
    from ygz_tpu_torch.backend import optim
    from ygz_tpu_torch.frontend import direct_tracker, sparse_align
    from ygz_tpu_torch.ops.image import stack_and_height

    pose_calls, align_calls, direct_calls, launches = record_step_calls(
        system, frames[0])
    print(f"one eager frame step: pose_gn launches {launches[0]}, "
          f"sparse_align launches {launches[1]}, direct_align launches "
          f"{launches[2]}")
    if launches != (2, 1, 2) or len(pose_calls) != 2 \
            or len(align_calls) != 1 or len(direct_calls) != 1:
        raise RuntimeError("a frame step did not launch pose_gn twice, "
                           "sparse_align once and direct_align twice")
    per_replay, replay_ms = gn_kernel_names(system, frames[:4])
    print(f"graph replay: pose_gn {per_replay[0]}, sparse_align "
          f"{per_replay[1]}, direct_align {per_replay[2]} kernels per frame "
          f"step; device time {replay_ms:.4f} ms per frame")
    if per_replay != (2, 1, 2):
        raise RuntimeError("a graph replay did not run 2 pose_gn, 1 "
                           "sparse_align and 2 direct_align kernels")

    pose_err = max(hold_pose_gn(f"main path call {i}", kw)
                   for i, kw in enumerate(pose_calls))
    for label, spec in (
            ("stereo rows", dict(seed=0, n=512, stereo=True)),
            ("one row", dict(seed=1, n=1)),
            ("1500 rows", dict(seed=2, n=1500)),
            ("40 behind the camera", dict(seed=3, n=512, behind=40)),
            ("no valid row", dict(seed=6, n=128, no_valid=True))):
        pose_err = max(pose_err, hold_pose_gn(label, pose_args(
            pose_case(**spec))))
    pose_err = max(pose_err, hold_pose_gn("the PnP polish's gate", dict(
        pose_args(pose_case(seed=4, n=300, unit=True)),
        chi2_th=optim.CHI2_MONO)))

    main = align_calls[0]
    align_err = hold_sparse_align("main path", main)
    rng = np.random.default_rng(9)
    border = dict(main, uv0=main["uv0"].clone(), levels=(2, 1), iters=3)
    n = border["uv0"].shape[0]
    # a quarter of the points onto level 1's and level 2's 3-px border
    # lines (+- 1 px), two onto the image's corners
    for j, s in enumerate((0.5, 0.25)):
        idx = torch.as_tensor(rng.choice(n, n // 8, replace=False),
                              device="cuda")
        edge = (3.0 + 0.5) / s - 0.5 + rng.uniform(-1, 1, n // 8) / s
        border["uv0"][idx, j] = torch.as_tensor(edge, dtype=torch.float32,
                                                device="cuda")
    border["uv0"][:2] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0]])
    for label, kw in (
            ("levels (2, 1), 3 iterations", dict(main, levels=(2, 1),
                                                 iters=3)),
            ("level borders", border),
            ("no valid point", dict(main, valid=torch.zeros_like(
                main["valid"])))):
        align_err = max(align_err, hold_sparse_align(label, kw))

    # two launches on the same inputs: the same bits
    a = [optim.pose_optimization(**pose_calls[1]) for _ in range(2)]
    b = [sparse_align.sparse_image_align(**main) for _ in range(2)]
    torch.cuda.synchronize()
    same = (all(torch.equal(x, y) for x, y in zip(*a)),
            all(torch.equal(x, y) for x, y in zip(*b)))
    print(f"repeat bit for bit: pose_gn {same[0]}, sparse_align {same[1]}")
    if not all(same):
        raise RuntimeError("a Gauss-Newton kernel did not repeat")

    kw = pose_calls[1]
    N = int(kw["X"].shape[0])
    # rows with a right-image u (none on the main path: ur is None there)
    n_st = 0 if kw.get("ur") is None else int((kw["ur"] >= 0).sum())
    rounds, iters = 4, 10
    pose_rec = time_gn(
        f"pose_gn at the main path's N={N}",
        lambda: optim.pose_optimization(**kw),
        lambda: optim.pose_optimization_torch(**kw), rounds * iters,
        *pose_gn_work(N, rounds, iters, n_st))
    lv, it = main["levels"], main["iters"]
    N = int(main["uv0"].shape[0])
    align_rec = time_gn(
        f"sparse_align at the main path's N={N}, levels {lv}",
        lambda: sparse_align.sparse_image_align(**main),
        lambda: sparse_align.sparse_image_align_torch(**main), len(lv) * it,
        *sparse_align_work(N, len(lv), it))
    direct = direct_calls[0]
    direct_err = hold_direct("main path", direct)
    N = int(direct["pt_xyz"].shape[0])
    rng = np.random.default_rng(15)
    nan_patch = dict(direct, pt_patch=direct["pt_patch"].clone())
    nan_patch["pt_patch"][torch.as_tensor(
        rng.choice(N, N // 8, replace=False), device="cuda")] = float("nan")
    behind = dict(direct, pt_xyz=direct["pt_xyz"].clone())
    behind["pt_xyz"][-40:] = -behind["pt_xyz"][-40:]
    for label, kw in (
            ("NaN patches", nan_patch),
            ("no valid point", dict(direct, pt_valid=torch.zeros_like(
                direct["pt_valid"]))),
            ("40 behind the camera", behind)):
        direct_err = max(direct_err, hold_direct(label, kw))
    c = [direct_tracker.track_local_map_direct(**direct) for _ in range(2)]
    r = [direct_tracker.refine_matches_core(
        **{k.replace("_pred", "_cur"): v for k, v in direct.items()})
        for _ in range(2)]
    torch.cuda.synchronize()
    same = (all(torch.equal(x, y) for x, y in zip(*c))
            and all(torch.equal(x, y) for x, y in zip(*r)))
    print(f"repeat bit for bit: direct_align {same}")
    if not same:
        raise RuntimeError("the direct_align kernel did not repeat")
    # the frame's two passes: the setup at the prediction, then pass 2 at
    # the first pose GN's result (the second pose call's start)
    R1, t1 = pose_calls[1]["R0"], pose_calls[1]["t0"]
    stack, h0 = stack_and_height(direct["cur_pyr"], 4)
    pts = tuple(direct[k] for k in direct_names_pts())

    def kernel_passes():
        uv1, ok1, setup = direct_tracker.direct_align(
            stack, h0, pts, direct["intr"], direct["R_pred"],
            direct["t_pred"])
        direct_tracker.direct_align(stack, h0, pts, direct["intr"], R1, t1,
                                    setup=setup, prev=(uv1, ok1))

    direct_rec = time_gn(
        f"direct_align at the main path's N={N}, two passes",
        kernel_passes, lambda: plain_direct_passes(direct, R1, t1), 2 * 10,
        *direct_align_work(N))
    direct_rec["replay_device_ms_per_frame"] = replay_ms
    common = {"route": "cuda", "library_ms": None}
    return ({"name": "pose_gn", **common,
             "source": "ygz_tpu_torch/csrc/pose_gn.cu",
             "replaces": "ygz_tpu/backend/optim.py:197",
             "max_abs_err": pose_err,
             "launches_per_eager_frame_step": launches[0],
             "kernels_per_graph_replay": per_replay[0], **pose_rec},
            {"name": "sparse_align", **common,
             "source": "ygz_tpu_torch/csrc/sparse_align.cu",
             "replaces": "ygz_tpu/frontend/sparse_align.py:44",
             "max_abs_err": align_err,
             "launches_per_eager_frame_step": launches[1],
             "kernels_per_graph_replay": per_replay[1], **align_rec},
            {"name": "direct_align", **common,
             "source": "ygz_tpu_torch/csrc/direct_align.cu",
             "replaces": "ygz_tpu/ops/align.py:179 align2d_stacked with "
                         "ygz_tpu/frontend/direct_tracker.py:49 _warp_setup",
             "max_abs_err": direct_err,
             "launches_per_eager_frame_step": launches[2],
             "kernels_per_graph_replay": per_replay[2], **direct_rec})


def run_counted(fast, label, fn):
    """Runs fn with every kernel's launch count set to 0 and the
    extractor's calls counted; checks one fused launch per extraction and
    no single-threshold launch. Returns (fn's result, fused launches,
    single-threshold launches), both read at the end of this run."""
    import torch

    from ygz_tpu_torch.backend import optim
    from ygz_tpu_torch.frontend import direct_tracker, sparse_align

    gn = (optim.pose_optimization, sparse_align.sparse_image_align,
          direct_tracker.direct_align)
    fast.fast_score_map.launches = 0
    fast.fast_corner_maps.launches = 0
    for wrapper in gn:
        wrapper.launches = 0
    with counted_extractions() as extractions:
        out = fn()
    torch.cuda.synchronize()
    fused = fast.fast_corner_maps.launches
    single = fast.fast_score_map.launches
    GN_LAUNCHES[label] = {"pose_gn": gn[0].launches,
                          "sparse_align": gn[1].launches,
                          "direct_align": gn[2].launches}
    by = collections.Counter(extractions)
    print(f"{label}: {len(extractions)} extractions ({dict(by)}), "
          f"fast_corners launches {fused}, single-threshold fast_score "
          f"launches {single}; Gauss-Newton and direct_align kernel "
          f"launches outside graph captures and replays "
          f"{GN_LAUNCHES[label]}")
    if not extractions or fused != len(extractions) or single:
        raise RuntimeError(f"{label} did not make exactly one fast_corners "
                           f"launch per extraction")
    return out, fused, single


# run_counted's Gauss-Newton and direct_align kernel launches per path
# (wrapper counts: eager calls and the warm-up steps of each frame-step
# graph; a call inside a capture launches nothing and a graph replay runs
# its kernels with no wrapper call, so neither counts)
GN_LAUNCHES = {}


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


def check_live_loop(fast):
    """Phase 12: ate_report.run_mono_loop with nuisances on the card (640
    frames at 640x480, the async worker, track_batch=8): at least one loop
    closed on the mapping worker (detect -> compute_sim3 -> correct, then a
    global BA), frames OK > 0.9 and 7-DoF ATE < 0.25 (the endurance gate).
    Returns (fused, single-threshold) FAST launches of the run."""
    from ygz_tpu_torch.frontend.tracker import MonoTracker, TrackerConfig
    from ygz_tpu_torch.tools import ate_report

    t0 = time.perf_counter()
    with ate_report.keyframe_log(MonoTracker) as (created, decided):
        res, fused, single = run_counted(
            fast, "live loop",
            lambda: ate_report.run_mono_loop(True, "cuda"))
    secs = time.perf_counter() - t0
    # C-ref15: with the JAX count a keyframe made under weak tracking held
    # c2 shut until kf_max_gap here, and the run lost track for good
    stalls = ate_report.weak_keyframe_stalls(
        created, decided, TrackerConfig().kf_max_gap)
    print(f"live loop: {len(created)} keyframes made, "
          f"{sum(n < 50 for _, n in created)} under weak tracking (< 50 "
          f"points); no keyframe for kf_max_gap frames after a weak one "
          f"(frame, points, gap, median inliers): {stalls}")
    system = res.system
    smap = system.map
    tr = system.tracker
    print(f"live loop: {res.n} frames in {secs:.1f} s with the render; "
          f"frames OK {res.ok}/{res.n} ({res.ok / res.n:.4f}); ATE RMSE "
          f"(7-DoF) {res.rmse:.4f}; loops closed {res.loops} (detect ran "
          f"{tr.loop_closer.n_detect} times); keyframes {smap.n_kf} created, "
          f"{int(smap.kf_valid[:smap.n_kf].sum())} alive; map.max_kf "
          f"{smap.max_kf}; async worker {tr._map_worker is not None}")
    for ev in res.events:
        print(f"  loop event: {ev}")
    print(f"live loop {tr.timer.report()}")
    if tr._map_worker is None or res.loops < 1 or not res.events:
        raise RuntimeError("the live loop run closed no loop on the worker")
    if not res.ok > 0.9 * res.n:
        raise RuntimeError(f"live loop: only {res.ok}/{res.n} frames OK")
    if not res.rmse < 0.25:
        raise RuntimeError(f"live loop: ATE {res.rmse:.4f} >= 0.25")
    return fused, single


def profile_phase():
    """tools/profile_framestep on the card, run as a user runs it (python
    -m, a process of its own): host ms, device ms (the sum of each stage's
    kernels by torch.profiler) and kernels per call for each stage of the
    frame step, and the whole step replayed at B = 8. Prints its stage
    table."""
    proc = subprocess.run(
        [sys.executable, "-m", "ygz_tpu_torch.tools.profile_framestep"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    lines = proc.stdout.splitlines()
    start = next((i for i, line in enumerate(lines)
                  if line.startswith("frame step stages")),
                 max(len(lines) - 20, 0))
    print("\n".join(lines[start:]))
    if proc.returncode != 0:
        raise RuntimeError(f"profile_framestep failed ({proc.returncode}): "
                           f"{proc.stderr[-2000:]}")


def tree_root(name):
    """An empty directory for a synthesized dataset tree under the
    git-ignored build/ of this checkout."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "smoke_trees" / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return str(root)


@contextlib.contextmanager
def counted_depth_seeds():
    """Depth points seeded per keyframe by any RGB-D or stereo tracker
    while the block runs (a dict keyframe -> points)."""
    from ygz_tpu_torch.frontend.tracker import RgbdTracker

    seeded = {}
    real = RgbdTracker._create_depth_points

    def counted(self, smap, kf, pyr):
        seeded[kf] = real(self, smap, kf, pyr)
        return seeded[kf]

    RgbdTracker._create_depth_points = counted
    try:
        yield seeded
    finally:
        RgbdTracker._create_depth_points = real


def states_after_init(system):
    """(states, share OK after the first OK frame) of a run."""
    states = [rec.state for rec in system.trajectory]
    if "OK" not in states:
        raise RuntimeError("the tracker never initialized")
    after = states[states.index("OK"):]
    return states, sum(s == "OK" for s in after) / len(after)


def runner_report(label, system, timer, smi):
    """Prints the runner's stage report, its median ms per frame and the
    decode ms per frame; returns (median ms per frame, decode ms per
    frame)."""
    from ygz_tpu_torch import native

    per_frame = len(timer.decode) / max(len(timer.times), 1)
    decode_ms = 1e3 * float(np.median(timer.decode)) * per_frame
    print(f"runner {label} ({smi}): median {timer.median_ms():.2f} ms per "
          f"frame over {len(timer.times)} frames; decode {decode_ms:.3f} ms "
          f"per frame ({per_frame:.0f} image(s) each) by "
          f"{native.route()}")
    print(f"runner {label} ({smi}) {system.tracker.timer.report()}")
    return timer.median_ms(), decode_ms


def run_euroc_runner(fast, frames, poses, smi):
    """A EuRoC tree (cam0 752x480 at 20 fps, its ground truth, a settings
    file with ORBextractor.keypointMode: octree) driven through
    examples/mono_euroc.py on the card: frames OK after init >= 0.80, the
    last OK, 7-DoF ATE < 3% of the path, one trajectory row per OK frame,
    one fused launch per extraction. Returns (root, fused launches, the
    runner's numbers)."""
    from ygz_tpu_torch.eval.ate import ate_rmse
    from ygz_tpu_torch.examples import mono_euroc
    from ygz_tpu_torch.utils.dataset_trees import settings_yaml, write_euroc

    root = tree_root("euroc")
    t0 = time.perf_counter()
    write_euroc(root, frames, poses, fps=20.0)
    yml = f"{root}/settings.yaml"
    with open(yml, "w") as f:
        f.write(settings_yaml(F, F, W / 2.0 - 0.5, H / 2.0 - 0.5, W, H, 20.0,
                              {"ORBextractor.keypointMode": "octree"}))
    print(f"EuRoC tree: {len(frames)} frames written in "
          f"{time.perf_counter() - t0:.1f} s")
    traj = f"{root}/trajectory.txt"
    (system, timer), *launches = run_counted(
        fast, "runner mono_euroc (octree)",
        lambda: mono_euroc.main([root, "--settings", yml, "--eval-ate",
                                 "--timings", "--out", traj]))
    if system.tracker.extractor.mode != "octree":
        raise RuntimeError("the settings file did not select the octree "
                           "keypoint mode")
    states, frac = states_after_init(system)
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    est, gt = np.array(est), np.array(gt)
    rmse, _ = ate_rmse(est, gt, with_scale=True)
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    rows = np.loadtxt(traj, ndmin=2)
    print(f"runner mono_euroc (octree): frames OK after init {frac:.3f}, "
          f"last {states[-1]}; keyframes {system.map.n_kf}; ATE RMSE (7-DoF, "
          f"{len(est)} poses) {rmse:.5f} over a {length:.3f} path "
          f"({100 * rmse / length:.3f}%); trajectory rows {len(rows)}")
    if frac < 0.8 or states[-1] != "OK":
        raise RuntimeError(f"runner mono_euroc: {frac:.3f} OK after init, "
                           f"last {states[-1]}")
    if not rmse < 0.03 * length:
        raise RuntimeError(f"runner mono_euroc: ATE {rmse:.5f} >= 3% of "
                           f"the path")
    if rows.shape != (states.count("OK"), 8) or not np.isfinite(rows).all():
        raise RuntimeError(f"runner mono_euroc: trajectory file {rows.shape} "
                           f"for {states.count('OK')} OK frames")
    ms, decode_ms = runner_report("mono_euroc (octree)", system, timer, smi)
    return root, launches, {"ms_per_frame": ms, "decode_ms": decode_ms,
                            "ate_pct": 100 * rmse / length,
                            "frames_ok": frac}


def tinted(gray):
    """A u8 gray frame as an RGB one whose channels differ (so the
    decoders' colour-to-gray conversion runs on every pixel)."""
    g = gray.astype(np.float32)
    rgb = np.stack([g, 0.85 * g + 20.0, 1.1 * g - 8.0], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def run_tum_runner(fast, rg_poses, rg_frames, smi):
    """A TUM RGB-D tree (640x480 RGB frames, 16-bit depth at 5000 per
    metre, rgb.txt, depth.txt, the ground truth; 30 fps) driven through
    examples/rgbd_tum.py in grid mode with a settings file; the RGB-D
    bounds of check_depth_result. Returns (root, fused launches, the
    runner's numbers)."""
    from ygz_tpu_torch.examples import rgbd_tum
    from ygz_tpu_torch.utils.dataset_trees import settings_yaml, write_tum

    root = tree_root("tum")
    write_tum(root, [tinted(g) for g, _ in rg_frames],
              [d for _, d in rg_frames], rg_poses, fps=30.0)
    yml = f"{root}/settings.yaml"
    with open(yml, "w") as f:
        f.write(settings_yaml(TUM_F, TUM_F, TUM_W / 2.0 - 0.5, H / 2.0 - 0.5,
                              TUM_W, H, 30.0, {"DepthMapFactor": 5000.0}))
    with counted_depth_seeds() as seeded:
        (system, timer), *launches = run_counted(
            fast, "runner rgbd_tum", lambda: rgbd_tum.main(
                [root, "--settings", yml, "--timings",
                 "--out", f"{root}/trajectory.txt"]))
    if system.tracker.extractor.mode != "grid":
        raise RuntimeError("rgbd_tum did not run in grid mode")
    states = [rec.state for rec in system.trajectory]
    check_depth_result("rgbd", system, states, seeded, rg_poses)
    ms, decode_ms = runner_report("rgbd_tum", system, timer, smi)
    return root, launches, {"ms_per_frame": ms, "decode_ms": decode_ms,
                            "frames_ok": states.count("OK") / len(states)}


def run_kitti_runner(fast, smi):
    """A KITTI odometry tree (sequence 00's left camera, 1241x376, f =
    718.856, the principal point of examples/mono_kitti.py; 10 fps) of
    N_KITTI_FRAMES frames along euroc_pose, driven through
    examples/mono_kitti.py with its default camera: frames OK after init
    >= 0.80 and the last OK. Then, at that ragged shape: the fused FAST
    kernel against its plain version on two frames, the run card vs CPU
    frame by frame, the extraction card vs CPU on the frames where either
    run made a keyframe, and the
    frame step card vs CPU and its graph replay against the eager step
    (bit-exact) over 5 more frames. Returns ((fused, single-threshold
    launches), the runner's numbers, the kernel's max |err|)."""
    from ygz_tpu_torch.examples import mono_kitti
    from ygz_tpu_torch.io.datasets import KittiOdometryDataset
    from ygz_tpu_torch.utils.dataset_trees import write_kitti
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    cam = mono_kitti.KITTI_CAM
    scene = SmoothScene(seed=11, w=cam["width"], h=cam["height"],
                        f=cam["fx"], tex_size=2400)
    scene.cx, scene.cy = cam["cx"], cam["cy"]
    t0 = time.perf_counter()
    frames = [scene.render_u8(*euroc_pose(i)) for i in range(N_KITTI_FRAMES)]
    root = tree_root("kitti")
    write_kitti(root, frames, fps=10.0)
    print(f"KITTI tree: {len(frames)} frames {cam['width']}x{cam['height']} "
          f"rendered and written in {time.perf_counter() - t0:.1f} s")
    (system, timer), *launches = run_counted(
        fast, "runner mono_kitti", lambda: mono_kitti.main(
            [root, "--timings", "--out", f"{root}/trajectory.txt"]))
    states, frac = states_after_init(system)
    print(f"runner mono_kitti: frames OK after init {frac:.3f}, last "
          f"{states[-1]}; keyframes {system.map.n_kf}; trajectory "
          f"{''.join(s[0] for s in states)}")
    if frac < 0.8 or states[-1] != "OK":
        raise RuntimeError(f"runner mono_kitti: {frac:.3f} OK after init, "
                           f"last {states[-1]}")
    ms, decode_ms = runner_report("mono_kitti", system, timer, smi)
    err = max(hold_fast_corners(frames[i], f"KITTI frame {i}")
              for i in (0, N_KITTI_FRAMES // 2))
    ds = KittiOdometryDataset(root)
    at = kitti_card_vs_cpu(ds, cam)
    hold_extraction([ds.frames[i].load() for i in at], "grid",
                    f"the KITTI tree (frames {at})", exact_desc=False)
    # the ragged 1241x376 pyramid: the frame step card vs CPU, and its
    # graph replay against the eager step, past the run's last frame
    more = [scene.render_u8(*euroc_pose(i))
            for i in range(N_KITTI_FRAMES, N_KITTI_FRAMES + 5)]
    check_step_vs_cpu(system, more)
    exact = check_graph_vs_eager(system, more, profiled=False)["bit_exact"]
    if not exact:
        raise RuntimeError("mono_kitti: the graph replay is not bit-exact "
                           "against the eager step at 1241x376")
    return launches, {"ms_per_frame": ms, "decode_ms": decode_ms,
                      "frames_ok": frac}, err


def kitti_card_vs_cpu(ds, cam):
    """mono_kitti's System on the card and on the CPU, fed the KITTI tree
    frame by frame: prints where their states first differ, the largest
    camera-centre gap before that, and the frames at which each made its
    keyframes. A record of where the two runs part, not a bound: float32
    sums add in another order on the card. Returns the frames at which
    either run made a keyframe."""
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System

    t0 = time.perf_counter()
    runs = {dev: System(Camera.make(**cam), Sensor.MONOCULAR, device=dev)
            for dev in ("cuda", "cpu")}
    kfs = {dev: [] for dev in runs}
    states = {dev: [] for dev in runs}
    first_diff, gap = None, []
    for i, fr in enumerate(ds):
        img = fr.load()
        centre = {}
        for dev, system in runs.items():
            n_kf = system.map.n_kf
            state, T = system.track_monocular(img, fr.t)
            states[dev].append(state)
            kfs[dev] += [i] * max(system.map.n_kf - n_kf, 0)
            centre[dev] = -T[:3, :3].T @ T[:3, 3]
        if first_diff is None:
            if states["cuda"][-1] != states["cpu"][-1]:
                first_diff = i
            elif states["cuda"][-1] == "OK":
                gap.append((i, float(np.linalg.norm(centre["cuda"]
                                                    - centre["cpu"]))))
    worst = max(gap, key=lambda g: g[1]) if gap else None
    print(f"mono_kitti card vs CPU frame by frame "
          f"({time.perf_counter() - t0:.1f} s): states first differ at "
          f"frame {first_diff}; largest camera-centre gap before that "
          f"(frame, gap) {worst}; gaps at frames 10, 20, 30, 40: "
          f"{[(i, round(g, 7)) for i, g in gap if i in (10, 20, 30, 40)]}")
    for dev in runs:
        print(f"mono_kitti on {dev}: {''.join(x[0] for x in states[dev])}; "
              f"keyframes made at frames {kfs[dev]}")
    return sorted(set(kfs["cuda"] + kfs["cpu"]))


def hold_extraction(images, mode, label, exact_desc=True):
    """OrbExtractor(mode) and its keyframe form (every other feature) on
    each image, card against CPU: uv, level, score and valid equal, angles
    within 1e-4; descriptors bit for bit, or with exact_desc=False within
    C5's Hamming bound (median 0, 99th percentile <= 8 bits: a BRIEF test
    reads two blurred pixels at rotated offsets, so a last-bit difference
    in the blur or the angle can flip it)."""
    import torch
    from ygz_tpu_torch.frontend.extractor import OrbExtractor
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked

    ext = OrbExtractor(mode=mode)
    worst_angle, dists, flipped = 0.0, [], []
    for i, img in enumerate(images):
        outs = {}
        for dev in ("cuda", "cpu"):
            pyr = build_pyramid_stacked(torch.as_tensor(img, device=dev),
                                        None, 4)
            feats = ext(pyr)
            half = feats.valid.clone()
            half[1::2] = False
            ang, desc, kf = ext.extract_keyframe(pyr, feats.uv, feats.level,
                                                 half)
            outs[dev] = [x.cpu() for x in (*feats, ang, desc, *kf)]
        a, b = outs["cuda"], outs["cpu"]
        # Features fields: uv, level, angle, score, desc, valid
        for j in (0, 1, 3, 5, 8, 9, 11, 13):
            if not torch.equal(a[j], b[j]):
                raise RuntimeError(f"{mode} extraction of image {i} of "
                                   f"{label}: field {j} differs between "
                                   f"card and CPU")
        for j in (2, 6, 10):
            worst_angle = max(worst_angle, float((a[j] - b[j]).abs().max()))
        # (descriptors, their angles): the call's, the keyframe form's
        for j, k in ((4, 2), (7, 6), (12, 10)):
            d = (a[j] != b[j]).sum(1)
            dists.append(d)
            for m in torch.nonzero(d).flatten().tolist():
                flipped.append((i, int(d[m]),
                                float((a[k][m] - b[k][m]).abs())))
    d = torch.cat(dists).float()
    print(f"{mode} extraction card vs CPU on {len(images)} images of "
          f"{label} (call and keyframe form): uv, level, score, valid "
          f"equal; max |d angle| {worst_angle:.2e}; descriptors differing "
          f"{len(flipped)} of {len(d)} (image, bits, |d angle|): "
          f"{flipped[:8]}")
    if worst_angle > 1e-4:
        raise RuntimeError(f"{mode} extraction on {label}: angles differ "
                           f"between card and CPU")
    if exact_desc and flipped:
        raise RuntimeError(f"{mode} extraction on {label}: descriptors "
                           f"differ between card and CPU")
    if float(d.median()) != 0 or float(torch.quantile(d, 0.99)) > 8:
        raise RuntimeError(f"{mode} extraction on {label}: descriptors "
                           f"beyond C5's Hamming bound")


def check_octree_card_vs_cpu(root):
    """hold_extraction in octree mode on frames 0 and 80 of the EuRoC
    tree; then extract_keyframe in grid and octree mode on the card, in
    turns (grid, octree, octree, grid): host ms per call."""
    import torch
    from ygz_tpu_torch.frontend.extractor import OrbExtractor
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked
    from ygz_tpu_torch.io.datasets import EurocDataset

    ds = EurocDataset(root)
    hold_extraction([ds.frames[i].load() for i in (0, DARK_FRAME)],
                    "octree", "the EuRoC tree")
    ext = {m: OrbExtractor(mode=m) for m in ("grid", "octree")}
    pyr = build_pyramid_stacked(
        torch.as_tensor(ds.frames[0].load(), device="cuda"), None, 4)
    feats = ext["grid"](pyr)

    def kf_ms(mode, n=20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ext[mode].extract_keyframe(pyr, feats.uv, feats.level,
                                       feats.valid)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    ms = [(m, round(kf_ms(m), 3)) for m in ("grid", "octree", "octree",
                                            "grid")]
    print(f"extract_keyframe on the card in turns (mode, host ms per "
          f"call): {ms}")
    return ms


def check_distorted_graph(smi):
    """examples/mono_euroc.py's default camera (radtan distortion): frames
    rendered through that camera, tracked by System.track_monocular on the
    card (the undistort remap inside the captured frame step), then the
    graph replay held to the eager step over N_DIST_TURN frames
    (bit-exact). Returns check_graph_vs_eager's record."""
    from ygz_tpu_torch.examples.mono_euroc import EUROC_CAM
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System
    from ygz_tpu_torch.utils.synthetic import SmoothScene

    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=3000)
    c = EUROC_CAM
    grid = scene.distorted_grid(c["fx"], c["fy"], c["cx"], c["cy"],
                                c["dist"])
    frames = [np.clip(scene.render_at(*euroc_pose(i), grid), 0,
                      255).astype(np.uint8)
              for i in range(N_DIST + N_DIST_TURN)]
    system = System(Camera.make(**c), Sensor.MONOCULAR, device="cuda")
    states = [system.track_monocular(img, i * 0.05)[0]
              for i, img in enumerate(frames[:N_DIST])]
    print(f"distorted camera: {states.count('OK')}/{N_DIST} OK "
          f"({''.join(s[0] for s in states)}); remap in the graph "
          f"{system.tracker._stepper.graph.remap is not None}")
    if states[-1] != "OK" or system.tracker._stepper.graph.remap is None:
        raise RuntimeError("the distorted-camera run did not reach a "
                           "replayed frame step with its remap")
    rec = check_graph_vs_eager(system, frames[N_DIST:], profiled=False)
    print(f"distorted camera ({smi}): graph replay "
          f"{[round(v, 3) for v in rec['graph_ms']]} ms per frame, eager "
          f"{[round(v, 3) for v in rec['eager_ms']]}; bit-exact "
          f"{rec['bit_exact']}")
    if not rec["bit_exact"]:
        raise RuntimeError("distorted camera: the graph replay is not "
                           "bit-exact against the eager step")
    return rec


def check_png_routes(euroc_root, tum_root):
    """Every PNG route held byte for byte to io/png.py's Python unfilter on
    N_PNG_TIMED frames of the EuRoC tree, 4 RGB and 4 depth frames of the
    TUM tree (written with adaptive row filters, as libpng writes the
    datasets' files) and filter-0 copies of those EuRoC frames: io/png.py
    with the C unfilter (where it built) and the native loader (where g++
    and libpng are; gray only). Each route's decode ms per 752x480 frame
    on both kinds of file. Prints the active route (and why the native one
    did not build)."""
    import glob
    import zlib

    from ygz_tpu_torch import native
    from ygz_tpu_torch.io import png

    print(f"PNG route: {native.route()}; unfilter: {png.unfilter_route()}")
    adaptive = sorted(glob.glob(f"{euroc_root}/mav0/cam0/data/*.png"))
    tum = sorted(glob.glob(f"{tum_root}/rgb/*.png"))[:4]
    depth = sorted(glob.glob(f"{tum_root}/depth/*.png"))[:4]
    root = tree_root("filter0")
    plain = []
    for i, p in enumerate(adaptive[:N_PNG_TIMED]):
        plain.append(f"{root}/{i}.png")
        png.write_png(plain[-1], png.read_png(p))
    kinds = np.zeros(5, np.int64)
    for p in adaptive:
        data = open(p, "rb").read()
        idat = b"".join(b for k, b in png._chunks(data, p) if k == b"IDAT")
        kinds += np.bincount(np.frombuffer(zlib.decompress(idat), np.uint8)
                             .reshape(H, W + 1)[:, 0], minlength=5)
    print(f"EuRoC tree: rows by filter type (None, Sub, Up, Average, "
          f"Paeth) {kinds.tolist()}")
    files = {"adaptive": adaptive[:N_PNG_TIMED], "filter 0": plain}
    held = adaptive[:N_PNG_TIMED] + tum + plain
    want = {p: png.decode_gray(p, force_python=True) for p in held}
    routes = {"io/png.py, Python unfilter":
              lambda p: png.decode_gray(p, force_python=True)}
    if png.unfilter_route() == "C":
        routes["io/png.py, C unfilter"] = png.decode_gray
        if not all(np.array_equal(png.read_png(p),
                                  png.read_png(p, force_python=True))
                   for p in depth):
            raise RuntimeError("the C unfilter disagrees with the Python "
                               "one on 16-bit depth frames")
    if native.available():
        routes["native (libpng)"] = native.decode_gray
    ms = {}
    for name, fn in routes.items():
        same = all(np.array_equal(fn(p), want[p]) for p in want)
        print(f"{name} on {N_PNG_TIMED} gray and {len(tum)} RGB frames "
              f"(adaptive filters) and {len(plain)} filter-0 ones: byte "
              f"for byte {same}")
        if not same:
            raise RuntimeError(f"PNG route {name} disagrees with io/png.py")
        for kind, paths in files.items():
            t0 = time.perf_counter()
            for p in paths:
                fn(p)
            ms[f"{name} ({kind})"] = (1e3 * (time.perf_counter() - t0)
                                      / len(paths))
    print(f"decode ms per 752x480 frame over {N_PNG_TIMED} frames: "
          f"{ {k: round(v, 3) for k, v in ms.items()} }")
    return ms


def run_runner_phase(fast, smi, frames, poses, rg_poses, rg_frames,
                     score_rec, corners_rec):
    """The dataset runners from trees on disk (EuRoC octree, TUM RGB-D,
    KITTI), the octree extraction card vs CPU, the distorted camera's
    graph replay and the PNG routes. Adds the runners' launch counts to
    the kernels' records."""
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    euroc_root, (fused, single), mono = timed(
        "mono_euroc", lambda: run_euroc_runner(fast, frames, poses, smi))
    corners_rec["launches_runner_mono"] = fused
    score_rec["launches_runner_mono"] = single
    tum_root, (fused, single), rgbd = timed("rgbd_tum", lambda: run_tum_runner(
        fast, rg_poses, rg_frames, smi))
    corners_rec["launches_runner_rgbd"] = fused
    score_rec["launches_runner_rgbd"] = single
    (fused, single), kitti, err = timed(
        "mono_kitti", lambda: run_kitti_runner(fast, smi))
    corners_rec["launches_runner_kitti"] = fused
    score_rec["launches_runner_kitti"] = single
    corners_rec["max_abs_err"] = max(corners_rec.get("max_abs_err", 0.0),
                                     err)
    kf_ms = timed("octree_card_vs_cpu",
                  lambda: check_octree_card_vs_cpu(euroc_root))
    dist = timed("distorted_graph", lambda: check_distorted_graph(smi))
    decode = timed("png_routes",
                   lambda: check_png_routes(euroc_root, tum_root))
    rec = {"mono_euroc": mono, "rgbd_tum": rgbd, "mono_kitti": kitti,
           "extract_keyframe_ms": kf_ms, "decode_ms": decode,
           "distorted_graph_ms": dist["graph_ms"],
           "distorted_eager_ms": dist["eager_ms"],
           "distorted_bit_exact": dist["bit_exact"],
           "seconds": secs}
    print(f"runner phase: {sum(secs.values()):.1f} s ({secs})")
    return rec


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
    paths_only = sys.argv[1:] == ["--paths-only"]
    runners_only = sys.argv[1:] == ["--runners-only"]
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
    cuda_build.build_all(verbose=True)
    print(f"kernel build ({', '.join(cuda_build.sources())}, in parallel): "
          f"{time.perf_counter() - t0:.1f} s")
    if paths_only:
        time_paths(smi)
        return 0
    if runners_only:
        _, poses, clean = render_sequence(N_FRAMES, dark=False)
        rg_poses, rg_frames = rgbd_sequence(N_RGBD_FRAMES)
        recs = ({}, {})
        print(json.dumps({"runners": run_runner_phase(
            fast, smi, clean, poses, rg_poses, rg_frames, *recs)}))
        print(json.dumps({"kernels": list(recs)}))
        return 0

    t0 = time.perf_counter()
    scene, poses, clean = render_sequence(N_WARM + N_TIMED + N_TURN,
                                          dark=False)
    frames = with_dark_frame(clean[:N_FRAMES + 3])
    print(f"rendered {len(clean)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    score_rec = check_fast_kernel(frames[0])
    corners_rec = check_fast_corners(frames)

    # the batched async path (System.track_monocular_batch with the
    # mapping worker; frame steps replayed as a CUDA graph)
    n_batch = N_WARM + N_TIMED
    (brun, bstates, tails, logged), fused, single = \
        run_counted(fast, "batched async path",
                    lambda: run_batch_path(clean[:n_batch], "cuda"))
    corners_rec["launches_batch_async"] = fused
    score_rec["launches_batch_async"] = single
    bsys = brun.system
    print(f"batched async path ({smi}) {bsys.tracker.timer.report()}")
    check_batch_result(bsys, bstates, poses[:n_batch], brun.secs,
                       brun.drain_s, tails, logged)
    bench_rec = report_bench(brun, poses[:n_batch])
    gn_recs = check_gn_kernels(bsys, clean[n_batch:])
    step_rec = check_graph_vs_eager(bsys, clean[n_batch:])

    (system, states, ladder, secs), fused, single = run_counted(
        fast, "main path", lambda: run_main_path(frames[:N_FRAMES], "cuda"))
    main_replays = system.tracker._stepper.graph.replays
    main_per_replay, main_replay_ms = gn_kernel_names(system,
                                                      frames[N_FRAMES:])
    print(f"main path: {main_replays} frame-step graph replays; pose_gn "
          f"{main_per_replay[0]}, sparse_align {main_per_replay[1]}, "
          f"direct_align {main_per_replay[2]} kernels per replay of its "
          f"graph, {main_replay_ms:.4f} device ms per replay")
    if main_per_replay != (2, 1, 2):
        raise RuntimeError("a replay of the main path's graph did not run 2 "
                           "pose_gn, 1 sparse_align and 2 direct_align "
                           "kernels")
    corners_rec["launches"], score_rec["launches"] = fused, single
    print(f"main path: {N_FRAMES} frames in {secs:.2f} s "
          f"({1e3 * secs / N_FRAMES:.2f} ms/frame mean)")
    print(f"main path ({smi}) {system.tracker.timer.report()}")
    align, length = check_result(system, states, ladder, poses[:N_FRAMES])
    check_step_vs_cpu(system, frames[N_FRAMES:])
    check_global_ba(system)
    dist_rec, fused, single = check_dist_ba(
        fast, smi, system, frames[:N_FRAMES], poses[:N_FRAMES], states)
    corners_rec["launches_dist_ba"] = fused
    score_rec["launches_dist_ba"] = single
    (corners_rec["launches_relocalization"],
     score_rec["launches_relocalization"]) = check_relocalization(
        system, frames, poses, align, length)
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
    for sensor, dposes, seq in (("stereo", st_poses, pairs),
                                ("rgbd", rg_poses, rg_frames)):
        (dsys, dstates, seeded, secs), fused, single = run_counted(
            fast, f"{sensor} path", lambda: run_depth_path(sensor, seq,
                                                           "cuda"))
        corners_rec[f"launches_{sensor}"] = fused
        score_rec[f"launches_{sensor}"] = single
        print(f"{sensor} path: {len(seq)} frames in {secs:.2f} s "
              f"({1e3 * secs / len(seq):.2f} ms/frame mean)")
        print(f"{sensor} path ({smi}) {dsys.tracker.timer.report()}")
        check_depth_result(sensor, dsys, dstates, seeded, dposes)
        if sensor == "stereo":
            check_stereo_match(dsys, pairs)
    # the first frame steps after RGB-D's one-frame init, card vs CPU
    init_sys = run_depth_path("rgbd", rg_frames[:1], "cuda")[0]
    check_step_vs_cpu(init_sys, [img for img, _ in rg_frames[1:6]])

    # the dataset runners from trees on disk
    runner_rec = run_runner_phase(fast, smi, clean[:N_FRAMES],
                                  poses[:N_FRAMES], rg_poses, rg_frames,
                                  score_rec, corners_rec)

    t0 = time.perf_counter()
    vi_poses, vi_frames, vi_imus = vi_sequence()
    print(f"rendered {len(vi_frames)} mono-VI frames {W}x{H} with their IMU "
          f"in {time.perf_counter() - t0:.1f} s")
    (vsys, vstates, vdebug, ready_at, secs, rec), fused, single = \
        run_counted(fast, "mono-VI path", lambda: run_vi_path(
            vi_frames, vi_imus, "cuda", record=True))
    corners_rec["launches_mono_vi"] = fused
    score_rec["launches_mono_vi"] = single
    print(f"mono-VI path: {len(vi_frames)} frames in {secs:.2f} s "
          f"({1e3 * secs / len(vi_frames):.2f} ms/frame mean)")
    print(f"mono-VI path ({smi}) {vsys.tracker.timer.report()}")
    first = [(r.state, r.R.copy(), r.t.copy()) for r in vsys.trajectory]
    check_vi_result(vsys, vstates, vdebug, ready_at, vi_poses)
    check_vi_numerics(rec, vsys.tracker.vins_scale)
    check_vi_repeat(first, vi_frames, vi_imus)

    (corners_rec["launches_live_loop"],
     score_rec["launches_live_loop"]) = check_live_loop(fast)
    profile_phase()

    print(json.dumps({"bench": bench_rec}))
    print(json.dumps({"frame_step": step_rec}))
    print(json.dumps({"dist_ba": dist_rec}))
    print(json.dumps({"runners": runner_rec}))
    for rec, per_replay in zip(gn_recs, main_per_replay):
        rec["launches"] = GN_LAUNCHES["main path"][rec["name"]]
        rec["main_path_graph_replays"] = main_replays
        rec["kernels_per_main_path_replay"] = per_replay
        rec.update({"launches_" + re.sub(r"\W+", "_", label).strip("_"):
                    n[rec["name"]] for label, n in GN_LAUNCHES.items()})
    if not all(rec["launches"] > 0 for rec in gn_recs):
        raise RuntimeError(f"the main path launched no Gauss-Newton or "
                           f"direct_align kernel: {GN_LAUNCHES['main path']}")
    print(json.dumps({"kernels": [score_rec, corners_rec, *gn_recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
