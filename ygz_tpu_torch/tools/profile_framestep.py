"""Time per stage of the frame step.

Port of the JAX repository's ``tools/profile_framestep.py``. Each stage of
the frame step runs alone on the same inputs (seed 0, 752x480, a 512-point
cache): the pyramid build, sparse image alignment (levels 3 -> 1, 10
iterations), direct local-map tracking, the raw patch-sampling primitive
they share (512 points x 10 x 10), one ``align2d`` on level 0 and one
pose Gauss-Newton (``pose_optimization``, run twice per frame by direct
tracking; ``pose_opt_ms``, a key the JAX tool lacks). For each
stage: host ms per call run eagerly (``<stage>_ms``, the JAX keys), and on
the card the device ms per call as the sum of the stage's kernels and
copies by ``torch.profiler`` (``device_ms``) and their count per call
(``kernels``).
Then the whole step at B = 8, replayed through ``FrameStepGraph`` on the
card (eager on the CPU), in ms per frame. Writes the JSON to ``--out`` and a
chrome trace of one replayed frame under ``build/ygz_tpu_torch/trace/``.

    python -m ygz_tpu_torch.tools.profile_framestep [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import device_label, resolve_device, sync
from ..utils.cuda_build import BUILD_DIR
from ..utils.profiling import device_events

W, H, F = 752, 480, 458.0
CAP = 512
BATCH = 8
STAGES = ("pyramid", "sparse_align", "direct_track", "sample_512x10x10",
          "align2d_L0", "pose_opt")


def host_ms(fn, device, reps=10, warm=2):
    """Mean host ms per call, the queue drained at the end."""
    for _ in range(warm):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def device_ms(fn, reps=2):
    """(device ms per call, device events per call) by torch.profiler: the
    summed duration of the card's kernels and copies over `reps` calls after
    a warm-up (utils/profiling.device_events: the raw event list;
    key_averages() takes about a second per 10^4 events, and a replayed
    chunk runs ~1.8 * 10^5 kernels)."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev, lost = device_events(fn, reps)
    if lost:
        print(f"  torch.profiler: no record for {lost} kernel launches of "
              f"{reps} calls (left out of the time)")
    return 1e-6 * sum(e.duration_ns() for e in dev) / reps, len(dev) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(BUILD_DIR / "profile_framestep.json"))
    ap.add_argument("--trace-dir", default=str(BUILD_DIR / "trace"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..backend.optim import pose_optimization
    from ..frontend.direct_tracker import track_local_map_direct
    from ..frontend.framestep import (frame_step_batch, make_carry,
                                      pack_cache_np)
    from ..frontend.framestep_graph import FrameStepGraph
    from ..frontend.sparse_align import sparse_image_align
    from ..ops.align import align2d, sample_patches
    from ..ops.image import build_pyramid

    w, h, cap = args.width, args.height, args.cap
    intr = (F, F, w / 2.0, h / 2.0)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=device)

    img = t(rng.uniform(0, 255, (h, w)).astype(np.float32))
    imgs = t(rng.uniform(0, 255, (BATCH, h, w)).astype(np.uint8))
    X = np.stack([rng.uniform(-2, 2, cap), rng.uniform(-1.5, 1.5, cap),
                  rng.uniform(4, 9, cap)], 1).astype(np.float32)
    uv = np.stack([intr[0] * X[:, 0] / X[:, 2] + intr[2],
                   intr[1] * X[:, 1] / X[:, 2] + intr[3]], 1).astype(
                       np.float32)
    Xt, uvt = t(X), t(uv)
    valid = torch.ones(cap, dtype=torch.bool, device=device)
    patches = rng.uniform(0, 255, (cap, 20, 20)).astype(np.float32)
    eye3 = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
    cache_packed = t(pack_cache_np(X, np.ones(cap, bool), patches, uv,
                                   np.zeros(cap, np.int32), eye3,
                                   np.zeros((cap, 3), np.float32)))
    cache = (Xt, valid, t(patches), uvt,
             torch.zeros(cap, dtype=torch.int32, device=device), t(eye3),
             torch.zeros((cap, 3), device=device))
    I3 = torch.eye(3, device=device)
    Z3 = torch.zeros(3, device=device)
    pyr = build_pyramid(img, 4, 2.0)
    patches10 = t(rng.uniform(0, 255, (cap, 10, 10)).astype(np.float32))
    ones = torch.ones(cap, device=device)
    stages = {
        "pyramid": lambda: build_pyramid(img, 4, 2.0),
        "sparse_align": lambda: sparse_image_align(
            pyr, pyr, uvt, Xt, valid, intr, I3, Z3, levels=(3, 2, 1),
            iters=10),
        "direct_track": lambda: track_local_map_direct(
            pyr, I3, Z3, *cache, intr, n_levels=4),
        "sample_512x10x10": lambda: sample_patches(pyr[0], uvt, 10),
        "align2d_L0": lambda: align2d(pyr[0], patches10, uvt, valid,
                                      iters=10),
        "pose_opt": lambda: pose_optimization(Xt, uvt, ones, valid, I3, Z3,
                                              intr),
    }
    cuda = device.startswith("cuda")
    res, dev_ms, kernels = {}, {}, {}
    for name, fn in stages.items():
        res[f"{name}_ms"] = host_ms(fn, device, args.reps)
        dev_ms[name], kernels[name] = device_ms(fn) if cuda else (None, None)

    carry = make_carry(pyr, np.eye(3), np.zeros(3), uv, X,
                       np.ones(cap, bool))
    graph = FrameStepGraph(h, w, cap, intr, device=device) if cuda else None

    def chunk():
        return frame_step_batch(imgs, carry, cache_packed, None, intr,
                                graph=graph)

    res["frame_step_batch8_ms"] = host_ms(chunk, device, args.reps, warm=1)
    res["per_frame_ms"] = res["frame_step_batch8_ms"] / BATCH
    if cuda:
        dev_ms["frame_step_batch8"], kernels["frame_step_batch8"] = \
            device_ms(chunk, reps=1)
    res["device_ms"] = dev_ms
    res["kernels"] = kernels

    # the trace holds one frame (a chunk's ~1.8 * 10^5 kernels would make a
    # file of tens of MB)
    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, "framestep_trace.json")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        frame_step_batch(imgs[:1], carry, cache_packed, None, intr,
                         graph=graph)
        sync(device)
    prof.export_chrome_trace(trace)
    res["trace"] = trace
    res["shape"] = [h, w, cap]
    res["platform"] = "cuda" if cuda else "cpu"
    res["device"] = device_label(device)
    print(json.dumps(res, indent=1))
    print(f"frame step stages ({res['device']}; host ms eager, device ms, "
          f"kernels per call):")
    for name in STAGES + ("frame_step_batch8",):
        d, k = dev_ms.get(name), kernels.get(name)
        print(f"  {name:<20s} host {res[name + '_ms']:9.3f} ms  device "
              f"{'not measured' if d is None else f'{d:9.3f} ms'}  kernels "
              f"{'not measured' if k is None else f'{k:.0f}'}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
