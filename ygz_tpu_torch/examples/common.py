"""Shared runner plumbing for the dataset runners (the reference's
Examples/* per-dataset executables, e.g. mono_euroc_vins.cc).

Port of ``examples/common.py``. Each runner is a module of this package,
``python -m ygz_tpu_torch.examples.<name> <dataset> [flags]``, and its
``main(argv=None)`` returns the System and the TrackTimer. The runners track
on the card unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def base_parser(desc):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("dataset", help="dataset root directory")
    p.add_argument("--settings", default=None, help="YAML settings file")
    p.add_argument("--out", default="trajectory.txt",
                   help="output trajectory (TUM format)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--eval-ate", action="store_true",
                   help="evaluate ATE against dataset ground truth")
    p.add_argument("--timings", action="store_true",
                   help="print per-stage wall-time breakdown + counters")
    p.add_argument("--viz", default=None, metavar="DIR",
                   help="dump frame overlays + final map render to DIR "
                        "(the reference's Pangolin viewer, offline)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard global bundle adjustment over the first N "
                        "devices (landmark-block sharded distributed BA; "
                        "0/1 = single device; with --device cpu, N shards "
                        "on the CPU)")
    p.add_argument("--batch", type=int, default=0,
                   help="microbatch size for tracking (frames per chunk; "
                        "0 = per-frame)")
    p.add_argument("--device", default="cuda",
                   help="torch device to track on: cuda (default) or cpu")
    return p


def make_viewer(args):
    """DumpViewer when --viz is given, else a no-op."""
    if args.viz:
        from ..viz import DumpViewer
        return DumpViewer(args.viz)

    class _Null:
        def update(self, *a):
            pass

        def finish(self, *a):
            pass
    return _Null()


def load_system(args, sensor, default_cam=None, **kw):
    import torch

    from ..frontend.tracker import TrackerConfig
    from ..io.config import load_settings
    from ..system import System

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to track on the CPU)")
    if args.settings:
        s = load_settings(args.settings)
        cam = s.camera
        cfg = s.tracker
        if s.vio.use_imu and getattr(sensor, "name", "") == "MONO_VI":
            kw.setdefault("Tbc", s.vio.Tbc)
            # the reference reads these from the YAML too
            # (src/IMU/configparam.cpp)
            kw.setdefault("vins_init_time", s.vio.vins_init_time)
    else:
        cam = default_cam
        cfg = None
    if args.devices > 1:
        cfg = cfg or TrackerConfig()
        cfg.mesh_devices = args.devices
    if args.batch > 1:
        cfg = cfg or TrackerConfig()
        cfg.track_batch = args.batch
    return System(cam, sensor, config=cfg, device=args.device, **kw)


class TrackTimer:
    """Median/mean per-frame wall time (the reference prints these at exit,
    mono_euroc_vins.cc), and the same for the image decodes."""

    def __init__(self):
        self.times = []
        self.decode = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.times.append(time.perf_counter() - self._t0)

    def load(self, fn, *args):
        """fn(*args), a frame's decode, with its wall time kept."""
        t0 = time.perf_counter()
        out = fn(*args)
        self.decode.append(time.perf_counter() - t0)
        return out

    def median_ms(self):
        # skip the warm frames: the first compiles on the CPU; on the card
        # the kernel build and the frame-step graph's capture
        return 1e3 * float(np.median(self.times[3:] or self.times))

    def report(self):
        from .. import native

        t = np.array(self.times[3:] or self.times)
        print(f"tracked {len(self.times)} frames: "
              f"median {np.median(t)*1e3:.1f} ms, mean {t.mean()*1e3:.1f} ms")
        if self.decode:
            d = np.array(self.decode)
            print(f"decoded {len(d)} images: median {np.median(d)*1e3:.2f} "
                  f"ms, mean {d.mean()*1e3:.2f} ms ({native.route()})")


def print_timings(sys_, args):
    """--timings: the tracker's stage report and counters."""
    if args.timings:
        print(sys_.tracker.timer.report())
        print("counters:", {k: v for k, v in sys_.tracker.stats().items()
                            if k != "stage_ms"})


def maybe_eval_ate(sys_, dataset, args, with_scale):
    if not args.eval_ate or getattr(dataset, "gt", None) is None:
        return
    from ..eval.ate import associate_timestamps, ate_rmse

    gt_ts, gt_xyz = dataset.gt
    est_ts = [r.ts for r in sys_.trajectory if r.state == "OK"]
    est_c = [(-r.R.T @ r.t) for r in sys_.trajectory if r.state == "OK"]
    pairs = associate_timestamps(est_ts, gt_ts)
    if len(pairs) < 10:
        print("ATE: not enough associations")
        return
    est = np.array([est_c[i] for i, _ in pairs])
    gt = np.array([gt_xyz[j] for _, j in pairs])
    rmse, _ = ate_rmse(est, gt, with_scale=with_scale)
    print(f"ATE RMSE: {rmse:.4f} m ({'7' if with_scale else '6'}-DoF aligned,"
          f" {len(pairs)} poses)")
    return rmse
