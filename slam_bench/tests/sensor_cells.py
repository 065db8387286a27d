"""Test-local cells of the sensors that no cell of BENCHMARK.json runs yet:
a rectified EuRoC stereo pair, a depth camera and the mono-inertial rig
(``cells/``: configuration, settings and workload files named as the
benchmark's own). They show that the harness runs a configuration of each
sensor without an edit; they are not cells, and the benchmark's own runs
never load them.

One run of one of them per seed on the card, at full size, paced, with the
async worker, as a cell would run (``--control metric_scale`` gives the
System the baseline, the depth or the accelerations 1.25 times too large):

    python3 -m slam_bench.tests.sensor_cells --cell euroc_stereo.live \\
        --seed <n> --seconds <s> [--control metric_scale]

It prints one JSON line: the judgement, every correctness number, the
latency's median and 95th percentile, set-up, the memory peak, keyframes,
the window's stereo search per frame, and of a mono-inertial run the frames
to VINS initialization, ``scale_err_pct`` and the VI stages in ms per call
with their calls since set-up began. A run stopped behind the camera
(``harness.STOP_LATE_S``) prints the stop and what set-up read, and exits
1.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from slam_bench import harness  # noqa: E402

CELLS = Path(__file__).resolve().parent / "cells"
NAMES = ("euroc_stereo.live", "euroc_rgbd.live", "euroc_mono_vi.live")
# the tracker's StageTimer stages of a mono-inertial run
VI_STAGES = ("vins_init", "vio_fuse", "preint", "vio_ba")


def cell(name: str) -> SimpleNamespace:
    """The test-local cell `name` (``<config>.live``), shaped as
    harness.load_cell's: the benchmark's live mix, frame_latency_p50_ms and
    setup_s, no per-layer metric."""
    if name not in NAMES:
        raise SystemExit(f"unknown test-local cell {name!r}; one of {NAMES}")
    spec = harness.benchmark_spec()
    e2e = [m for m in spec["end_to_end"]
           if m["name"] in ("frame_latency_p50_ms", "setup_s")]
    return SimpleNamespace(
        name=name, chips=1,
        config=harness.read_config(CELLS / f"{name.split('.')[0]}.json"),
        traffic=json.loads((harness.BENCH / "traffic" / "live.json")
                           .read_text()),
        workload=json.loads((CELLS / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=[])


def setup_readings(run):
    """What set-up read: its notes, the frames to VINS initialization, and
    the VI stages since set-up began as [ms per call, calls]."""
    means = run.stage_means()
    return {"vi_init_frames": run.notes.get("vi_init_frames"),
            "vi_stages_ms": {k: means[k] for k in VI_STAGES if k in means},
            "setup_notes": {k: run.notes[k] for k in
                            ("init_frames", "render_s", "init_s", "warm_s",
                             "setup_s") if k in run.notes}}


def readings(res, rows, run):
    """The line a rehearsal prints of run_cell's result."""
    import numpy as np

    lat = np.asarray(run.latencies_ms)
    sec, count = run.window_stages.get("stereo_match", (0.0, 0))
    frames = len(run.latencies_ms)
    return {
        "correct": res["correct"],
        "compared": {n: [v, lim] for n, v, lim in rows},
        "numbers": run.notes["numbers"],
        "frame_latency_p50_ms": float(np.percentile(lat, 50)),
        "frame_latency_p95_ms": float(np.percentile(lat, 95)),
        "setup_s": res["metrics"]["setup_s"]["value"],
        "memory_peak_bytes": res["memory_peak_bytes"],
        "attempted": res["attempted"], "failed": res["failed"],
        "keyframes": run.notes["keyframes"],
        "stereo_match_ms_per_frame": 1e3 * sec / frames,
        "stereo_match_calls": count,
        "scale_err_pct": run.notes["numbers"].get("scale_err_pct"),
        **setup_readings(run),
        "notes": {k: run.notes[k] for k in
                  ("feeder_late_ms_p50", "feeder_late_ms_max",
                   "backlog_at_close")}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True, choices=NAMES)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=("metric_scale",), default=None)
    args = ap.parse_args(argv)
    from slam_bench.run import card_label, run_env

    run_env(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sensor_cells: no CUDA card", file=sys.stderr)
        return 2
    head = dict(cell=args.cell, seed=args.seed, control=args.control,
                card=card_label())
    try:
        res, rows, run = harness.run_cell(cell(args.cell), args.seed,
                                          args.seconds, control=args.control,
                                          t_start=T_START)
    except harness.FellBehind as e:
        print(json.dumps(dict(head, stopped=str(e),
                              wall_s=time.perf_counter() - T_START,
                              **setup_readings(e.run)), default=float),
              flush=True)
        return 1
    print(json.dumps(dict(head, **readings(res, rows, run)), default=float),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
