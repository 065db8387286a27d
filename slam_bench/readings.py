"""Correctness readings of a cell over several seeds in one process: the
numbers the limits hold, for sound runs of the port or for a control.

    python3 -m slam_bench.readings --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control pinhole|tf32|metric_scale]

One JSON line per seed: seed, control, correct, the numbers, failed and
attempted frames, the end-to-end readings and the run's notes. The
benchmark's own runs never run a control. Controls: ``tf32`` switches the
port's TF32 matmuls and convolutions on (the precision below the float32
it pins); ``pinhole`` drops the configuration's lens distortion, a
guarantee the deployment states; ``metric_scale`` gives a stereo System
its baseline, an RGB-D System its depth, or a mono-inertial System every
acceleration (gravity's included), 1.25 times too large (the metric scale
such a rig guarantees). ``harness.controls`` names the controls a
configuration can fail. A run that never initializes, or is stopped
behind the camera, prints its error.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from .run import ROOT, run_env


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None,
                    choices=("pinhole", "tf32", "metric_scale"))
    args = ap.parse_args(argv)
    run_env(ROOT)
    import torch

    from .harness import load_cell, run_cell

    if not torch.cuda.is_available():
        print("slam_bench.readings: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            res, rows, run = run_cell(cell, seed, args.seconds,
                                      control=args.control)
        except RuntimeError as e:      # never initialized, or stopped
            print(json.dumps({"seed": seed, "control": args.control,
                              "correct": False, "error": str(e)}),
                  flush=True)
            continue
        out = {"seed": seed, "control": args.control,
               "correct": res["correct"],
               "numbers": {n: v for n, v, _ in rows},
               "failed": res["failed"], "attempted": res["attempted"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "notes": run.notes}
        print(json.dumps(out, default=float), flush=True)
        run.stop_worker()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
