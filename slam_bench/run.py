"""The benchmark of the PyTorch / CUDA port (``ygz_tpu_torch``) on NVIDIA
cards: one run of one cell, one JSON line.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The run loads, warms up, measures for
``--seconds`` and prints, as the last line of standard output, the record
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics; with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each correctness
number beside its limit, which also close standard error. It exits non-zero
and prints no record without enough CUDA cards, when JAX or the JAX package
was loaded, when the run falls more than ``harness.STOP_LATE_S`` behind the
camera (it then prints its set-up notes and the stop, last, to standard
error), or when anything it needs is missing.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# whole top-level module names the port must never load in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "ygz_tpu")
ROOT = Path(__file__).resolve().parents[1]


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def run_env(root: Path):
    """The run's environment, set before torch or numpy is imported: every
    compiler cache the run could touch at fixed paths inside the checkout
    (the port's own nvcc output is build/ygz_tpu_torch/), and one OpenMP
    thread for torch and numpy on the host (PERF.md gives the readings
    that chose it)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    base = root / "build" / "slam_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)


def card_label():
    """nvidia-smi's name and power limit of the cards."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def build_record(result, rows, device):
    """The printed record of run_cell's result: correct, attempted, failed,
    metrics, device (with the memory peak, and busy_s and window_s of a
    traced run), breakdown when traced, and compared last."""
    result = dict(result)
    device = dict(device, memory_peak_bytes=result.pop("memory_peak_bytes"))
    tr = result.pop("trace", None)
    out = dict(result, device=device)
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    # a number that could not be computed (no frame OK) prints as null
    out["compared"] = {name: {"value": v if math.isfinite(v) else None,
                              "limit": lim} for name, v, lim in rows}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    run_env(ROOT)
    from .harness import FellBehind, load_cell, run_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); {n} visible", file=sys.stderr)
        return 2
    try:
        result, rows, run = run_cell(cell, args.seed, args.seconds,
                                     trace=bool(args.trace), device="cuda",
                                     t_start=T_START)
    except FellBehind as e:
        print("notes: " + json.dumps(e.run.notes, default=float),
              file=sys.stderr)
        print(f"slam_bench: {e}", file=sys.stderr, flush=True)
        # at once: the mapping worker may be inside a job on the card, and
        # the interpreter's shutdown would abort under it
        os._exit(4)
    bad = forbidden_modules()
    if bad:
        print(f"slam_bench: loaded in this process: {bad}", file=sys.stderr)
        return 3

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips}
    out = build_record(result, rows, device)
    print(f"card: {card_label()}", file=sys.stderr)
    print("notes: " + json.dumps(run.notes, default=float), file=sys.stderr)
    for name, v, lim in rows:
        print(f"{name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
