"""Toy-size CPU runs of the cells: a contract-shaped record, no JAX in the
process, and the timed path broken underneath turning `correct` false.

The port runs its plain PyTorch versions on the CPU, at half the camera's
size with three pyramid levels (a 31-px ORB patch does not fit the fourth
level of a 376x240 frame) and a partial lap: these runs check the harness,
not the port's accuracy, which only the card's runs at full size measure.
The faults are planted at the entry the cell's sensor is fed through
(``harness.ENTRIES``), whatever the cell is called.
"""
import json
import math
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest

from slam_bench import harness, reference

TOY = dict(device="cpu", scale=0.5, lap_frames=240,
           overrides={"n_levels": 3})
SEED = 2**31 + 77
CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


def toy_cell(name):
    cell = harness.load_cell(name)
    cell.workload["warm_frames"] = min(cell.workload["warm_frames"], 8)
    return cell


def toy_lap_frames(cell):
    """The rehearsal's partial lap: 240 frames hold initialization, the
    toy's warm frames and its windows. A mono-inertial cell's adds the
    frames set-up may feed while it waits for VINS initialization
    (``max_vi_init_frames``, which has to reach the settings' own
    ``test.VINSInitTime`` at ``Camera.fps``) and the warm frames that
    follow it; the whole lap caps it."""
    n = TOY["lap_frames"]
    if harness.sensor_of(cell.config) != "MONO_VI":
        return n
    nums = harness.settings_numbers(cell.config["settings_path"])
    wl = cell.workload
    need = math.ceil(nums["test.VINSInitTime"] * nums["Camera.fps"])
    if wl["max_vi_init_frames"] < need:
        raise ValueError(f"max_vi_init_frames {wl['max_vi_init_frames']} "
                         f"never reaches test.VINSInitTime: {need} frames")
    n_lap = round(cell.traffic["lap"]["seconds"] * nums["Camera.fps"])
    return min(n + wl["max_vi_init_frames"] + wl["warm_frames"], n_lap)


def toy(cell):
    """The rehearsal's arguments of run_cell for `cell`."""
    return dict(TOY, lap_frames=toy_lap_frames(cell))


REHEARSE = """
import json, sys
from slam_bench import harness
from slam_bench.run import build_record, forbidden_modules
from slam_bench.tests.test_slambench_rehearsal import toy, toy_cell
cell = toy_cell(sys.argv[1])
res, rows, run = harness.run_cell(cell, int(sys.argv[2]), 1.5, **toy(cell))
rec = build_record(res, rows, {"platform": "cpu", "kind": "rehearsal",
                               "count": 1})
print(json.dumps({"forbidden": forbidden_modules(), "record": rec}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_toy_run_prints_a_contract_record(cell):
    """One whole run in a fresh interpreter: the record's keys in order,
    the cell's end-to-end metrics, every compared number with its limit,
    and no jax, jaxlib, flax or ygz_tpu module loaded."""
    proc = subprocess.run([sys.executable, "-c", REHEARSE, cell, str(SEED)],
                          cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    rec = out["record"]
    assert list(rec) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    c = harness.load_cell(cell)
    assert set(rec["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in rec["metrics"].values())
    assert rec["attempted"] > 0 and 0 <= rec["failed"] <= rec["attempted"]
    assert list(rec["compared"]) == list(c.workload["limits"])
    assert set(rec["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


# ------------------------------------------------------------------ faults
@contextmanager
def patched(system, name, wrapper):
    real = getattr(system, name)
    setattr(system, name, wrapper(real))
    try:
        yield
    finally:
        setattr(system, name, real)


def state_unchanged(real):
    """The entry returns its first answer again for every frame."""
    first = []

    def entry(*args):
        out = real(*args)
        if not first:
            first.append(out)
        return first[0]
    return entry


def answer_altered(real):
    """Every tenth answer is replaced by the identity pose (the answer a
    frame gets before initialization), still marked OK."""
    n = [0]

    def entry(*args):
        out = real(*args)
        n[0] += 1
        return (out[0], np.eye(4, dtype=np.float32)) if n[0] % 10 == 0 \
            else out
    return entry


def frames_left_out(real, block=5):
    """Every other block of frames is returned LOST without being tracked:
    about half of the window's frames left out."""
    n = [0]

    def entry(*args):
        n[0] += 1
        if (n[0] // block) % 2:
            return "LOST", np.eye(4, dtype=np.float32)
        return real(*args)
    return entry


FAULTS = {"state_unchanged": state_unchanged,
          "answer_altered": answer_altered,
          "frames_left_out": frames_left_out}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    """A sound window is judged correct, and the fault's window next on the
    same System, the fault planted at the sensor's entry, not correct. (The
    toy's first window after initialization is left out: at this size its
    poses have not yet settled.)"""
    c = toy_cell(cell)
    run = harness.Run(c, SEED, **toy(c))
    run.setup()
    limits = c.workload["limits"]
    try:
        run.window(1.5)
        run.records = []
        run.window(1.5)
        correct, rows = reference.judge(run.numbers(), limits)
        assert correct, rows
        # a fault that skips the work feeds frames faster than the toy's
        # partial lap holds: let it wrap
        run.stream.periodic = True
        run.records = []
        with patched(run.system, harness.ENTRIES[run.sensor],
                     FAULTS[fault]):
            run.window(1.5)
        correct, rows = reference.judge(run.numbers(), limits)
        assert not correct, rows
    finally:
        run.close()
