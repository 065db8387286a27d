"""A toy-size CPU run of the test-local mono-inertial cell
(``sensor_cells.py``'s ``euroc_mono_vi.live``) through ``harness.run_cell``
with the port's real System: the rehearsal's partial lap
(``toy_lap_frames``) is long enough for set-up to reach VINS
initialization at the settings' own 15 s, the run prints a contract
record, and the same run with every acceleration 1.25 times too large
(``metric_scale``) reads a scale error at least 10 points above it and is
judged not correct.

As in test_slambench_sensor_rehearsal.py: half the camera's size, three
pyramid levels, the mapping inline. Whether the sound toy run is correct
is not asserted: at this size it is not (PERF.md). The two runs go in two
processes side by side, a few minutes each.
"""
import copy
import json
import math
import os
import subprocess
import sys

from slam_bench import harness
from slam_bench.tests import sensor_cells

NAME = "euroc_mono_vi.live"
SEED = 2**31 + 77
SECONDS = 3.0

REHEARSE = """
import json, sys
from slam_bench import harness
from slam_bench.run import build_record, forbidden_modules
from slam_bench.tests.test_slambench_rehearsal import toy
from slam_bench.tests.test_slambench_vi_toy import SECONDS, toy_cell
cell = toy_cell()
res, rows, run = harness.run_cell(cell, int(sys.argv[1]), SECONDS,
                                  control=sys.argv[2] or None, **toy(cell))
rec = build_record(res, rows, {"platform": "cpu", "kind": "rehearsal",
                               "count": 1})
tracker = run.system.tracker
print(json.dumps({"forbidden": forbidden_modules(), "record": rec,
                  "vins_init_time": tracker.vins_init_time,
                  "vins_scale": tracker.vins_scale,
                  "fed_to_vins_init": run.notes["init_frames"]
                  + run.notes["vi_init_frames"]}))
"""


def toy_cell(warm_frames=8):
    cell = sensor_cells.cell(NAME)
    cell.workload["warm_frames"] = warm_frames
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["async_mapping"] = False
    return cell


def test_a_mono_inertial_toy_reaches_vins_init_and_fails_its_control():
    # half the cores each
    env = dict(os.environ, OMP_NUM_THREADS=str(max(os.cpu_count() // 2, 1)))
    procs = {control: subprocess.Popen(
        [sys.executable, "-c", REHEARSE, str(SEED), control or ""],
        cwd=harness.ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for control in (None, "metric_scale")}
    out = {}
    try:
        for control, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=1200)
            assert proc.returncode == 0, stderr[-3000:]
            out[control] = json.loads(stdout.strip().splitlines()[-1])
            print(control, json.dumps(out[control]))
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    cell = toy_cell()
    nums = harness.settings_numbers(cell.config["settings_path"])
    for got in out.values():
        assert got["forbidden"] == []
        rec = got["record"]
        assert list(rec) == ["correct", "attempted", "failed", "metrics",
                             "device", "compared"]
        assert set(rec["metrics"]) == {"frame_latency_p50_ms", "setup_s"}
        assert list(rec["compared"]) == list(cell.workload["limits"])
        assert rec["attempted"] == SECONDS * nums["Camera.fps"]
        # VINS init waited for the settings' 15 s of keyframes
        assert got["vins_init_time"] == nums["test.VINSInitTime"] == 15.0
        assert got["vins_scale"] is not None
        assert got["fed_to_vins_init"] > math.ceil(
            nums["test.VINSInitTime"] * nums["Camera.fps"])
    control = out["metric_scale"]["record"]
    assert not control["correct"]
    assert (control["compared"]["scale_err_pct"]["value"]
            >= out[None]["record"]["compared"]["scale_err_pct"]["value"]
            + 10.0)
