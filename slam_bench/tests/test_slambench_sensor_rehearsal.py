"""Toy-size CPU rehearsals of the test-local stereo, RGB-D and
mono-inertial configurations (``sensor_cells.py``) through the harness with
the port's real System: each metric sensor's run prints a contract record
and is judged correct at fixed scale, and the same run with its metric
scale mis-stated by 1.25 is not.

As in test_slambench_rehearsal.py: half the camera's size, three pyramid
levels, a partial lap. The warm-up is longer than a cell's, since a toy
run's first 1.5 s after initialization have not yet settled, and the
mapping runs inline: a CPU falls behind the mix's rate, and how far the
worker then lags changes the toy's numbers from run to run (the card's
full-size runs keep the mix's worker, ``sensor_cells.py``).
"""
import copy
import json

import numpy as np
import pytest

from slam_bench import harness
from slam_bench.run import build_record
from slam_bench.tests import sensor_cells

TOY = dict(device="cpu", scale=0.5, lap_frames=240,
           overrides={"n_levels": 3})
SEED = 2**31 + 77


def toy_cell(name, warm_frames=40):
    cell = sensor_cells.cell(name)
    cell.workload["warm_frames"] = warm_frames
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["async_mapping"] = False
    return cell


@pytest.mark.parametrize("control", [None, "metric_scale"])
@pytest.mark.parametrize("name", ["euroc_stereo.live", "euroc_rgbd.live"])
def test_a_metric_sensor_is_judged_at_fixed_scale(name, control):
    cell = toy_cell(name)
    res, rows, run = harness.run_cell(cell, SEED, 1.5, control=control,
                                      **TOY)
    rec = build_record(res, rows, {"platform": "cpu", "kind": "rehearsal",
                                   "count": 1})
    print(json.dumps(rec))
    assert list(rec) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(rec["metrics"]) == {"frame_latency_p50_ms", "setup_s"}
    assert list(rec["compared"]) == list(cell.workload["limits"])
    assert run.notes["init_frames"] == 1        # metric: one-frame init
    scale_err = rec["compared"]["scale_err_pct"]["value"]
    if control is None:
        assert rec["correct"], rows
        assert scale_err < 5.0
    else:
        assert not rec["correct"], rows
        assert 15.0 < scale_err < 35.0


def test_a_few_mono_inertial_frames_go_through_track_mono_vi():
    """The real MonoViTracker, built from the settings' VIO block, takes
    each frame with its IMU slice (no wait for VINS init here)."""
    run = harness.Run(toy_cell("euroc_mono_vi.live"), SEED, **TOY)
    run.prepare()
    tracker = run.system.tracker
    assert type(tracker).__name__ == "MonoViTracker"
    assert tracker.vins_init_time == 15.0
    np.testing.assert_allclose(
        tracker.Tbc, harness.settings_matrix(
            run.cell.config["settings_path"], "Camera.Tbc").reshape(4, 4),
        atol=1e-7)
    fed = []
    real = run.system.track_mono_vi

    def spy(img, imu, ts):
        fed.append(len(imu))
        return real(img, imu, ts)

    run.system.track_mono_vi = spy
    out = run._feed(12)
    assert fed == [10] * 12
    assert "OK" in [r[1] for r in out]
    assert tracker.vins_scale is None
