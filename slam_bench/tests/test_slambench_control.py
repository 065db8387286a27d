"""The correctness controls on the card: each control that mis-states
something the configuration has (``harness.controls``: the lens
distortion dropped where the settings give one, the metric scale
mis-stated by 1.25 for a stereo, depth or inertial rig) is judged not
correct. Card only (``-m cuda``); the chip runs at the cells' own size are
in PERF.md."""
import pytest

from slam_bench import harness

CASES = [(w["name"], control)
         for w in harness.benchmark_spec()["workloads"]
         for control in harness.controls(harness.load_cell(w["name"]).config)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", CASES)
def test_each_control_is_not_correct(cuda, cell, control):
    c = harness.load_cell(cell)
    try:
        res, rows, run = harness.run_cell(c, 2**31 + 913, 10.0,
                                          control=control)
    except RuntimeError as e:     # never initialized: no number, failed
        assert "not initialized" in str(e)
        return
    run.stop_worker()
    assert not res["correct"], rows
