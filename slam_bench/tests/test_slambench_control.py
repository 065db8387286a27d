"""The correctness controls on the card: the port tracking the distorted
frames as if the lens were a pinhole (the configuration's distortion
dropped) is judged not correct. Card only (``-m cuda``); the chip runs at
the cells' own size are in PERF.md."""
import json

import pytest

from slam_bench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_pinhole_control_is_not_correct(cuda, cell):
    c = harness.load_cell(cell)
    try:
        res, rows, run = harness.run_cell(c, 2**31 + 913, 10.0,
                                          control="pinhole")
    except RuntimeError as e:     # never initialized: no number, failed
        assert "not initialized" in str(e)
        return
    run.stop_worker()
    assert not res["correct"], rows
