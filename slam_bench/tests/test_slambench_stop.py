"""The stop: a benchmark run that falls more than ``harness.STOP_LATE_S``
behind the camera ends with a RuntimeError that says where, in the window
and in the traced slice; a run that keeps the rate never stops, nor does a
CPU rehearsal, which always falls behind. A stub System stands in for the
port: it answers at once, or sleeps past the stop on one call, and keeps a
StageTimer as the tracker does. Full-size frames on a 2-s lap."""
import pytest

from slam_bench import harness, trace
from slam_bench.tests.test_slambench_sensors import SEED, StubSystem, toy_cell
from ygz_tpu_torch import system as system_mod
from ygz_tpu_torch.utils.profiling import StageTimer

SLEEP_S = harness.STOP_LATE_S + 0.2


class TimedStub(StubSystem):
    """Times each call as the stage `track`; call `sleep_on` (counted from
    the System's first) sleeps SLEEP_S."""

    sleep_on = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.tracker.timer = StageTimer()

    def _answer(self, *call):
        import time

        with self.tracker.timer.stage("track"):
            if len(self.calls) + 1 == self.sleep_on:
                time.sleep(SLEEP_S)
            return super()._answer(*call)


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(system_mod, "System", TimedStub)
    TimedStub.made.clear()
    yield TimedStub
    TimedStub.sleep_on = None


def cell(warm_frames=4):
    c = toy_cell("euroc_mono.live", seconds=2.0)
    c.workload["warm_frames"] = warm_frames
    return c


def test_a_run_that_falls_behind_stops_with_where_and_the_stages(stub):
    # set-up feeds 1 + 4 frames; the window's fourth frame sleeps, so its
    # fifth is fed more than the stop late
    stub.sleep_on = 5 + 4
    with pytest.raises(RuntimeError) as e:
        harness.run_cell(cell(), SEED, 3.0, device="cpu")
    msg = str(e.value)
    assert e.value.run.notes["init_frames"] == 1
    assert msg.startswith("behind the camera: frame 9 fed ")
    late = float(msg.split(" fed ")[1].split(" s ")[0])
    assert harness.STOP_LATE_S < late < SLEEP_S
    assert "after 4 frames of this paced stretch and 9 since set-up" in msg
    # the stages since the System was built, set-up's frames included
    name, mean_ms, unit, x, count = msg.split("(mean, count): ")[1].split()
    assert (name, unit, x, count) == ("track", "ms", "x", "9")
    assert 1e3 * SLEEP_S / 9 <= float(mean_ms) < 1e3 * (SLEEP_S + 0.5) / 9


def test_the_traced_slice_stops_too(stub, monkeypatch):
    monkeypatch.setattr(trace, "traced", lambda fn: fn())
    run = harness.Run(cell(), SEED, device="cpu")
    run.setup()
    stub.sleep_on = 5 + 2
    run.cell.workload["trace_frames"] = 10
    with pytest.raises(RuntimeError, match="after 2 frames of this paced"):
        run.traced_slice()


def test_a_run_that_keeps_the_rate_does_not_stop(stub):
    run = harness.Run(cell(), SEED, device="cpu")
    assert not run.rehearsal
    run.setup()
    run.window(1.0)
    assert len(run.records) == 20
    assert run.notes["feeder_late_ms_max"] < 1e3 * harness.STOP_LATE_S


@pytest.mark.parametrize("rehearsal", [{"scale": 0.5},
                                       {"lap_frames": 40}])
def test_a_rehearsal_never_stops(stub, rehearsal):
    run = harness.Run(cell(), SEED, device="cpu", **rehearsal)
    assert run.rehearsal
    run.setup()
    stub.sleep_on = 5 + 2
    run.window(0.5)
    assert len(run.records) == 10
    assert run.notes["feeder_late_ms_max"] > 1e3 * harness.STOP_LATE_S
