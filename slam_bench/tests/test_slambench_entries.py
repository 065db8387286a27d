"""The sensor -> entry table (``harness.ENTRIES``): each sensor is fed
through its own entry of the System, the fault tests plant every fault at
that entry, and the mono-inertial control mis-states the accelerometer
alone. A stub System answers each call with a pose that counts the calls,
at a tiny size."""
import numpy as np
import pytest

from slam_bench import harness
from slam_bench.tests.test_slambench_rehearsal import FAULTS, patched
from slam_bench.tests.test_slambench_sensors import (SCALE, SEED, StubSystem,
                                                     toy_cell)
from ygz_tpu_torch import system as system_mod

CELL_OF = {"MONOCULAR": "euroc_mono.live", "STEREO": "euroc_stereo.live",
           "RGBD": "euroc_rgbd.live", "MONO_VI": "euroc_mono_vi.live"}
FRAMES = 20


class CountingStub(StubSystem):
    """Answers call n with the pose translated by n along x, so a fault
    that alters or repeats an answer shows."""

    def _answer(self, *call):
        state, T = super()._answer(*call)
        T[0, 3] = len(self.calls)
        return state, T


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(system_mod, "System", CountingStub)
    CountingStub.made.clear()
    return CountingStub


def prepared(sensor, control=None, lap_frames=FRAMES):
    run = harness.Run(toy_cell(CELL_OF[sensor]), SEED, device="cpu",
                      scale=SCALE, lap_frames=lap_frames, control=control)
    run.prepare()
    return run, CountingStub.made[-1]


def test_the_table_names_an_entry_of_the_system_for_every_sensor():
    assert harness.ENTRIES == {"MONOCULAR": "track_monocular",
                               "STEREO": "track_stereo",
                               "RGBD": "track_rgbd",
                               "MONO_VI": "track_mono_vi"}
    assert harness.SENSORS == tuple(harness.ENTRIES)
    assert [m.name for m in system_mod.Sensor] == list(harness.SENSORS)
    for entry in harness.ENTRIES.values():
        assert callable(getattr(system_mod.System, entry))


def same_inputs(got, want):
    """The frame's other inputs handed on untouched: an image, or an IMU
    slice of (t, gyro, acc)."""
    if isinstance(want, list):
        assert len(got) == len(want)
        for (t, g, a), (t2, g2, a2) in zip(got, want):
            assert t == t2
            np.testing.assert_array_equal(g, g2)
            np.testing.assert_array_equal(a, a2)
    else:
        assert np.shares_memory(got, want)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("sensor", harness.SENSORS)
def test_each_fault_is_planted_at_the_sensors_entry(stub, sensor, fault):
    run, sys_ = prepared(sensor)
    entry = harness.ENTRIES[run.sensor]
    with patched(run.system, entry, FAULTS[fault]):
        out = run._feed(FRAMES)
    ids = [r[0] for r in out]
    # every call went to the sensor's own entry, with the frame's other
    # inputs as the harness hands them on
    assert {c[0] for c in sys_.calls} == {entry}
    called = iter(sys_.calls)
    shift = [T[0, 3] for _, _, T in out]
    for j, state, T in out:
        if fault == "frames_left_out" and state == "LOST":
            np.testing.assert_array_equal(T, np.eye(4))
            continue
        call = next(called)
        assert call[-1] == j / run.stream.fps
        for got, want in zip(call[2:-1], run._inputs(j)):
            same_inputs(got, want)
    assert next(called, None) is None
    if fault == "state_unchanged":
        assert shift == [1.0] * FRAMES and len(sys_.calls) == FRAMES
    elif fault == "answer_altered":
        assert shift == [0.0 if (k + 1) % 10 == 0 else k + 1.0
                         for k in range(FRAMES)]
    else:
        lost = [j for j, state, _ in out if state == "LOST"]
        assert lost == [j for k, j in enumerate(ids) if ((k + 1) // 5) % 2]
        assert len(sys_.calls) == FRAMES - len(lost)


def test_the_mono_inertial_control_scales_the_accelerometer_alone(stub):
    """metric_scale on a mono-inertial cell: every acceleration fed is the
    sound run's times 1.25, bit for bit, gravity included; the gyro, the
    sample times and the frames are the sound run's, bit for bit."""
    sound, s_sys = prepared("MONO_VI")
    run, c_sys = prepared("MONO_VI", control="metric_scale")
    sound._feed(FRAMES)
    run._feed(FRAMES)
    assert len(s_sys.calls) == len(c_sys.calls) == FRAMES
    n = 0
    for s_call, c_call in zip(s_sys.calls, c_sys.calls):
        np.testing.assert_array_equal(c_call[1], s_call[1])
        assert c_call[-1] == s_call[-1]
        assert len(c_call[2]) == len(s_call[2])
        for (t, g, a), (t2, g2, a2) in zip(c_call[2], s_call[2]):
            assert t == t2
            assert np.array_equal(g, g2)
            assert np.array_equal(a, a2 * harness.CONTROL_SCALE)
            assert np.linalg.norm(a) > 1.2 * 9.0      # gravity's scaled too
            n += 1
    assert n == 10 * FRAMES


@pytest.mark.parametrize("sensor", harness.SENSORS)
def test_the_controls_follow_the_sensor_and_the_settings(sensor):
    """pinhole where the settings give a distortion; metric_scale for a
    sensor that gives the metric scale. A rectified pair has no lens to
    drop; a monocular rig no scale to mis-state."""
    config = toy_cell(CELL_OF[sensor]).config
    want = {"MONOCULAR": ["pinhole"], "STEREO": ["metric_scale"],
            "RGBD": ["metric_scale"],
            "MONO_VI": ["pinhole", "metric_scale"]}[sensor]
    assert harness.controls(config) == want
    if "metric_scale" not in want:
        with pytest.raises(ValueError, match="metric_scale"):
            harness.Run(toy_cell(CELL_OF[sensor]), SEED,
                        control="metric_scale")
