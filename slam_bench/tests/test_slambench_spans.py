"""The readers of the port's spans against hand counts: StageTimer totals of
a window, and recorder spans lined up with a traced slice's device
records."""
from types import SimpleNamespace

import pytest

from slam_bench.harness import metric_reader
from slam_bench.trace import Trace
from ygz_tpu_torch.utils import profiling
from ygz_tpu_torch.utils.profiling import Span

MS = 1_000_000          # ns
TRACK, WORKER = 101, 202

# two frames of a 40-ms slice starting at 1,000 ms: frame 7 tracked over
# 1,000-1,010 ms, frame 8 over 1,020-1,030 ms; one keyframe job of frame 7
# on the worker over 1,005-1,035 ms
SPANS = [
    Span("track", 1000 * MS, 1010 * MS, TRACK, 7),
    Span("frame_step", 1001 * MS, 1008 * MS, TRACK, 7),
    Span("frame_step.dispatch", 1001 * MS, 1002 * MS, TRACK, 7),
    Span("frame_step.readback", 1002 * MS, 1008 * MS, TRACK, 7),
    Span("mapping.job", 1005 * MS, 1035 * MS, WORKER, 7),
    Span("track", 1020 * MS, 1030 * MS, TRACK, 8),
    Span("frame_step", 1021 * MS, 1029 * MS, TRACK, 8),
    Span("frame_step.dispatch", 1021 * MS, 1022 * MS, TRACK, 8),
    Span("frame_step.readback", 1022 * MS, 1029 * MS, TRACK, 8),
]
# (name, start, duration, launching host call): frame 7's replay ends at
# 1,006 ms, frame 8's at 1,025 ms; the worker's BA kernel runs 1,026-1,028
KERNELS = [
    ("sparse_align_kernel", 1002 * MS, 2 * MS, "cudaGraphLaunch"),
    ("pose_gn_kernel", 1004 * MS, 2 * MS, "cudaGraphLaunch"),
    ("Memcpy DtoH", 1006 * MS, MS // 2, "cudaMemcpyAsync"),
    ("pose_gn_kernel", 1022 * MS, 3 * MS, "cudaGraphLaunch"),
    ("indexing_backward_kernel", 1026 * MS, 2 * MS, "cudaLaunchKernel"),
]


@pytest.fixture
def recorded(monkeypatch):
    """The recorder's spans replaced by SPANS, filtered as spans() does."""
    def fake(lo_ns=0, hi_ns=None):
        hi = float("inf") if hi_ns is None else hi_ns
        return [s for s in SPANS if s.end_ns > lo_ns and s.start_ns < hi]
    monkeypatch.setattr(profiling, "spans", fake)


def trace(kernels=KERNELS):
    return Trace(window_s=0.04, frames=2, kernels=list(kernels),
                 span=(1000 * MS, 1040 * MS))


STAGES = {"track": (0.020, 2), "frame_step": (0.015, 2),
          "frame_step.readback": (0.013, 2), "track.lock_wait": (0.003, 2),
          "mapping.queue_wait": (0.120, 3), "mapping.extract": (0.090, 3)}


def window(stages=STAGES, frames=4, tr=None):
    return SimpleNamespace(stages=dict(stages), frames=frames, trace=tr,
                           window_s=0.2)


def read(name, ctx):
    return metric_reader(name)(ctx)


def test_the_window_readers_by_hand():
    ctx = window()
    assert read("tracker.self_ms.live", ctx) == pytest.approx(2.5)
    assert read("tracker.lock_wait_ms.live", ctx) == pytest.approx(0.75)
    assert read("frame_step.readback_ms.live", ctx) == pytest.approx(6.5)
    assert read("mapping_worker.queue_wait_ms.live", ctx) == \
        pytest.approx(40.0)
    assert read("mapping_worker.extract_ms.live", ctx) == pytest.approx(30.0)


@pytest.mark.parametrize("name, span", [
    ("tracker.self_ms.live", "track"),
    ("tracker.lock_wait_ms.live", "track"),
    ("frame_step.readback_ms.live", "frame_step.readback"),
    ("mapping_worker.queue_wait_ms.live", "mapping.queue_wait"),
    ("mapping_worker.extract_ms.live", "mapping.extract"),
])
def test_a_window_reader_without_its_span_reads_none(name, span):
    stages = {k: v for k, v in STAGES.items() if k != span}
    assert read(name, window(stages)) is None


def test_a_window_without_lock_waits_reads_zero():
    stages = {k: v for k, v in STAGES.items() if k != "track.lock_wait"}
    assert read("tracker.lock_wait_ms.live", window(stages)) == 0.0


def test_the_return_lag_by_hand(recorded):
    # frame 7: the readback ends at 1,008, its replay's last record at
    # 1,006 (the copy is no replay record): 2 ms; frame 8: 1,029 - 1,025
    assert read("frame_step.return_lag_ms.live",
                window(tr=trace())) == pytest.approx(3.0)


def test_a_frame_whose_replay_left_no_record_is_skipped(recorded):
    kernels = [k for k in KERNELS if not k[1] < 1010 * MS or
               k[3] != "cudaGraphLaunch"]
    assert read("frame_step.return_lag_ms.live",
                window(tr=trace(kernels))) == pytest.approx(4.0)
    no_replay = [k for k in KERNELS if k[3] != "cudaGraphLaunch"]
    assert read("frame_step.return_lag_ms.live",
                window(tr=trace(no_replay))) is None


def test_the_idle_share_in_frame_by_hand(recorded):
    # 20 ms of frames; busy in them: 1,002-1,006.5 (4.5 ms), 1,022-1,025
    # and 1,026-1,028 (5 ms): idle 10.5 of 20
    assert read("device.idle_in_frame_pct.live",
                window(tr=trace())) == pytest.approx(52.5)


def test_the_span_readers_without_a_trace_or_spans_read_none(monkeypatch):
    for name in ("frame_step.return_lag_ms.live",
                 "device.idle_in_frame_pct.live"):
        assert read(name, window()) is None
    monkeypatch.setattr(profiling, "spans", lambda lo=0, hi=None: [])
    for name in ("frame_step.return_lag_ms.live",
                 "device.idle_in_frame_pct.live"):
        assert read(name, window(tr=trace())) is None


def test_the_span_readers_of_a_program_without_the_recorder(monkeypatch):
    """A program whose profiling module has no spans(): None, no raise."""
    monkeypatch.delattr(profiling, "spans")
    for name in ("frame_step.return_lag_ms.live",
                 "device.idle_in_frame_pct.live"):
        assert read(name, window(tr=trace())) is None
