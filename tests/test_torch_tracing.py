"""The port's span recorder (ygz_tpu_torch.utils.profiling) on the CPU:
spans only inside a torch.profiler session, nested by thread, caused by a
frame, on the clock of kineto's host events, in a bounded buffer; and the
tracker's stages on a short asynchronous run of track_monocular."""
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ygz_tpu_torch.frontend.tracker import TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils import profiling
from ygz_tpu_torch.utils import synthetic as syn
from ygz_tpu_torch.utils.profiling import StageTimer

import torch_parity  # noqa: F401  (caps torch threads)


def session():
    return profile(activities=[ProfilerActivity.CPU])


def named(name, lo=0):
    return [s for s in profiling.spans(lo) if s.name == name]


def test_no_session_records_no_span_and_the_totals_count():
    timer = StageTimer()
    lo = time.time_ns()
    for _ in range(3):
        with timer.stage("no_session.stage"):
            pass
    timer.add("no_session.add", 0.25)
    timer.add("no_session.add", 0.5, count=2)
    assert timer.count["no_session.stage"] == 3
    assert timer.total["no_session.add"] == 0.75
    assert timer.count["no_session.add"] == 3
    assert named("no_session.stage", lo) == named("no_session.add", lo) == []


def test_spans_nest_by_thread_and_carry_the_frame():
    timer = StageTimer()

    def worker():
        profiling.set_frame(9)
        with timer.stage("nest.job"):
            with timer.stage("nest.inner"):
                time.sleep(0.002)

    lo = time.time_ns()
    with session():
        profiling.set_frame(7)
        with timer.stage("nest.outer"):
            t = threading.Thread(target=worker)
            t.start()
            with timer.stage("nest.inner"):
                time.sleep(0.002)
            t.join(timeout=30)
        timer.add("nest.wait", 0.001, start_ns=lo)
    assert not t.is_alive()
    outer, = named("nest.outer", lo)
    job, = named("nest.job", lo)
    inner = {s.thread: s for s in named("nest.inner", lo)}
    assert outer.thread == threading.get_native_id() and outer.frame == 7
    assert job.thread != outer.thread and job.frame == 9
    assert set(inner) == {outer.thread, job.thread}
    # a span's parent is the enclosing span on its own thread
    mine, theirs = inner[outer.thread], inner[job.thread]
    assert outer.start_ns <= mine.start_ns <= mine.end_ns <= outer.end_ns
    assert job.start_ns <= theirs.start_ns <= theirs.end_ns <= job.end_ns
    assert mine.frame == 7 and theirs.frame == 9
    wait, = named("nest.wait", lo)
    assert (wait.start_ns, wait.end_ns) == (lo, lo + 1_000_000)
    assert timer.count["nest.inner"] == 2


def test_the_buffer_stays_bounded():
    timer = StageTimer()
    with session():
        for _ in range(profiling.SPAN_CAPACITY + 100):
            with timer.stage("bounded"):
                pass
    assert len(profiling._SPANS) == profiling.SPAN_CAPACITY
    assert timer.count["bounded"] == profiling.SPAN_CAPACITY + 100


def test_a_span_encloses_the_host_event_of_its_op():
    timer = StageTimer()
    x = torch.ones(4096)
    lo = time.time_ns()
    with session() as prof:
        with timer.stage("clock.op"):
            torch.mul(x, 3.0)
    span, = named("clock.op", lo)
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul"]
    assert span.start_ns <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= span.end_ns


N_PLAIN, N_TRACED = 8, 8


@pytest.fixture(scope="module")
def async_run():
    """16 frames of track_monocular with the async worker: the first 8
    outside any profiler session, the last 8 inside one."""
    scene = syn.SmoothScene(seed=11, w=344, h=258, f=215.0)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    imgs = [scene.render(*syn.pose_fn(i / 20))
            for i in range(N_PLAIN + N_TRACED)]
    system = System(cam, Sensor.MONOCULAR, device="cpu",
                    config=TrackerConfig(async_mapping=True))
    lo = time.time_ns()
    states = [system.track_monocular(im, i / 20)[0]
              for i, im in enumerate(imgs[:N_PLAIN])]
    mid = time.time_ns()
    with session():
        states += [system.track_monocular(im, (N_PLAIN + i) / 20)[0]
                   for i, im in enumerate(imgs[N_PLAIN:])]
        system.shutdown()
    spans = profiling.spans(lo, time.time_ns())
    return system, states, spans, mid


def test_the_stages_keep_their_counts(async_run):
    system, states, _, _ = async_run
    c = system.tracker.timer.count
    smap = system.map
    n = N_PLAIN + N_TRACED
    assert c["track"] == n and states.count("LOST") == 0
    # a frame either bootstraps (a pyramid) or runs the frame step
    assert c["pyramid"] + c["frame_step"] == n and c["frame_step"] > 0
    assert c["frame_step.dispatch"] == c["frame_step.readback"] \
        == c["frame_step"]
    # every keyframe after the two-view pair: one hand-off, one job
    kfs = smap.n_kf - 2
    assert kfs > 0 and c["keyframe"] == kfs
    for name in ("mapping.queue_wait", "mapping.job", "mapping.extract",
                 "mapping_tail", "mt_triangulate", "mt_fuse", "mt_local_ba",
                 "mt_cull", "mt_patches", "mt_loop"):
        assert c[name] == kfs, name
    assert c["mapping.lock_wait"] == 2 * kfs
    assert c["track.lock_wait"] >= kfs


def test_spans_only_inside_the_session(async_run):
    system, _, spans, mid = async_run
    assert spans and min(s.start_ns for s in spans) >= mid
    tracked = sorted(s.frame for s in spans if s.name == "track")
    assert tracked == list(range(N_PLAIN, N_PLAIN + N_TRACED))


def test_the_frame_steps_spans_nest_in_their_frame(async_run):
    _, _, spans, _ = async_run
    track = {s.frame: s for s in spans if s.name == "track"}
    for s in spans:
        if s.name.startswith("frame_step"):
            t = track[s.frame]
            assert s.thread == t.thread
            assert t.start_ns <= s.start_ns <= s.end_ns <= t.end_ns


def test_the_workers_spans_carry_the_keyframes_frame(async_run):
    system, _, spans, _ = async_run
    smap = system.map
    worker = {s.thread for s in spans if s.name == "mapping.job"}
    assert len(worker) == 1 and worker != {
        s.thread for s in spans if s.name == "track"}
    kf_frames = [int(f) for f in smap.kf_frame_id[2: smap.n_kf]]
    jobs = Counter(s.frame for s in spans if s.name == "mapping.job")
    waits = Counter(s.frame for s in spans if s.name == "mapping.queue_wait")
    assert set(jobs) <= set(kf_frames)
    # each keyframe handed off inside the session: one wait, one job, both
    # caused by its frame; the wait starts in that frame's track span
    made = Counter(f for f in kf_frames if f >= N_PLAIN)
    assert made
    assert {f: n for f, n in jobs.items() if f >= N_PLAIN} == made
    assert {f: n for f, n in waits.items() if f >= N_PLAIN} == made
    track = {s.frame: s for s in spans if s.name == "track"}
    for w in spans:
        if w.name == "mapping.queue_wait" and w.frame >= N_PLAIN:
            t = track[w.frame]
            job, = [j for j in spans
                    if j.name == "mapping.job" and j.frame == w.frame]
            assert t.start_ns <= w.start_ns <= t.end_ns
            assert w.end_ns <= job.start_ns + 1_000_000
