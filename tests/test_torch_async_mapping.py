"""The async mapping worker of the torch port on the CPU: the twin of
tests/test_async_mapping.py (async tracking quality against the
synchronous path; async mono-VI keeps VINS init and the metric span), the
reset race (a tail job queued against a map that reset() swapped drops
itself), a worker exception surfacing at wait_mapping_idle, and the full
keyframe decision (mapper idle or busy, the stereo / RGB-D close-point
term) against the JAX package's on inputs made from a seed."""
import numpy as np
import pytest

from ygz_tpu.frontend.tracker import MonoTracker as JMono
from ygz_tpu.frontend.tracker import RgbdTracker as JRgbd
from ygz_tpu.frontend.tracker import TrackerConfig as JConfig
from ygz_tpu.geometry import camera as jcam
from ygz_tpu_torch.backend.mapstate import SlamMap
from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.frontend.tracker import (MonoTracker, RgbdTracker, State,
                                            TrackerConfig)
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils import synthetic as syn

import torch_parity  # noqa: F401  (caps torch threads)
from test_vo_e2e import make_trajectory

N_SYNC = 40


def _ate(system, poses):
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            est.append(-rec.R.T @ rec.t)
            gt.append(-R.T @ t)
    assert len(est) > 30, f"too few tracked frames: {len(est)}"
    return ate_rmse(np.array(est), np.array(gt), with_scale=True)[0]


def test_async_mapping_matches_sync():
    """tests/test_async_mapping.py's bounds over its 40 frames: the async
    tracker returns pre-BA keyframe poses, so a modest gap is allowed."""
    scene = syn.SmoothScene(seed=11)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(N_SYNC)
    imgs = [scene.render(R, t) for R, t in poses]
    rmse = {}
    for mode in ("sync", "async"):
        system = System(cam, Sensor.MONOCULAR, device="cpu",
                        config=TrackerConfig(async_mapping=mode == "async"))
        for i, img in enumerate(imgs):
            system.track_monocular(img, i * 0.05)
        system.shutdown()
        if mode == "async":
            smap = system.map
            assert system.tracker._tail_idle() and smap.n_kf >= 3
            assert not smap.kf_feat_pending[: smap.n_kf].any()
        rmse[mode] = _ate(system, poses)
    assert rmse["sync"] < 0.05, rmse
    assert rmse["async"] < 3.0 * rmse["sync"] + 0.02, rmse


def test_async_mapping_mono_vi():
    """Mono-VI with the worker (the JAX test's settings, at the port's VI
    test size 344x258): VINS init fires against a drained queue, > 80% of
    the frames OK, the post-init span metric within 12%."""
    scene = syn.SmoothScene(seed=11, w=344, h=258, f=215.0)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    system = System(cam, Sensor.MONO_VI, device="cpu",
                    config=TrackerConfig(kf_max_gap=8, async_mapping=True),
                    vins_init_kfs=6, vins_init_time=1.2)
    fps, n = 20.0, 70
    states, ready_at = [], None
    for i in range(n):
        t = i / fps
        R, tt = syn.pose_fn(t)
        imu = syn.synth_imu((i - 1) / fps, t) if i > 0 else []
        states.append(system.track_mono_vi(scene.render(R, tt), imu, t)[0])
        if ready_at is None and system.tracker.vio_ready:
            ready_at = i
    system.shutdown()
    assert ready_at is not None, "VINS init failed under async mapping"
    assert sum(s == "OK" for s in states) > 0.8 * n, states
    recs = system.trajectory
    post = [i for i, r in enumerate(recs)
            if i > ready_at + 2 and r.state == "OK"]
    i0, i1 = post[0], post[-1]

    def centre(R, t):
        return -R.T @ t

    span = np.linalg.norm(centre(recs[i1].R, recs[i1].t)
                          - centre(recs[i0].R, recs[i0].t))
    truth = np.linalg.norm(centre(*syn.pose_fn(i1 / fps))
                           - centre(*syn.pose_fn(i0 / fps)))
    assert abs(span / truth - 1.0) < 0.12, (span, truth)


def _initialized(async_mapping):
    """A tracker initialized on a small scene (its two-keyframe map
    built)."""
    scene = syn.SmoothScene(seed=11, w=344, h=258, f=215.0)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    tr = MonoTracker(cam, TrackerConfig(async_mapping=async_mapping),
                     device="cpu")
    for i, (R, t) in enumerate(make_trajectory(12)):
        tr.track(scene.render(R, t), i * 0.05)
        if tr.state == State.OK:
            break
    assert tr.state == State.OK and tr.map.n_kf == 2
    tr.wait_mapping_idle()
    return tr


@pytest.fixture
def small_async():
    """An async tracker initialized on a small scene."""
    return _initialized(True)


def test_reset_race_drops_the_old_maps_job(small_async):
    """Hold the map lock, queue a keyframe's tail job, reset(), release:
    the job runs against a swapped map and drops itself; the new map is
    untouched and the old worker stops. assign_parent out of range is a
    no-op."""
    tr = small_async
    old_map, old_queue, old_worker = tr.map, tr._map_queue, tr._map_worker
    ids = tr._cache[:60]
    uv = np.full((len(ids), 2), 100.0, np.float32)
    with tr._map_lock:
        tr._create_keyframe(tr._carry.pyr, 1.0, tr._last_R, tr._last_t,
                            ids, uv, np.zeros(len(ids), np.int32))
        assert old_queue.unfinished_tasks == 1
        kf = old_map.n_kf - 1
        assert old_map.kf_feat_pending[kf]
        tr.reset()
        assert tr.map is not old_map and tr._map_worker is not old_worker
    old_queue.join()
    old_worker.join(timeout=30)
    assert not old_worker.is_alive()
    # dropped before its writes: the deferred extraction never landed and
    # no point was triangulated for the keyframe
    assert old_map.kf_feat_pending[kf]
    assert (old_map.kf_feat_pt[kf] >= 0).sum() == len(ids)
    new = tr.map
    assert new.n_kf == 0 and new.n_pt == 0
    assert tr.state == State.NOT_INITIALIZED
    assert tr._map_worker_error is None and tr._tail_idle()
    # the new worker runs jobs
    ran = []
    tr._map_queue.put(lambda: ran.append(1))
    tr.wait_mapping_idle()
    assert ran == [1]
    smap = SlamMap(max_kf=8)
    smap.n_kf = 3
    parents = smap.kf_parent.copy()
    smap.assign_parent(3)
    smap.assign_parent(7)
    assert np.array_equal(smap.kf_parent, parents)


def test_worker_tail_refreshes_the_reference_count(small_async):
    """C-ref15: once the worker's tail of the reference keyframe has run,
    the keyframe decision's reference count is that keyframe's bound
    points, the tracked ones it was created with and those its tail bound
    (the JAX count keeps the first)."""
    tr = small_async
    ids = tr._cache[:60]
    uv = tr._carry.pts[:60, :2].numpy()
    with tr._map_lock:
        tr._create_keyframe(tr._carry.pyr, 1.0, tr._last_R, tr._last_t,
                            ids, uv, np.zeros(len(ids), np.int32))
        assert tr._kf_ref_tracked == len(ids)
    tr.wait_mapping_idle()
    kf = tr._last_kf
    bound = int((tr.map.kf_feat_pt[kf] >= 0).sum())
    assert tr._kf_ref_tracked == bound > len(ids)


def test_inline_tail_keeps_the_jax_reference_count():
    """Without the worker the reference count stays the JAX one, the
    tracked points the keyframe was created with, after its tail bound
    more (C-ref15 is async only: the inline path is held to JAX frame for
    frame by test_torch_rgbd.py and test_torch_batch_track.py)."""
    tr = _initialized(False)
    ids = tr._cache[:60]
    uv = tr._carry.pts[:60, :2].numpy()
    tr._create_keyframe(tr._carry.pyr, 1.0, tr._last_R, tr._last_t, ids, uv,
                        np.zeros(len(ids), np.int32))
    kf = tr._last_kf
    assert int((tr.map.kf_feat_pt[kf] >= 0).sum()) > len(ids)
    assert tr._kf_ref_tracked == len(ids)


def test_worker_exception_surfaces_at_wait_mapping_idle(small_async):
    tr = small_async

    def failing_tail(smap, kf, pyr):
        raise RuntimeError("tail failed")

    tr._mapping_tail = failing_tail
    ids = tr._cache[:60]
    tr._create_keyframe(tr._carry.pyr, 1.0, tr._last_R, tr._last_t, ids,
                        np.full((len(ids), 2), 100.0, np.float32),
                        np.zeros(len(ids), np.int32))
    with pytest.raises(RuntimeError, match="tail failed"):
        tr.wait_mapping_idle()
    tr.wait_mapping_idle()     # raised once; the worker lives on
    assert tr._map_worker.is_alive()


# ------------------------------------------------ keyframe decision parity
W_, H_, F_ = 160, 120, 100.0


def _trackers(rgbd: bool, busy: bool):
    intr = (F_, F_, W_ / 2 - 0.5, H_ / 2 - 0.5, W_, H_)
    cfg = dict(enable_loop_closing=False, enable_relocalization=False)
    if rgbd:
        j = JRgbd(jcam.Camera.make(*intr), JConfig(**cfg))
        t = RgbdTracker(Camera.make(*intr), TrackerConfig(**cfg),
                        device="cpu")
    else:
        j = JMono(jcam.Camera.make(*intr), JConfig(**cfg))
        t = MonoTracker(Camera.make(*intr), TrackerConfig(**cfg),
                        device="cpu")
    if busy:
        # a queued tail job with a worker that has not taken it
        for tr in (j, t):
            tr._map_worker = object()
            tr._map_queue.put(lambda: None)
    return j, t


@pytest.mark.parametrize("rgbd", [False, True])
@pytest.mark.parametrize("busy", [False, True])
def test_keyframe_decision_matches_jax(rgbd, busy):
    """_need_new_keyframe, _need_close_points and _close_candidates of both
    packages on the same inputs (gaps, inlier counts, reference counts,
    tracked points near and far, depth maps), mapper idle and busy."""
    rng = np.random.default_rng(7 + 2 * rgbd + busy)
    j, t = _trackers(rgbd, busy)
    assert j._tail_idle() == t._tail_idle() == (not busy)
    n_pt = 400
    xyz = np.concatenate([rng.uniform(-1, 1, (n_pt, 2)),
                          rng.uniform(0.5, 6.0, (n_pt, 1))], 1)
    for tr in (j, t):
        tr.map.pt_xyz[:n_pt] = xyz.astype(np.float32)
        tr.map.n_pt = n_pt
    decisions, n_true = 0, 0
    for _ in range(160):
        gap = int(rng.choice([1, 3, 5, 12, 29, 30, 40]))
        n_inl = int(rng.choice([35, 49, 50, 80, 150, 300]))
        ref = int(rng.choice([60, 120, 400]))
        ids = rng.choice(n_pt, int(rng.choice([0, 40, 90, 150, 300])),
                         replace=False)
        R = np.eye(3, dtype=np.float32)
        tv = rng.normal(0, 0.3, 3).astype(np.float32)
        depth = None
        if rgbd and rng.random() < 0.8:
            depth = rng.uniform(0.2, rng.choice([2.0, 4.0, 8.0]),
                                (H_, W_)).astype(np.float32)
            depth[rng.random((H_, W_)) < rng.random()] = 0.0
        ts = float(rng.uniform(0, 10))
        for tr in (j, t):
            tr.frame_id = 100
            tr._last_kf_frame = 100 - gap
            tr._kf_ref_tracked = ref
            tr._cur_depth = depth
        assert t._close_candidates() == j._close_candidates()
        assert t._need_close_points(ids, R, tv) == \
            j._need_close_points(ids, R, tv)
        want = j._need_new_keyframe(ts, n_inl, ids, R, tv)
        assert t._need_new_keyframe(ts, n_inl, ids, R, tv) == want, \
            (gap, n_inl, ref, len(ids), busy)
        decisions += 1
        n_true += want
    # the inputs reach both answers
    assert 0 < n_true < decisions
