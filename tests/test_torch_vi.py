"""The torch port's mono-inertial tracker: its IMU bookkeeping against the
JAX package's MonoViTracker (window packing, body<->camera conversions with
a non-identity rig, the keyframe chain's preintegrations, the culling
guards and the merge of a culled keyframe's IMU samples), the
dead-reckoning re-anchor gate and the DR_MAX_S escalation at state level,
and System(Sensor.MONO_VI) end to end on the CPU over the JAX package's
tests/test_vio_e2e.py trajectory, held to that test's bounds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_tpu.frontend import vi_tracker as jvt
from ygz_tpu.geometry import camera as jcam
from ygz_tpu.imu.preintegration import preintegrate as jpreintegrate
from ygz_tpu_torch.frontend import vi_tracker as tvt
from ygz_tpu_torch.frontend.tracker import MonoTracker, TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils import synthetic as syn

import torch_parity as tp
import test_vio_e2e as jax_e2e

INTR = (400.0, 400.0, 320.0, 240.0, 640, 480)
TBC = np.eye(4, dtype=np.float32)
TBC[:3, :3] = so3_exp(torch.tensor([0.1, -0.2, 0.15])).numpy()
TBC[:3, 3] = [0.03, -0.06, 0.01]


def _samples(t0, t1, hz=100.0, w=(0.1, -0.2, 0.05), a=(0.3, 9.81, -0.1)):
    out = []
    t = t0 + 1.0 / hz
    while t <= t1 + 1e-9:
        out.append((t, np.array(w, np.float32), np.array(a, np.float32)))
        t += 1.0 / hz
    return out


def _trackers(**kw):
    """(JAX, port) MonoViTrackers on the same camera and rig."""
    jt = jvt.MonoViTracker(jcam.Camera.make(*INTR), **kw)
    tt = tvt.MonoViTracker(Camera.make(*INTR), device="cpu", **kw)
    return jt, tt


def _feats():
    return {"uv": np.zeros((4, 2), np.float32),
            "level": np.zeros(4, np.int32),
            "angle": np.zeros(4, np.float32),
            "desc": np.zeros((4, 256), np.uint8),
            "valid": np.zeros(4, bool)}


def _chain(tr, ts):
    I, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    return [tr.map.add_keyframe(I, z, _feats(), ts=t) for t in ts]


def test_pack_window_and_rig_conversions_match_jax():
    rng = np.random.default_rng(1)
    samples = _samples(0.0, 0.4, hz=200.0)
    samples = [(t + rng.uniform(-1e-3, 1e-3), g, a) for t, g, a in samples]
    for cap in (64, 512, 16):
        got = tvt._pack_window(samples, -0.01, cap)
        want = jvt._pack_window(samples, -0.01, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)

    jt, tt = _trackers(Tbc=TBC)
    tp.assert_close(tt.Rcb, jt.Rcb, atol=0.0)
    tp.assert_close(tt.tcb, jt.tcb, atol=0.0)
    for _ in range(5):
        R = so3_exp(torch.as_tensor(rng.normal(0, 0.5, 3).astype(
            np.float32))).numpy()
        t = rng.normal(0, 2, 3).astype(np.float32)
        for a, b in zip(tt._cam_to_body(R, t), jt._cam_to_body(R, t)):
            tp.assert_close(a, b, atol=1e-6)
        R_wb, P_wb = tt._cam_to_body(R, t)
        for a, b in zip(tt._body_to_cam(R_wb, P_wb),
                        jt._body_to_cam(R_wb, P_wb)):
            tp.assert_close(a, b, atol=1e-6)
        # round trip, and the camera centre is the body centre + R_wb tbc
        R2, t2 = tt._body_to_cam(R_wb, P_wb)
        tp.assert_close(R2, R, atol=1e-6)
        tp.assert_close(t2, t, atol=1e-5)
        tp.assert_close(-R.T @ t, P_wb + R_wb @ TBC[:3, 3], atol=1e-5)
    assert not tt.cfg.enable_loop_closing        # off under IMU, as in JAX


def test_kf_preints_batch_matches_jax_chain():
    """The tracker's keyframe chain preintegrated as one batch against the
    JAX tracker's per-link preintegrations of the same windows."""
    jt, tt = _trackers()
    ts = [0.0, 0.3, 0.8, 1.05]
    rng = np.random.default_rng(5)
    for tr in (jt, tt):
        tr._kf_order = _chain(tr, ts)
    assert tt._kf_order == jt._kf_order
    for i, k in enumerate(jt._kf_order[1:], start=1):   # the same windows
        raw = _samples(ts[i - 1], ts[i], hz=200.0, w=rng.normal(0, 0.2, 3),
                       a=(0.2, 9.7, 0.1))
        jt._kf_imu[k] = tt._kf_imu[k] = jvt._pack_window(raw, ts[i - 1],
                                                         jvt.KF_IMU_CAP)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    got = tt._kf_preints(bg)
    want = jt._kf_preints(bg)
    assert got.dR.shape == (3, 3, 3) and len(want) == 3
    for i, w in enumerate(want):
        for f in got._fields:
            wf = np.asarray(getattr(w, f))
            tp.assert_close(getattr(got, f)[i], wf,
                            atol=1e-6 + 1e-4 * float(np.abs(wf).max()),
                            what=f"link {i} {f}")


def test_merge_culled_imu_matches_ground_truth_link():
    """tests/test_vio_culling.py's chain A -> k -> B -> C with B culled: the
    successor's re-packed window preintegrates to the merged interval, and
    both packages re-pack it identically."""
    jt, tt = _trackers()
    ts = [0.0, 0.35, 0.7, 1.05]
    for tr in (jt, tt):
        kfs = _chain(tr, ts)
        raw = {kfs[1]: _samples(ts[0], ts[1]),
               kfs[2]: _samples(ts[1], ts[2], w=(-0.3, 0.1, 0.2),
                                a=(0.0, 9.5, 0.4)),
               kfs[3]: _samples(ts[2], ts[3], w=(0.2, 0.0, -0.1))}
        tr._kf_order = list(kfs)
        tr._kf_raw = {k: list(v) for k, v in raw.items()}
        for i, k in enumerate(kfs[1:], start=1):
            tr._kf_imu[k] = tvt._pack_window(raw[k], ts[i - 1],
                                             tvt.KF_IMU_CAP)
        tr.map.kf_valid[kfs[2]] = False
        tr._merge_culled_imu(tr.map)
        assert tr._kf_order == [kfs[0], kfs[1], kfs[3]]
        assert kfs[2] not in tr._kf_imu and kfs[2] not in tr._kf_raw
    for g, w in zip(tt._kf_imu[kfs[3]], jt._kf_imu[kfs[3]]):
        assert np.array_equal(g, w)

    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.1, 0.0, -0.05], np.float32)
    gt = tvt._pack_window(raw[kfs[2]] + raw[kfs[3]], ts[1], tvt.KF_IMU_CAP)
    both = tt._preintegrate([gt, tt._kf_imu[kfs[3]]], bg, ba)
    tp.assert_close(both.dP[1], both.dP[0], atol=1e-5)
    tp.assert_close(both.dV[1], both.dV[0], atol=1e-5)
    tp.assert_close(both.dR[1], both.dR[0], atol=1e-6)
    assert abs(float(both.dt[1]) - (ts[3] - ts[1])) < 1e-4
    want = jpreintegrate(*(jnp.asarray(a) for a in gt), jnp.asarray(bg),
                         jnp.asarray(ba))
    tp.assert_close(both.dP[1], want.dP, atol=1e-5)


def test_vio_culling_guards_protect_recent_and_prev():
    """The protect set handed to cull_keyframes: the last 10 chain
    keyframes (the direct previous and those within 0.15 s included); the
    oldest stay cullable."""
    _, tt = _trackers()
    kfs = _chain(tt, [0.3 * i for i in range(13)])
    tt._kf_order = list(kfs)
    tt._kf_raw = {k: [] for k in kfs}
    seen = {}

    def spy(smap, kf, protect=None):
        seen["protect"] = set(protect)
        return 0

    tt.mapper.cull_keyframes = spy
    assert tt._cull_keyframes(tt.map, kfs[-1]) == 0
    assert set(kfs[-10:]) <= seen["protect"]
    assert kfs[0] not in seen["protect"] and kfs[1] not in seen["protect"]


def _ready(tr, P_dr, V_dr=(0.5, 0.0, 0.0)):
    """A VINS-initialized tracker state after dead-reckoned frames."""
    tr.vio_ready = True
    tr.gravity_w = np.array([0.0, -9.81, 0.0], np.float32)
    tr._ns = (np.asarray(P_dr, np.float32), np.asarray(V_dr, np.float32),
              np.eye(3, dtype=np.float32))
    tr._dr_frames = 3
    tr._dr_since = 1.0
    tr._has_prior = True
    tr._prev_obs = "stale"
    tr.debug = {}


def _visual_frame(rng, P_vis, n=120):
    """A visual pose at body position P_vis (identity rotation, body ==
    camera) and n observations of points in front of it."""
    R = np.eye(3, dtype=np.float32)
    t = (-np.asarray(P_vis)).astype(np.float32)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 8, n)], 1).astype(np.float32) + P_vis
    Xc = X + t
    uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                   INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], 1)
    return R, t, np.arange(n), uv.astype(np.float32), \
        np.zeros(n, np.int32), X


def test_fuse_pose_reanchors_after_divergent_dead_reckoning():
    """The first fused update after an outage: a visual pose more than
    DR_REANCHOR_GAP_M from the dead-reckoned state re-anchors the filter
    there, unfused, in both packages alike."""
    rng = np.random.default_rng(7)
    P_vis = np.array([1.0, 0.2, 0.0], np.float32)
    R, t, ids, uv, lvl, X = _visual_frame(rng, P_vis)
    jt, tt = _trackers()
    for tr in (jt, tt):
        _ready(tr, P_vis + [0.8, 0.0, 0.1])
        assert tr._fuse_pose(R, t, ids, uv, lvl, xyz=X) is None
        assert tr.debug["dr_reanchored"] == pytest.approx(np.hypot(0.8, 0.1),
                                                          rel=1e-5)
        assert tr._dr_frames == 0 and tr._dr_since is None
        assert not tr._has_prior and tr._prev_obs is None
    for a, b in zip(tt._ns, jt._ns):
        tp.assert_close(a, b, atol=0.0)
    tp.assert_close(tt._ns[0], P_vis, atol=1e-6)
    tp.assert_close(tt._ns[1], [0.5, 0.0, 0.0], atol=0.0)   # sane: kept

    # an insane dead-reckoned velocity is dropped with the position
    _ready(tt, P_vis + [5.0, 0.0, 0.0], V_dr=(30.0, 0.0, 0.0))
    assert tt._fuse_pose(R, t, ids, uv, lvl, xyz=X) is None
    tp.assert_close(tt._ns[1], np.zeros(3), atol=0.0)

    # within the gate the update fuses: a pose comes back, no re-anchor
    _ready(tt, P_vis + [0.05, 0.0, 0.0], V_dr=(0.0, 0.0, 0.0))
    tt._prev_obs = None
    tt._has_prior = False
    win = tvt._pack_window(
        [(0.005 * (i + 1), np.zeros(3, np.float32),
          np.array([0.0, 9.81, 0.0], np.float32)) for i in range(10)],
        0.0, tvt.FRAME_IMU_CAP)
    tt._frame_pre = tt._preintegrate([win], tt.bg, tt.ba).take(0)
    out = tt._fuse_pose(R, t, ids, uv, lvl, xyz=X)
    assert out is not None and "dr_reanchored" not in tt.debug
    # the gate's reading: the dead-reckoned state's distance to vision
    assert tt.debug["dr_gap"] == pytest.approx(0.05, abs=1e-6)
    assert tt._dr_frames == 0 and tt._prev_obs is not None
    # between vision and the (stiff) IMU factor from the dead-reckoned state
    c = -out[0].T @ out[1]
    assert np.linalg.norm(c - P_vis) <= 0.05 + 1e-3, c


def test_dead_reckoning_budget_escalates_to_relocalization(monkeypatch):
    _, tt = _trackers()
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    pred = (np.array([1.0, 2.0, 3.0], np.float32),
            np.array([0.1, 0.0, 0.0], np.float32), np.eye(3, dtype=np.float32))

    # not initialized: no dead-reckoning, the frame is lost
    assert not tt._on_vision_failed(None, 0.0, R, t)
    # within DR_MAX_S: the propagated state is adopted
    _ready(tt, np.zeros(3))
    tt._dr_frames, tt._dr_since = 0, None
    tt._pred_body = pred
    assert tt._on_vision_failed(None, 0.5, R, t)
    assert tt._dr_since == 0.5 and tt._dr_frames == 1
    for a, b in zip(tt._ns, pred):
        tp.assert_close(a, b, atol=0.0)
    assert not tt._has_prior and tt._prev_obs is None
    assert tt._on_vision_failed(None, 1.5, R, t)            # 1.0 s: still
    assert tt._dr_frames == 2 and "dr_escalated" not in tt.debug
    # past the budget: escalate; no BoW index, so relocalization fails and
    # the frame goes LOST
    assert not tt._on_vision_failed(None, 1.55, R, t)
    assert tt.debug["dr_escalated"] is True
    assert tt._dr_since is None and tt._dr_frames == 0

    # a successful relocalization re-anchors the filter and hands its pose
    # to the frame consumer
    R_rel = so3_exp(torch.tensor([0.0, 0.1, 0.0])).numpy()
    t_rel = np.array([0.2, 0.0, -1.0], np.float32)

    def relocalized(self, pyr):
        self._last_R, self._last_t = R_rel, t_rel
        return True
    monkeypatch.setattr(MonoTracker, "_relocalize", relocalized)
    tt._dr_since = 0.0
    assert tt._on_vision_failed(None, 1.2, R, t)
    got_R, got_t = tt._recovered_pose_override
    tp.assert_close(got_R, R_rel, atol=0.0)
    tp.assert_close(got_t, t_rel, atol=0.0)
    R_wb, P_wb = tt._cam_to_body(R_rel, t_rel)
    tp.assert_close(tt._ns[0], P_wb, atol=1e-6)
    tp.assert_close(tt._ns[1], np.zeros(3), atol=0.0)


# the smallest image at which the port's 4-level ORB pyramid still holds
# its 31-px patches (the top level is 43x32), at the JAX test's field of
# view (f = w / 1.6); VINS init fires there as at 640x480
E2E_W, E2E_H, E2E_F = 344, 258, 215.0
N_E2E, N_BLANK, N_AFTER = 70, 3, 6


@pytest.fixture(scope="module")
def vi_run():
    """System(Sensor.MONO_VI) on the CPU over test_vio_e2e's trajectory
    with its settings; then N_BLANK blank frames (IMU only) and N_AFTER
    clean ones."""
    assert np.array_equal(syn.G_W, jax_e2e.G_W)
    scene = syn.SmoothScene(seed=11, w=E2E_W, h=E2E_H, f=E2E_F)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    system = System(cam, Sensor.MONO_VI, config=TrackerConfig(kf_max_gap=8),
                    device="cpu", vins_init_kfs=6, vins_init_time=1.2)
    tr = system.tracker
    fps = jax_e2e.FPS
    states, ready_at, debug, ns = [], None, [], []
    blank = np.full((scene.h, scene.w), 128.0, np.float32)
    for i in range(N_E2E + N_BLANK + N_AFTER):
        t = i / fps
        R, tt = syn.pose_fn(t)
        img = blank if N_E2E <= i < N_E2E + N_BLANK else scene.render(R, tt)
        imu = syn.synth_imu((i - 1) / fps, t) if i > 0 else []
        states.append(system.track_mono_vi(img, imu, timestamp=t)[0])
        debug.append(dict(tr.debug))
        ns.append(None if tr._ns is None else tr._ns[0].copy())
        if ready_at is None and tr.vio_ready:
            ready_at = i
    return system, states, ready_at, debug, ns


def _centre(rec):
    return -rec.R.T @ rec.t


def _truth(i):
    R, t = syn.pose_fn(i / jax_e2e.FPS)
    return -R.T @ t


def test_synthetic_imu_is_the_jax_tests():
    """The port's copy of the trajectory and its IMU, with the identity rig,
    is the JAX test's sample for sample; a lever arm changes only the
    accelerometer."""
    for i in (0, 7, 33):
        R, t = syn.pose_fn(i / 20.0)
        Rj, tj = jax_e2e.pose_fn(i / 20.0)
        assert np.array_equal(R, Rj) and np.array_equal(t, tj)
    got = syn.synth_imu(0.3, 0.4)
    want = jax_e2e.synth_imu(0.3, 0.4)
    assert len(got) == len(want) == 20
    for (t, g, a), (tw, gw, aw) in zip(got, want):
        assert t == tw and np.array_equal(g, gw) and np.array_equal(a, aw)
    lever = np.eye(4)
    lever[:3, 3] = [0.05, 0.0, -0.1]
    for (_, g, a), (_, gw, aw) in zip(syn.synth_imu(0.3, 0.4, Tbc=lever),
                                      want):
        tp.assert_close(g, gw, atol=1e-6)
        assert 0 < np.abs(a - aw).max() < 0.05


def test_port_mono_vi_recovers_metric_scale(vi_run, tmp_path):
    """tests/test_vio_e2e.py's bounds: the last frame OK, > 80% OK, VINS
    init fires, the post-init span metric within 12% without scale
    alignment, gravity within cos 0.985 of the truth."""
    system, states, ready_at, _, _ = vi_run
    states = states[:N_E2E]
    assert states[-1] == "OK", states[-10:]
    assert sum(s == "OK" for s in states) > 0.8 * N_E2E
    assert ready_at is not None, "VINS initialization never succeeded"
    recs = system.trajectory[:N_E2E]
    post = [i for i, r in enumerate(recs)
            if i > ready_at + 2 and r.state == "OK"]
    assert len(post) > 20
    i0, i1 = post[0], post[-1]
    span = np.linalg.norm(_centre(recs[i1]) - _centre(recs[i0])) \
        / np.linalg.norm(_truth(i1) - _truth(i0))
    assert abs(span - 1.0) < 0.12, f"metric scale off: span ratio {span:.3f}"
    g = system.tracker.gravity_w
    cosg = np.dot(g, syn.G_W) / (np.linalg.norm(g) * 9.81)
    assert cosg > 0.985, g

    path = tmp_path / "kf_navstate.txt"
    system.save_keyframe_trajectory_navstate(str(path))
    rows = np.loadtxt(path)
    assert rows.ndim == 2 and rows.shape[1] == 17 and np.isfinite(rows).all()
    assert len(rows) >= 3
    stats = system.tracker.stats()["stage_ms"]
    for stage in ("preint", "vio_fuse", "vio_ba", "vins_init"):
        assert stage in stats, stage


def test_port_mono_vi_dead_reckons_a_short_outage(vi_run):
    """Blank frames after init are carried by the IMU (OK, within the
    DR_MAX_S budget) and vision takes over again without a re-anchor: the
    dead-reckoned state stays within the gate. (A blank frame's logged pose
    is the frame step's prediction, which the sparse alignment may have
    moved, as in the JAX package; the NavState is the IMU's.)"""
    system, states, _, debug, ns = vi_run
    out = states[N_E2E: N_E2E + N_BLANK]
    assert out == ["OK"] * N_BLANK, out
    assert system.tracker._dr_frames == 0
    assert not any("dr_reanchored" in d or "dr_escalated" in d
                   for d in debug[N_E2E:])
    assert states[-N_AFTER:] == ["OK"] * N_AFTER, states[-N_AFTER:]
    recs = system.trajectory
    for i in range(N_E2E, len(recs)):
        # body == camera: the NavState position is the camera centre
        got = ns[i] if i < N_E2E + N_BLANK else _centre(recs[i])
        err = np.linalg.norm(got - _truth(i))
        assert err < 0.15, (i, err)
