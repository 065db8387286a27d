"""Batched tracking in the torch port (framestep.frame_step_batch,
MonoTracker.track_batch, System.track_monocular_batch) on the CPU: the
chained frame steps against the JAX package's frame_step_batch, and the
twin of tests/test_batch_track.py (32 frames, SmoothScene seed 11), with
the port's batched run held to the JAX package's batched run on the same
frames and the same pipeline_depth, a blank frame inside a chunk included.
The port's two-view init draws its RANSAC samples from a torch.Generator;
the runs held to the JAX package's are given the JAX tracker's sample sets
(_JaxDraws), so both packages start from the same map."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.frontend import framestep as jfs
from ygz_tpu.ops import align as jalign
from ygz_tpu.frontend.tracker import MonoTracker as JTracker
from ygz_tpu.frontend.tracker import TrackerConfig as JConfig
from ygz_tpu.geometry import camera as jcam
from ygz_tpu_torch import interop
from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.frontend import framestep as tfs
from ygz_tpu_torch.frontend import tracker as ttracker
from ygz_tpu_torch.ops import align as talign
from ygz_tpu_torch.frontend.tracker import MonoTracker, State, TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

from test_torch_framestep import CAP, F, H, N_FRAMES, W, sequence  # noqa: F401
from test_vo_e2e import make_trajectory
from torch_parity import agree, np_, rot_angle_deg

N_E2E = 32
BLANK = 17      # inside the second chunk (frames 14-21) after init at 5


@pytest.fixture(scope="module")
def scene_frames():
    scene = SmoothScene(seed=11)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(N_E2E)
    frames = [np.asarray(scene.render(R, t)) for R, t in poses]
    return cam, poses, frames


def _stamps(n):
    return [i * 0.05 for i in range(n)]


class _JaxDraws:
    """The port's two_view_reconstruct given the JAX tracker's RANSAC sample
    sets: the JAX tracker splits its key (jax.random.PRNGKey(0), made anew
    by reset) at each init attempt and draws the homography's 200 sets of 8
    from that key and the fundamental's from fold_in(key, 1)
    (ygz_tpu/geometry/twoview.py::_ransac). A new port generator marks a
    new tracker or a reset."""

    def __init__(self):
        self.fn = ttracker.two_view_reconstruct
        self.gen = None

    @staticmethod
    def _draw(key, mask):
        n = mask.shape[0]
        probs = mask.astype(jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        idx = jax.vmap(lambda k: jax.random.choice(
            k, n, shape=(8,), replace=False, p=probs))(jax.random.split(key,
                                                                      200))
        return torch.as_tensor(np.array(idx)).long()

    def __call__(self, p1, p2, mask, K, generator, **kw):
        if generator is not self.gen:
            self.gen, self.rng = generator, jax.random.PRNGKey(0)
        self.rng, key = jax.random.split(self.rng)
        m = jnp.asarray(np_(mask))
        samples = [self._draw(key, m), self._draw(jax.random.fold_in(key, 1),
                                                  m)]
        return self.fn(p1, p2, mask, K, generator, samples=samples, **kw)


def _port_run(cam, frames, batch, depth=2, jax_draws=True):
    """The port's tracker over the frames: track_batch, or per frame when
    batch is 1; its two-view init on the JAX tracker's RANSAC samples, or
    on its own with jax_draws=False. Returns (tracker, [(state, R, t)],
    frames tracked per frame, the most chunks in flight)."""
    tr = MonoTracker(cam, TrackerConfig(track_batch=batch,
                                        pipeline_depth=depth), device="cpu")
    stamps = _stamps(len(frames))
    per_frame, inflight = [], [0, 0]
    track, dispatch = tr.track, tr._dispatch_chunk

    def counted_track(img, ts, **kw):
        per_frame.append(stamps.index(ts))
        return track(img, ts, **kw)

    def counted_dispatch(chunk, snap):
        inflight[0] += 1
        inflight[1] = max(inflight)
        outs_fn, pyrs = dispatch(chunk, snap)

        def consumed():
            inflight[0] -= 1
            return outs_fn()
        return consumed, pyrs

    tr.track, tr._dispatch_chunk = counted_track, counted_dispatch
    with pytest.MonkeyPatch.context() as mp:
        if jax_draws:
            mp.setattr(ttracker, "two_view_reconstruct", _JaxDraws())
        if batch > 1:
            res = tr.track_batch(frames, stamps)
        else:
            res = [tr.track(f, ts) for f, ts in zip(frames, stamps)]
    return tr, res, per_frame, inflight[1]


def _jax_run(cam, frames, batch=8, depth=2):
    tr = JTracker(jcam.Camera.make(cam.fx, cam.fy, cam.cx, cam.cy,
                                   cam.width, cam.height),
                  JConfig(track_batch=batch, pipeline_depth=depth))
    return tr.track_batch(frames, _stamps(len(frames)))


@pytest.fixture(scope="module")
def runs(scene_frames):
    cam, _, frames = scene_frames
    blanked = list(frames)
    blanked[BLANK] = np.full_like(frames[0], 128.0)
    return {"port1": _port_run(cam, frames, 1),
            "port8": _port_run(cam, frames, 8),
            "port8_serial": _port_run(cam, frames, 8, depth=1),
            "port8_serial_own": _port_run(cam, frames, 8, depth=1,
                                          jax_draws=False),
            "jax8": _jax_run(cam, frames),
            "port8_blank": _port_run(cam, blanked, 8),
            "jax8_blank": _jax_run(cam, blanked)}


def _centres(results):
    return np.asarray([-np.asarray(R).T @ np.asarray(t)
                       for st, R, t in results if st.name == "OK"])


def test_frame_step_batch_matches_jax(sequence):  # noqa: F811
    """frame_step_batch over 8 frames from the same carry and cache as the
    JAX function's, with test_torch_framestep's tolerances; the port's
    batch is its per-frame chain exactly."""
    frames, cache, carry = sequence
    intr = (F, F, W / 2.0 - 0.5, H / 2.0 - 0.5)
    imgs = np.stack(frames[1: N_FRAMES + 1]).astype(np.uint8)
    _, outs_j, pyrs_j = jfs.frame_step_batch(jnp.asarray(imgs), carry,
                                             jnp.asarray(cache), None, intr)
    ct = interop.carry_from_numpy(*(np.asarray(a) for a in carry),
                                  device="cpu")
    cache_t = interop.cache_from_numpy(cache, device="cpu")
    last, outs_t, pyrs_t = tfs.frame_step_batch(torch.as_tensor(imgs), ct,
                                                cache_t, None, intr)
    assert outs_t.shape == tuple(outs_j.shape) == (N_FRAMES,
                                                   tfs.N_SCALARS + 5 * CAP)
    assert pyrs_t.shape == tuple(pyrs_j.shape)
    # the pyramids: 2x2 means of the same integer frames
    np.testing.assert_allclose(np_(pyrs_t), np.asarray(pyrs_j), atol=1e-4)
    for i in range(N_FRAMES):
        oj = jfs.unpack_out(np.asarray(outs_j[i]), CAP)
        ot = tfs.unpack_out(np_(outs_t[i]), CAP)
        assert rot_angle_deg(ot.R, oj.R) < 1e-3, i
        np.testing.assert_allclose(ot.t, oj.t, atol=1e-4, err_msg=str(i))
        assert ot.align_ok == oj.align_ok
        assert agree(ot.tracked, oj.tracked) >= 0.99, i
        assert agree(ot.visible, oj.visible) >= 0.99, i
        both = ot.tracked & oj.tracked
        np.testing.assert_allclose(ot.uv[both], oj.uv[both], atol=2e-2)
    pred = torch.as_tensor(tfs.pack_pred_np())
    c = ct
    for i, img in enumerate(imgs):
        c, packed = tfs.frame_step(torch.as_tensor(img), c, cache_t, pred,
                                   None, intr)
        assert torch.equal(packed, outs_t[i]) and torch.equal(c.pyr,
                                                              pyrs_t[i])
    assert all(torch.equal(a, b) for a, b in zip(c, last))


def test_best_search_level_matches_jax():
    """best_search_level's written-out 2x2 determinant (no torch.linalg
    call inside the captured step) picks JAX's level: warps from shrinking
    to growing, with singular, flipped and level-boundary ones."""
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (4000, 2, 2)) * rng.uniform(0.05, 12, (4000, 1, 1))
    s = np.sqrt([0.5, 1.0, 2.0, 4.0, 16.0, 64.0])
    edges = s[:, None, None] * np.eye(2)                # det = 4^k exactly
    A = np.concatenate([A, edges, np.zeros((1, 2, 2)),
                        [[[0.0, 1.0], [1.0, 0.0]]]]).astype(np.float32)
    got = np_(talign.best_search_level(torch.as_tensor(A), 3))
    want = np.asarray(jalign.best_search_level(jnp.asarray(A), 3))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert set(np.unique(want)) == {0, 1, 2, 3}


def test_batch_matches_per_frame(runs):
    tr1, res1, _, _ = runs["port1"]
    tr8, res8, _, _ = runs["port8"]
    assert tr1.state == State.OK and tr8.state == State.OK
    ok1 = sum(st == State.OK for st, _, _ in res1)
    ok8 = sum(st == State.OK for st, _, _ in res8)
    assert ok8 >= ok1 - 2, f"batch path lost frames: {ok8} vs {ok1}"
    c1, c8 = _centres(res1), _centres(res8)
    m = min(len(c1), len(c8))
    span = np.linalg.norm(c1[-1] - c1[0])
    err = np.linalg.norm(c1[:m] - c8[:m], axis=1).max()
    assert err < 0.15 * span + 1e-3, (err, span)


def _batch_ate(poses, res):
    est, gt = [], []
    for (st, R, t), (Rg, tg) in zip(res, poses):
        if st == State.OK:
            est.append(-R.T @ t)
            gt.append(-Rg.T @ tg)
    return ate_rmse(np.asarray(est), np.asarray(gt), with_scale=True)[0]


def test_batch_accuracy_vs_gt(scene_frames, runs):
    """The JAX test's bound at the JAX test's configuration (B = 8, two
    chunks in flight), with the JAX tracker's init draws: both packages put
    the keyframe after init at frame 13, the last frame of a chunk."""
    rmse = _batch_ate(scene_frames[1], runs["port8"][1])
    assert rmse < 0.02, f"batch-mode ATE {rmse}"


def test_batch_accuracy_vs_gt_serial(scene_frames, runs):
    """The same bound with the port's own init draws at serial
    dispatch-consume (pipeline_depth 1). At depth 2 the port's own draw
    puts that keyframe at frame 15 instead (its init map holds 286 points
    to JAX's 290, and kf_ratio 0.75 is crossed two frames later), inside a
    chunk, so the chunk after it tracks the snapshot before it."""
    rmse = _batch_ate(scene_frames[1], runs["port8_serial_own"][1])
    assert rmse < 0.02, f"batch-mode ATE {rmse}"


def _assert_matches_jax(port, jax_res):
    """Equal states per frame; camera centres within 0.01 of each map's
    span and rotations within 0.05 deg. On the same init draws the two
    packages' centres differ by at most ~1.5e-4 (~1e-3 of the span) and
    their rotations by ~4e-3 deg on these frames."""
    assert len(port) == len(jax_res) == N_E2E
    states = [st.name for st, _, _ in port]
    assert states == [st.name for st, _, _ in jax_res]
    # each run of OK frames is one map (a reset starts another gauge)
    runs, start = [], None
    for i, st in enumerate(states + ["END"]):
        if st == "OK" and start is None:
            start = i
        elif st != "OK" and start is not None:
            runs.append((start, i))
            start = None
    for a, b in runs:
        cp, cj = _centres(port[a:b]), _centres(jax_res[a:b])
        span = np.linalg.norm(cj[-1] - cj[0])
        assert np.linalg.norm(cp - cj, axis=1).max() < 0.01 * span, (a, b)
    for (st, R, _), (_, Rj, _) in zip(port, jax_res):
        if st == State.OK:
            assert rot_angle_deg(R, np.asarray(Rj)) < 0.05


def test_port_batch_matches_jax_batch(runs):
    """Both packages' track_batch, B = 8 with two chunks in flight; and
    pipeline_depth is honoured (one chunk in flight at depth 1, the same
    states)."""
    tr8, res8, per_frame, inflight = runs["port8"]
    _assert_matches_jax(res8, runs["jax8"])
    # bootstrap frames and the short remainder run per frame
    assert per_frame == [0, 1, 2, 3, 4, 5, 30, 31], per_frame
    assert inflight == 2
    _, res_d1, per_frame_d1, inflight_d1 = runs["port8_serial"]
    assert inflight_d1 == 1 and per_frame_d1 == per_frame
    assert [r[0] for r in res_d1] == [r[0] for r in res8]


def test_abort_inside_a_chunk(runs):
    """A blank frame inside a chunk loses the track (the young map resets):
    the frames after it re-run per frame, the chunk dispatched after it is
    discarded, one result per input frame, and the states match JAX's."""
    tr, res, per_frame, _ = runs["port8_blank"]
    _assert_matches_jax(res, runs["jax8_blank"])
    assert res[BLANK][0] == State.LOST or res[BLANK][0] == \
        State.NOT_INITIALIZED
    assert BLANK not in per_frame and BLANK + 1 in per_frame, per_frame
    assert tr.state == State.OK


def test_system_track_monocular_batch_and_shutdown(scene_frames):
    """System.track_monocular_batch with the async worker: one (state name,
    T_cw) per frame; shutdown() drains the worker, every keyframe's
    deferred extraction has run and the cache snapshot is the last
    tail's."""
    cam, _, frames = scene_frames
    system = System(cam, Sensor.MONOCULAR, device="cpu", config=TrackerConfig(
        async_mapping=True, track_batch=8))
    out = system.track_monocular_batch(frames[:24], _stamps(24))
    system.shutdown()
    tr = system.tracker
    assert len(out) == 24
    for name, T in out:
        assert name in ("OK", "NOT_INITIALIZED", "LOST")
        assert T.shape == (4, 4) and T.dtype == np.float32
        assert np.isfinite(T).all() and np.array_equal(T[3], [0, 0, 0, 1])
    assert out[-1][0] == "OK"
    assert tr._tail_idle() and tr._map_worker.is_alive()
    smap = tr.map
    assert smap.n_kf >= 3
    assert not smap.kf_feat_pending[: smap.n_kf].any()
    assert (smap.kf_feat_valid[2: smap.n_kf].sum(1) > 100).all()
