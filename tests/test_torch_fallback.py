"""The port's lost-frame paths and its keyframe-tail map edits.

One 30-frame run of the port's System.track_monocular on the CPU over the
JAX package's synthetic VO sequence (tests/test_vo_e2e.py, SmoothScene seed
11), with one frame at 0.4x exposure: direct tracking (photometric) loses
it, so the feature fallback ladder (motion model -> reference keyframe ->
feature local map) has to recover the pose. The run also snapshots the map
just before the last keyframe's fuse; the fuse and culling steps of the
port's LocalMapper and of ``ygz_tpu.backend.mapping.LocalMapper`` then edit
copies of that one map, which must come out the same.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest

from ygz_tpu.backend.mapping import LocalMapper as JaxMapper
from ygz_tpu.geometry.camera import Camera as JaxCamera
from ygz_tpu_torch.backend.mapping import LocalMapper
from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.frontend.tracker import TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import np_
from test_vo_e2e import make_trajectory

N_FRAMES = 30
DARK = 15       # the under-exposed frame
DARK_GAIN = 0.4


def _system(scene):
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    return System(cam, Sensor.MONOCULAR, config=TrackerConfig(
        enable_loop_closing=False, enable_relocalization=False,
        async_mapping=False), device="cpu")


@pytest.fixture(scope="module")
def dark_run():
    scene = SmoothScene(seed=11)
    poses = make_trajectory(N_FRAMES)
    system = _system(scene)
    snaps = []
    fuse = LocalMapper.search_in_neighbors

    def snapshot_then_fuse(mapper, smap, kf, **kw):
        snaps[:] = [(copy.deepcopy(smap), kf)]
        return fuse(mapper, smap, kf, **kw)

    states, ladder = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LocalMapper, "search_in_neighbors", snapshot_then_fuse)
        for i, (R, t) in enumerate(poses):
            img = scene.render_u8(R, t)
            if i == DARK:
                img = (img * DARK_GAIN).astype(np.uint8)
            states.append(system.track_monocular(img, i * 0.05)[0])
            dbg = system.tracker.debug
            if "fb_motion" in dbg:
                ladder[i] = {k: dbg.get(k) for k in
                             ("fb_motion", "fb_refkf", "fb_localmap")}
    assert snaps, "no keyframe reached the fuse step"
    return scene, system, poses, states, ladder, snaps[0]


def test_fallback_ladder_recovers_dark_frame(dark_run):
    scene, system, poses, states, ladder, _ = dark_run
    assert DARK in ladder, (ladder, states)
    assert states[DARK] == "OK", states
    # the dark frame's features re-acquire the pose through the motion
    # model, and the feature local map confirms it
    assert ladder[DARK]["fb_motion"] and ladder[DARK]["fb_localmap"], ladder
    assert sum(s == "OK" for s in states) > 20, states
    assert states[-1] == "OK", states[-5:]
    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    # the ATE bound of the JAX package's end-to-end test
    rmse, _ = ate_rmse(np.array(est), np.array(gt), with_scale=True)
    assert rmse < 0.045, f"ATE RMSE {rmse:.4f}"


def test_blank_frame_goes_lost_cleanly():
    """A blank frame right after initialization (at frame 5): nothing to
    extract, every rung fails, the tracker goes LOST, and a map of <= 5
    keyframes is reset (reference reset-on-early-loss), after which
    tracking bootstraps again (in 6 frames, as it first did)."""
    scene = SmoothScene(seed=11)
    poses = make_trajectory(16)
    system = _system(scene)
    blank = 6
    states = []
    for i, (R, t) in enumerate(poses):
        img = scene.render_u8(R, t)
        if i == blank:
            img = np.full_like(img, 128)
        state, T = system.track_monocular(img, i * 0.05)
        assert np.isfinite(T).all(), i
        states.append(state)
        if i == blank:
            n_kf_after = system.map.n_kf
    assert states[blank - 1] == "OK", states
    assert states[blank] == "NOT_INITIALIZED", states
    assert n_kf_after == 0
    assert len(system.trajectory) == len(poses)
    assert [r.state for r in system.trajectory] == states
    assert "OK" in states[blank + 1:], states


# ----------------------------------------------------- map edits vs the JAX
def _pair(snap, mutate=None):
    """Two copies of one map: one for the JAX mapper (pyramids as jax
    arrays), one for the port's; plus both mappers."""
    smap, kf = snap
    a, b = copy.deepcopy(smap), copy.deepcopy(smap)
    if mutate is not None:
        mutate(a)
        mutate(b)
    a.kf_pyr = [None if p is None else jnp.asarray(np_(p)) for p in a.kf_pyr]
    return a, b, kf


def _mappers(scene):
    jcam = JaxCamera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                          scene.h)
    tcam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                       scene.h)
    return JaxMapper(jcam), LocalMapper(tcam, device="cpu")


def _assert_maps_equal(a, b, patch_atol=0.0):
    for name, va in vars(a).items():
        vb = getattr(b, name)
        if name == "kf_pyr":
            assert [p is None for p in va] == [p is None for p in vb]
        elif name == "pt_patch":
            np.testing.assert_allclose(va, vb, atol=patch_atol, err_msg=name)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=name)
        else:
            assert va == vb, name


def test_fuse_prepare_and_apply_match_jax(dark_run):
    scene, _, _, _, _, snap = dark_run
    ja, tb, kf = _pair(snap)
    jm, tm = _mappers(scene)
    others = [k for k in range(ja.n_kf) if k != kf and ja.kf_valid[k]]
    pts = ja.points_in_kfs(others)
    pj = jm._fuse_prepare(ja, kf, pts)
    pt = tm._fuse_prepare(tb, kf, pts)
    assert pj is not None and len(pj[0]) > 10
    for x, y in zip(pt, pj):
        np.testing.assert_array_equal(x, y)
    # apply one match per candidate onto the KF's valid features, so both
    # fresh binds and Replace-fuses of already bound slots happen
    rng = np.random.default_rng(0)
    feats = np.nonzero(ja.kf_feat_valid[kf])[0]
    n = len(pj[0])
    idx = rng.choice(feats, n, replace=False)
    ok = rng.random(n) < 0.8
    bound = ja.kf_feat_pt[kf, idx[ok]] >= 0
    assert bound.any() and (~bound).any()
    assert (jm._fuse_apply(ja, kf, pj[0], idx, ok)
            == tm._fuse_apply(tb, kf, pt[0], idx, ok))
    _assert_maps_equal(tb, ja)


def test_search_in_neighbors_matches_jax(dark_run):
    """The batched two-way fuse, then the descriptor refresh: Hamming
    distances and window gates on the same float32 projections, so the
    same matches, and the same map, exactly."""
    scene, _, _, _, _, snap = dark_run
    ja, tb, kf = _pair(snap)
    jm, tm = _mappers(scene)
    nj = jm.search_in_neighbors(ja, kf)
    nt = tm.search_in_neighbors(tb, kf)
    assert nt == nj and nt > 0
    ja.assign_parent(kf)
    tb.assign_parent(kf)
    jm.update_distinctive_descriptors(ja, kf)
    tm.update_distinctive_descriptors(tb, kf)
    _assert_maps_equal(tb, ja)


def _spread_track_stats(smap):
    """Found/visible counts spread across the 0.25 found-ratio gate."""
    rng = np.random.default_rng(1)
    n = smap.n_pt
    smap.pt_visible[:n] = rng.integers(0, 20, n)
    smap.pt_found[:n] = rng.integers(0, smap.pt_visible[:n] + 1)


@pytest.mark.parametrize("stats", ["as_tracked", "spread"])
def test_cull_points_matches_jax(dark_run, stats):
    scene, _, _, _, _, snap = dark_run
    ja, tb, _ = _pair(snap, _spread_track_stats if stats == "spread"
                      else None)
    jm, tm = _mappers(scene)
    nj = jm.cull_points(ja)
    assert tm.cull_points(tb) == nj and nj > 0
    _assert_maps_equal(tb, ja)


def test_cull_keyframes_matches_jax(dark_run):
    """KeyFrame culling with its parent re-link and the re-homing of the
    culled KF's reference patches. The snapshot's keyframes are not
    redundant yet, so every point gets 3 more observations (the same on
    both copies) and the newest-KF guard is narrowed to 1."""
    scene, _, _, _, _, snap = dark_run

    def more_observers(smap):
        smap.pt_obs[smap.pt_valid] += 3

    ja, tb, kf = _pair(snap, more_observers)
    jm, tm = _mappers(scene)
    nj = jm.cull_keyframes(ja, kf, min_id_gap=1)
    assert tm.cull_keyframes(tb, kf, min_id_gap=1) == nj and nj > 0
    # the re-captured patches: the same bilinear taps, but XLA's CPU
    # backend may contract the blend's multiply-add into an FMA, 1 ulp of
    # the 0..255 range (as in test_torch_mapping)
    _assert_maps_equal(tb, ja, patch_atol=1e-4)
