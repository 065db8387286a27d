"""Stereo and depth seeds in the torch port against the JAX reference on
the CPU: the batched disparity search (``ops/stereo.py``) on a rectified
pair and on its edge cases; a keyframe's RGB-D and stereo u_r, their depths
and the depth-seeded map points (close/far policy, patch gate,
R^T (Xc - t), patches) on the same map and features; the 3-row (u, v, u_r)
edges of pose optimization and local BA with mixed monocular and stereo
observations; and System.track_stereo end to end against the ground truth
with the JAX tests' bounds (tests/test_stereo.py,
tests/test_stereo_edges.py)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ygz_tpu.backend import optim as jopt
from ygz_tpu.frontend import tracker as jtracker
from ygz_tpu.geometry import camera as jcam
from ygz_tpu.ops import image as jimage
from ygz_tpu.ops.stereo import stereo_match_features as jstereo
from ygz_tpu_torch.backend import optim as topt
from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.frontend import tracker as ttracker
from ygz_tpu_torch.geometry import lie as tlie
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.ops import image as timage
from ygz_tpu_torch.ops.stereo import stereo_match_features as tstereo
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import agree, assert_close, np_, rot_angle_deg, t_
from test_vo_e2e import make_trajectory

BASELINE = 0.2            # metres, as tests/test_stereo.py
INTR = (400.0, 400.0, 320.0, 240.0)
BF = 80.0                 # baseline * fx


@pytest.fixture(scope="module")
def pair():
    scene = SmoothScene(seed=21)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    left, right = scene.render_pair(R0, t0, BASELINE)
    return scene, left, right, scene.depth(R0, t0)


def _both(left, right, uv, valid):
    """(disp, ok) of the JAX function and of its port on the same arrays."""
    dj, oj = jstereo(jnp.asarray(left), jnp.asarray(right), jnp.asarray(uv),
                     jnp.asarray(valid))
    dt, ot = tstereo(t_(left), t_(right), t_(uv), t_(valid))
    return np_(dj), np_(oj), np_(dt), np_(ot)


def _assert_same_search(dj, oj, dt, ot, min_agree):
    # 121-term SAD sums run in another order: a near-tie can flip the best
    # disparity of a feature (then its ok and delta); where both accept,
    # the float32 parabola agrees to ~1e-5 px
    both = oj & ot
    if both.any():
        assert np.abs(dj - dt)[both].max() < 1e-3
    assert agree(ot, oj) >= min_agree


def test_stereo_match_features_matches_jax(pair):
    scene, left, right, depth = pair
    rng = np.random.default_rng(0)
    n = 64
    uv = np.stack([rng.uniform(120, 520, n),
                   rng.uniform(100, 380, n)], 1).astype(np.float32)
    dj, oj, dt, ot = _both(left, right, uv, np.ones(n, bool))
    _assert_same_search(dj, oj, dt, ot, min_agree=0.98)
    assert ot.sum() > 0.8 * n
    # the JAX test's ground-truth bound: disparity = f * b / z
    z = depth[np.round(uv[ot, 1]).astype(int), np.round(uv[ot, 0]).astype(int)]
    err = np.abs(dt[ot] - scene.f * BASELINE / z)
    assert np.median(err) < 0.3, np.median(err)


@pytest.mark.parametrize("case",
                         ["all_invalid", "borders", "u_below_max_disp"])
def test_stereo_match_features_edge_cases_match_jax(pair, case):
    _, left, right, _ = pair
    H, W = left.shape
    rng = np.random.default_rng(1)
    n = 96
    uv = np.stack([rng.uniform(120, 520, n),
                   rng.uniform(100, 380, n)], 1).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "all_invalid":
        # no accepted feature: the median cut takes k = max(0, 1)
        valid[:] = False
    elif case == "borders":
        # a quarter each within 5 px of the left, right, top, bottom edge
        q = n // 4
        e = rng.uniform(0, 5, n).astype(np.float32)
        uv[:q, 0] = e[:q]
        uv[q:2 * q, 0] = W - 1 - e[q:2 * q]
        uv[2 * q:3 * q, 1] = e[2 * q:3 * q]
        uv[3 * q:, 1] = H - 1 - e[3 * q:]
    else:
        # part of each strip falls off the image's left edge
        uv[:, 0] = rng.uniform(6, 96, n).astype(np.float32)
    dj, oj, dt, ot = _both(left, right, uv, valid)
    _assert_same_search(dj, oj, dt, ot, min_agree=0.98)
    if case != "u_below_max_disp":
        assert not ot.any() and not oj.any()
    else:
        assert ot.any()
        # a strip that leaves the image keeps disparities its window fits
        assert (dt[ot] <= uv[ot, 0] - 5).all()


def test_level0_of_both_pyramid_forms(pair):
    _, left, _, _ = pair
    H = left.shape[0]
    levels = timage.build_pyramid(t_(left), 4)
    stacked = timage.stack_pyramid(levels)
    jlevels = jimage.build_pyramid(jnp.asarray(left), 4)
    for pyr, jpyr in ((levels, jlevels),
                      (stacked, jimage.stack_pyramid(jlevels))):
        assert_close(timage.level0(pyr, H), jimage.level0(jpyr, H), atol=0)
        np.testing.assert_array_equal(np_(timage.level0(pyr, H)), left)


def _view():
    """A view 2.1-3.2 m from the surface, so a ~2.3 m close/far threshold
    splits its features."""
    R = _so3([0.02, -0.03, 0.01])
    c = np.array([0.3, -0.2, 2.4], np.float32)
    return R, (-R @ c).astype(np.float32)


# th_depth in baseline units: bf / fx is 0.08 (RGB-D's virtual baseline)
# or 0.2 (stereo); "few" puts ~20 features under the threshold, so far
# points fill up to 100, "many" puts more than 100 under it
TH_DEPTH = {("rgbd", "few"): 28.75, ("rgbd", "many"): 33.75,
            ("stereo", "few"): 11.5, ("stereo", "many"): 13.5}


@pytest.mark.parametrize("split", ["few", "many"])
@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_depth_seeds_match_jax(sensor, split):
    scene = SmoothScene(seed=5)
    R, t = _view()
    left, right = scene.render_pair(R, t, BASELINE)
    left = np.clip(left, 0, 255).astype(np.uint8)
    right = np.clip(right, 0, 255).astype(np.uint8)
    depth = scene.depth(R, t)
    bf = scene.f * BASELINE if sensor == "stereo" else 0.0
    name = "StereoTracker" if sensor == "stereo" else "RgbdTracker"
    intr = (scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    th_depth = TH_DEPTH[(sensor, split)]
    jt = getattr(jtracker, name)(jcam.Camera.make(*intr, bf=bf),
                                 jtracker.TrackerConfig(th_depth=th_depth))
    tt = getattr(ttracker, name)(Camera.make(*intr, bf=bf),
                                 ttracker.TrackerConfig(th_depth=th_depth),
                                 device="cpu")
    assert jt.cam.bf == tt.cam.bf > 0 and jt._th_depth() == tt._th_depth()
    for tr in (jt, tt):
        if sensor == "stereo":
            tr._cur_right = right
        else:
            tr._cur_depth = depth
    pyrs = {"jax": jt._build_pyramid(left), "torch": tt._build_pyramid(left)}
    f = tt._feats_to_dict(tt.extractor(pyrs["torch"]))
    assert f["valid"].sum() > 400

    ur_j = jt._feature_ur(dict(f), pyrs["jax"])
    ur_t = tt._feature_ur(dict(f), pyrs["torch"])
    if sensor == "rgbd":
        # the same host numpy lookup on both sides
        np.testing.assert_array_equal(ur_t, ur_j)
        assert (ur_t >= 0).sum() == f["valid"].sum()
    else:
        # the disparity search, as in the tests above
        both = (ur_j >= 0) & (ur_t >= 0)
        assert np.abs(ur_t - ur_j)[both].max() < 1e-3
        assert agree(ur_t >= 0, ur_j >= 0) >= 0.98
        assert (ur_t >= 0).sum() > 0.8 * f["valid"].sum()

    # the same keyframe (the port's u_r on both sides), 50 slots already
    # bound as tracked points, then the depth seeds
    f["ur"] = ur_t
    out = {}
    for key, tr in (("jax", jt), ("torch", tt)):
        smap = tr.map
        kf = smap.add_keyframe(R, t, f, ts=0.0, frame_id=0,
                               pyramid=pyrs[key])
        ids = smap.alloc_points(50)
        smap.pt_valid[ids] = True
        smap.bind(kf, np.arange(50), ids)
        n = tr._create_depth_points(smap, kf, pyrs[key])
        slots = np.nonzero(smap.kf_feat_pt[kf] >= 0)[0][50:]
        d = np.asarray(tr._feature_depths(smap, kf, slots))
        out[key] = (n, smap, kf, slots, d)
    (nj, mj, kf, sj, dj), (nt, mt, _, st, dt) = out["jax"], out["torch"]
    assert nt == nj == len(st)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(mt.kf_feat_pt, mj.kf_feat_pt)
    np.testing.assert_array_equal(dt, dj)
    ids = mt.kf_feat_pt[kf, st]
    # R^T (Xc - t) in float32 numpy on both sides, the same inputs
    np.testing.assert_allclose(mt.pt_xyz[ids], mj.pt_xyz[ids], rtol=1e-5)
    np.testing.assert_array_equal(mt.pt_ref_uv[ids], mj.pt_ref_uv[ids])
    # bilinear patch captures (C4: an FMA contraction on the JAX side)
    np.testing.assert_allclose(mt.pt_patch[ids], mj.pt_patch[ids], atol=1e-3)
    # the close/far split: every close point kept, far ones nearest first
    # up to 100 points in all
    close = dt < tt._th_depth()
    if split == "few":
        assert 0 < close.sum() < 100 and nt == 100
    else:
        assert close.all() and nt > 100
    # and the seeds lie on the surface
    err = np.linalg.norm(mt.pt_xyz[ids] - scene.backproject(
        R, t, mt.kf_feat_uv[kf, st]), axis=1)
    assert np.median(err) < (0.01 if sensor == "rgbd" else 0.02)


def _points(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(4, 9, n)], 1).astype(np.float32)


def _project(X, R, t):
    fx, fy, cx, cy = INTR
    Xc = X @ R.T + t
    u = fx * Xc[:, 0] / Xc[:, 2] + cx
    v = fy * Xc[:, 1] / Xc[:, 2] + cy
    return (np.stack([u, v], -1).astype(np.float32),
            (u - BF / Xc[:, 2]).astype(np.float32))


def _so3(w):
    return np_(tlie.so3_exp(t_(np.asarray(w, np.float32))))


def _mixed_ur(rng, ur, n_out):
    """Half the observations stereo (noisy u_r), half monocular (-1); the
    first n_out stereo rows get a gross u_r outlier."""
    ur = ur + rng.normal(0, 0.2, ur.shape).astype(np.float32)
    stereo = rng.random(len(ur)) < 0.5
    stereo[:n_out] = True
    ur[:n_out] -= rng.uniform(15, 40, n_out).astype(np.float32)
    return np.where(stereo, ur, -1.0).astype(np.float32)


def test_stereo_pose_optimization_matches_jax():
    rng = np.random.default_rng(3)
    n = 256
    X = _points(rng, n)
    R_true = _so3([0.02, -0.03, 0.01])
    t_true = np.array([0.05, -0.03, 0.4], np.float32)
    uv, ur = _project(X, R_true, t_true)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    n_out = 20
    ur = _mixed_ur(rng, ur, n_out)
    is2 = (0.25 ** rng.integers(0, 3, n)).astype(np.float32)
    valid = rng.random(n) > 0.05
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    rj = jopt.pose_optimization(jnp.asarray(X), jnp.asarray(uv),
                                jnp.asarray(is2), jnp.asarray(valid),
                                jnp.asarray(R0), jnp.asarray(t0), INTR,
                                ur=jnp.asarray(ur), bf=BF)
    rt = topt.pose_optimization(t_(X), t_(uv), t_(is2), t_(valid), t_(R0),
                                t_(t0), INTR, ur=t_(ur), bf=BF)
    # 40 GN steps of a float32 6x6 system summed in another order (as
    # test_torch_optim.py's monocular case)
    assert rot_angle_deg(rt.R, rj.R) < 1e-3
    assert_close(rt.t, rj.t, atol=1e-4)
    assert agree(rt.inliers, rj.inliers) >= 0.99
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    # the stereo rows pin the depth translation; the u_r outliers are cut
    assert abs(float(np_(rt.t)[2]) - 0.4) < 0.01
    assert not np_(rt.inliers)[:n_out].any()


def test_stereo_local_bundle_adjustment_matches_jax():
    rng = np.random.default_rng(2)
    P, L = 4, 200
    X = _points(rng, L)
    kfR = np.stack([_so3(rng.standard_normal(3) * 0.01) for _ in range(P)])
    kft = np.zeros((P, 3), np.float32)
    kft[:, 0] = -0.25 * np.arange(P)
    obs = [], [], [], []
    for p in range(P):
        uv, ur = _project(X, kfR[p], kft[p])
        idx = np.nonzero((uv > 10).all(1) & (uv < [630, 470]).all(1))[0]
        for a, b in zip(obs, (np.full(len(idx), p), idx, uv[idx], ur[idx])):
            a.append(b)
    obs_p, obs_l, obs_uv, obs_ur = (np.concatenate(a) for a in obs)
    O, cap = len(obs_p), 1024
    obs_uv = obs_uv + rng.normal(0, 0.3, obs_uv.shape).astype(np.float32)
    obs_ur = _mixed_ur(rng, obs_ur, 15)

    def pad(a, fill):
        return np.concatenate([a, np.full((cap - O,) + a.shape[1:], fill,
                                          a.dtype)])

    scale = 1.1              # a wrong initial scale: only u_r rows fix it
    args = dict(kf_R=kfR.astype(np.float32),
                kf_t=(kft * scale).astype(np.float32),
                fixed=np.arange(P) < 1, points=(X * scale).astype(np.float32),
                pt_valid=np.ones(L, bool),
                obs_p=pad(obs_p.astype(np.int32), 0),
                obs_l=pad(obs_l.astype(np.int32), 0),
                obs_uv=pad(obs_uv, 0.0),
                obs_inv_sigma2=np.ones(cap, np.float32),
                obs_valid=np.arange(cap) < O)
    rj = jopt.local_bundle_adjustment(
        *(jnp.asarray(v) for v in args.values()), INTR, n_poses=P,
        n_points=L, phases=(10, 10), obs_ur=jnp.asarray(pad(obs_ur, -1.0)),
        bf=BF)
    rt = topt.local_bundle_adjustment(
        *(t_(v) for v in args.values()), INTR, n_poses=P, n_points=L,
        phases=(10, 10), obs_ur=t_(pad(obs_ur, -1.0)), bf=BF)
    # LM steps with a float32 Schur solve assembled by scatter-adds in
    # another order (as test_torch_optim.py's monocular case)
    for p in range(P):
        assert rot_angle_deg(rt.kf_R[p], rj.kf_R[p]) < 2e-3
    assert_close(rt.kf_t, rj.kf_t, atol=2e-4)
    assert_close(rt.points, rj.points, atol=2e-3)
    assert agree(rt.obs_inlier, rj.obs_inlier) >= 0.99
    assert_close(rt.total_chi2, rj.total_chi2, rtol=1e-2, atol=1e-2)
    # back to the metric baseline (0.75 from KF 0 to KF 3)
    base = np.linalg.norm(np_(rt.kf_t)[3] - np_(rt.kf_t)[0])
    assert abs(base - 0.75) < 0.01, base


def test_port_stereo_tracking_20_frames():
    """The JAX stereo end-to-end tests' bounds on 20 frames of their
    sequence (SmoothScene seed 22, 0.2 m baseline)."""
    scene = SmoothScene(seed=22)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h,
                      bf=scene.f * BASELINE)
    poses = make_trajectory(20)
    system = System(cam, Sensor.STEREO, device="cpu")
    states = [system.track_stereo(*scene.render_pair(R, t, BASELINE),
                                  i * 0.05)[0]
              for i, (R, t) in enumerate(poses)]
    assert states[0] == "OK", "stereo must initialize on the first frame"
    assert states.count("OK") == len(states), states

    smap = system.map
    bound = smap.kf_feat_pt[: smap.n_kf] >= 0
    assert int(((smap.kf_feat_ur[: smap.n_kf] >= 0) & bound).sum()) > 200
    kfs = [k for k in range(smap.n_kf) if smap.kf_valid[k]]
    o_ur = smap.observations(kfs, smap.points_in_kfs(kfs))[4]
    assert (o_ur >= 0).sum() > 200           # they reach the BA problem
    assert system.tracker.timer.count["stereo_match"] == smap.n_kf

    est = np.array([-r.R.T @ r.t for r in system.trajectory])
    gt = np.array([-R.T @ t for R, t in poses])
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.03, f"metric ATE RMSE {rmse:.4f}"
    span = np.linalg.norm(est[-1] - est[0]) / np.linalg.norm(gt[-1] - gt[0])
    assert abs(span - 1.0) < 0.10, span
