"""Pose-only GN and Schur local BA of the torch port against the JAX
reference on seeded synthetic problems (noise + gross outliers)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ygz_tpu.backend import optim as jopt
from ygz_tpu.geometry import lie as jlie
from ygz_tpu_torch.backend import optim as topt
from ygz_tpu_torch.geometry import lie as tlie

from torch_parity import agree, assert_close, np_, rot_angle_deg, t_

INTR = (400.0, 400.0, 320.0, 240.0)


def _points(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(4, 9, n)], 1).astype(np.float32)


def _project(R, t, X):
    Xc = X @ R.T + t
    return np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                     INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]],
                    1).astype(np.float32)


def _so3(w):
    return np_(tlie.so3_exp(t_(np.asarray(w, np.float32))))


def test_lie_matches_jax():
    rng = np.random.default_rng(7)
    for scale in (1e-5, 0.3, 2.0):
        xi = (rng.standard_normal(6) * scale).astype(np.float32)
        Rj, tj = jlie.se3_exp(jnp.asarray(xi))
        Rt, tt = tlie.se3_exp(t_(xi))
        # Rodrigues in float32: a few ulps of a unit-norm matrix
        assert_close(Rt, Rj, atol=2e-6)
        assert_close(tt, tj, atol=2e-6 * max(1.0, scale))
        assert_close(tlie.so3_log(Rt), jlie.so3_log(Rj), atol=1e-4)
        assert_close(tlie.se3_log(Rt, tt), jlie.se3_log(Rj, tj),
                     atol=1e-4 * max(1.0, scale))


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_optimization_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    X = _points(rng, n)
    w_true = np.array([0.04, -0.03, 0.02], np.float32)
    R_true = _so3(w_true)
    t_true = np.array([0.2, -0.1, 0.05], np.float32)
    uv = _project(R_true, t_true, X)
    uv += rng.standard_normal(uv.shape).astype(np.float32) * 0.5
    n_out = 40
    uv[:n_out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    is2 = (0.25 ** rng.integers(0, 3, n)).astype(np.float32)
    valid = rng.random(n) > 0.05
    xi0 = np.concatenate([t_true + 0.05, w_true + 0.02]).astype(np.float32)
    Rj0, tj0 = jlie.se3_exp(jnp.asarray(xi0))
    rj = jopt.pose_optimization(jnp.asarray(X), jnp.asarray(uv),
                                jnp.asarray(is2), jnp.asarray(valid),
                                Rj0, tj0, INTR)
    rt = topt.pose_optimization(t_(X), t_(uv), t_(is2), t_(valid),
                                t_(np.asarray(Rj0)), t_(np.asarray(tj0)),
                                INTR)
    # 40 GN steps of a float32 6x6 system summed in another order: the
    # optimum agrees to ~1e-6 of the pose, 1e-4 leaves an order of margin
    assert rot_angle_deg(rt.R, rj.R) < 1e-3
    assert_close(rt.t, rj.t, atol=1e-4)
    assert agree(rt.inliers, rj.inliers) >= 0.99
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert not np_(rt.inliers)[:n_out].any()
    assert rot_angle_deg(rt.R, R_true) < 0.05


def _ba_problem(seed=2, P=5, L=160, noise=0.3, n_bad=30):
    rng = np.random.default_rng(seed)
    X = _points(rng, L)
    poses = [(_so3(rng.standard_normal(3) * 0.02),
              np.array([0.3 * p, 0.02 * p, 0.0], np.float32))
             for p in range(P)]
    obs_p, obs_l, obs_uv = [], [], []
    for p, (R, t) in enumerate(poses):
        uv = _project(R, t, X) + rng.standard_normal((L, 2)).astype(
            np.float32) * noise
        for l in np.nonzero(((uv > 10).all(1) & (uv < [630, 470]).all(1)))[0]:
            obs_p.append(p)
            obs_l.append(l)
            obs_uv.append(uv[l])
    O, cap = len(obs_p), 1024
    obs_p = np.array(obs_p + [0] * (cap - O), np.int32)
    obs_l = np.array(obs_l + [0] * (cap - O), np.int32)
    obs_uv = np.array(obs_uv + [[0, 0]] * (cap - O), np.float32)
    obs_valid = np.arange(cap) < O
    bad = rng.choice(O, n_bad, replace=False)
    obs_uv[bad] += rng.uniform(15, 40, (n_bad, 2)).astype(np.float32)
    kf_R = np.stack([R if p < 2 else _so3(rng.standard_normal(3) * 0.01) @ R
                     for p, (R, _) in enumerate(poses)])
    kf_t = np.stack([t if p < 2 else t + rng.standard_normal(3).astype(
        np.float32) * 0.03 for p, (_, t) in enumerate(poses)])
    Xp = X + rng.standard_normal(X.shape).astype(np.float32) * 0.05
    pt_valid = np.ones(L, bool)
    pt_valid[-5:] = False
    fixed = np.arange(P) < 2
    is2 = (0.25 ** rng.integers(0, 2, cap)).astype(np.float32)
    return dict(kf_R=kf_R.astype(np.float32), kf_t=kf_t.astype(np.float32),
                fixed=fixed, points=Xp, pt_valid=pt_valid, obs_p=obs_p,
                obs_l=obs_l, obs_uv=obs_uv, obs_inv_sigma2=is2,
                obs_valid=obs_valid), poses, X, bad


def test_local_bundle_adjustment_matches_jax():
    args, poses, X, bad = _ba_problem()
    P, L = len(poses), X.shape[0]
    rj = jopt.local_bundle_adjustment(
        *(jnp.asarray(v) for v in args.values()), INTR, n_poses=P,
        n_points=L)
    rt = topt.local_bundle_adjustment(
        *(t_(v) for v in args.values()), INTR, n_poses=P, n_points=L)
    # 15 LM steps with a float32 Schur solve assembled by scatter-adds in
    # another order: poses agree to ~1e-5, points (worse conditioned along
    # depth) to ~1e-4; tolerances leave an order of margin
    for p in range(P):
        assert rot_angle_deg(rt.kf_R[p], rj.kf_R[p]) < 2e-3
    assert_close(rt.kf_t, rj.kf_t, atol=2e-4)
    assert_close(rt.points, rj.points, atol=2e-3)
    assert agree(rt.obs_inlier, rj.obs_inlier) >= 0.99
    assert_close(rt.total_chi2, rj.total_chi2, rtol=1e-2, atol=1e-2)
    # anchors stay put; outliers are flagged; free poses recovered
    np.testing.assert_array_equal(np_(rt.kf_t)[:2], args["kf_t"][:2])
    assert not np_(rt.obs_inlier)[bad].any()
    for p in range(2, P):
        assert rot_angle_deg(rt.kf_R[p], poses[p][0]) < 0.1
        assert np.linalg.norm(np_(rt.kf_t)[p] - poses[p][1]) < 0.02


def test_residual_jacobians_and_robust_weights_match_jax():
    import jax

    rng = np.random.default_rng(4)
    n = 64
    X = _points(rng, n)
    R = np.stack([_so3(rng.standard_normal(3) * 0.1) for _ in range(n)])
    t = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    uv = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    ur = np.where(rng.random(n) > 0.5, uv[:, 0] - 20.0, -1.0).astype(
        np.float32)
    jv3 = jax.vmap(jopt._reproj_residual_jac3,
                   in_axes=(0, 0, 0, 0, 0, None, None, None, None, None))
    want = jv3(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
               jnp.asarray(uv), jnp.asarray(ur), 40.0, *INTR)
    got = topt._reproj_residual_jac3(t_(R), t_(t), t_(X), t_(uv), t_(ur),
                                     40.0, *INTR)
    # per-observation float32 products in another contraction order
    for a, b in zip(got, want):
        assert_close(a, b, rtol=1e-5, atol=1e-3)
    jv2 = jax.vmap(jopt._reproj_residual_jac,
                   in_axes=(0, 0, 0, 0, None, None, None, None))
    want = jv2(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X),
               jnp.asarray(uv), *INTR)
    got = topt._reproj_residual_jac(t_(R), t_(t), t_(X), t_(uv), *INTR)
    for a, b in zip(got, want):
        assert_close(a, b, rtol=1e-5, atol=1e-3)
    chi2 = np.array([0.0, 1.0, 4.0, 25.0, 1e4], np.float32)
    for kind, d2 in (("unit", 4.0), ("huber", 4.0), ("tukey", 16.0),
                     ("tdist", 4.0)):
        # elementwise float32 formulas: a few ulps
        assert_close(topt.robust_weight(t_(chi2), kind, d2),
                     jopt.robust_weight(jnp.asarray(chi2), kind, d2),
                     rtol=1e-6, atol=1e-7)
