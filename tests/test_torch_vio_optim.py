"""The torch port's VI optimizers against the JAX package, on the setups of
tests/test_vio_optim.py, test_vio_window_ba.py and test_vins_init.py with a
non-identity body-camera rig: the single-state and pair NavState
optimizations (the pair's Schur marginal included), the NavState window BA
and VINS initialization, fed the same linearization point through
ygz_tpu_torch.interop; and every Jacobian the port computes without
forward-mode autodiff against jax.jacfwd at the same point."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_tpu.backend import vio_optim as jvo
from ygz_tpu.geometry import lie as jlie
from ygz_tpu.imu.preintegration import PreintState as JPreint, preintegrate
from ygz_tpu.imu import vins_init as jvi
from ygz_tpu_torch import interop
from ygz_tpu_torch.backend import vio_optim as tvo
from ygz_tpu_torch.imu import preintegration as tpre, vins_init as tvi

import torch_parity as tp
from test_vins_init import make_trajectory_imu

INTR = (400.0, 400.0, 320.0, 240.0)
# camera pose in the body frame (the reference's Tbc) and its inverse, the
# optimizers' camera-from-body extrinsic
RBC = np.asarray(jlie.so3_exp(jnp.asarray(
    np.array([0.1, -0.2, 0.15], np.float32))))
TBC = np.array([0.03, -0.06, 0.01], np.float32)
RCB = RBC.T.copy()
TCB = (-RBC.T @ TBC).astype(np.float32)
TBC4 = np.eye(4, dtype=np.float32)
TBC4[:3, :3], TBC4[:3, 3] = RBC, TBC

# tolerances of the port against the JAX package (float32 Gauss-Newton in
# another order on both sides)
TOL_PV, TOL_R_DEG, TOL_BIAS = 1e-4, 1e-3, 1e-5
TOL_INFO = 1e-3      # relative Frobenius distance of the information
TOL_JAC = 1e-4       # times max |J|


def _project(P, R, X):
    """Pixels of world points X seen from body pose (P, R) through the rig."""
    Xc = ((X - P) @ R) @ RCB.T + TCB
    return np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                     INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]], 1)


def _points(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(4, 9, n)], 1).astype(np.float32)


def _so3(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(w, np.float32))))


def _integrate(P0, V0, R0, a_w, w_b, n_s, g, dt_s=0.005):
    """Fine ground-truth integration and its exact IMU samples."""
    P, V, R = P0.copy(), V0.copy(), R0.copy()
    om, ac = [], []
    for _ in range(n_s):
        om.append(w_b)
        ac.append(R.T @ (a_w - g))
        P = P + V * dt_s + 0.5 * a_w * dt_s ** 2
        V = V + a_w * dt_s
        R = R @ _so3(w_b * dt_s)
    return P, V, R, om, ac


def _padded(om, ac, cap, dt_s=0.005):
    n = len(om)
    omp = np.zeros((cap, 3), np.float32)
    acp = np.zeros((cap, 3), np.float32)
    dts = np.zeros(cap, np.float32)
    val = np.zeros(cap, bool)
    omp[:n], acp[:n], dts[:n], val[:n] = om, ac, dt_s, True
    return omp, acp, dts, val


def _jax_preint(win, bg=None, ba=None):
    z = jnp.zeros(3)
    return preintegrate(*(jnp.asarray(a) for a in win),
                        z if bg is None else jnp.asarray(bg),
                        z if ba is None else jnp.asarray(ba))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _state_pair(state):
    """(JAX tuple, port tuple) of one (P, V, R, bg, ba) state."""
    state = tuple(np.asarray(a, np.float32) for a in state)
    return tuple(_j(a) for a in state), interop.state_from_numpy(state, "cpu")


def _frob_rel(a, b):
    a, b = tp.np_(a), tp.np_(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_state(got, want, what="", tol_ba=TOL_BIAS):
    P, V, R, bg, ba = got[:5]
    tp.assert_close(P, want[0], atol=TOL_PV, what=f"{what} P")
    tp.assert_close(V, want[1], atol=TOL_PV, what=f"{what} V")
    assert tp.rot_angle_deg(R, want[2]) < TOL_R_DEG, what
    tp.assert_close(bg, want[3], atol=TOL_BIAS, what=f"{what} bg")
    tp.assert_close(ba, want[4], atol=tol_ba, what=f"{what} ba")


def _single_setup(seed, n_vis=256, vision=True):
    """test_vio_optim's fusion case (or its IMU-only case) through the rig:
    gentle acceleration and rotation over a 0.25 s window."""
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    P0 = np.zeros(3, np.float32)
    V0 = np.array([0.3, 0.1, -0.05], np.float32)
    R0 = np.eye(3, dtype=np.float32)
    a_w = np.array([0.4, -0.2, 0.1], np.float32) if vision \
        else np.zeros(3, np.float32)
    w_b = np.array([0.1, 0.2, -0.15], np.float32) if vision \
        else np.array([0.0, 0.0, 0.3], np.float32)
    P1, V1, R1, om, ac = _integrate(P0, V0, R0, a_w, w_b, 50, g)
    jpre = _jax_preint(_padded(om, ac, 64))
    X = _points(rng, n_vis)
    uv = (_project(P1, R1, X)
          + rng.standard_normal((n_vis, 2)) * 0.3).astype(np.float32)
    valid = np.full(n_vis, vision)
    cur = (P1 + rng.standard_normal(3).astype(np.float32) * 0.05,
           V1 + rng.standard_normal(3).astype(np.float32) * 0.1,
           R1 @ _so3(rng.standard_normal(3) * 0.02),
           np.zeros(3), np.zeros(3))
    prev = (P0, V0, R0, np.zeros(3), np.zeros(3))
    return jpre, cur, prev, X, uv, valid, g, (P1, V1, R1)


@pytest.mark.parametrize("vision", [True, False], ids=["fused", "imu_only"])
def test_vio_pose_optimization_matches_jax(vision):
    jpre, cur, prev, X, uv, valid, g, truth = _single_setup(0, vision=vision)
    N = len(X)
    (jcur, tcur), (jprev, tprev) = _state_pair(cur), _state_pair(prev)
    zb = np.zeros(3, np.float32)
    want = jvo.vio_pose_optimization(
        jcur, jprev, jpre, (_j(zb), _j(zb)), jprev, jnp.eye(15),
        jnp.asarray(False), _j(X), _j(uv), jnp.ones(N), jnp.asarray(valid),
        _j(RCB), _j(TCB), INTR, _j(g))
    got = tvo.vio_pose_optimization(
        tcur, tprev, interop.preint_from_numpy(jpre, "cpu"),
        (tp.t_(zb), tp.t_(zb)), tprev, torch.eye(15), False, tp.t_(X),
        tp.t_(uv), torch.ones(N), tp.t_(valid), tp.t_(RCB), tp.t_(TCB), INTR,
        tp.t_(g))
    _assert_state(got, want, "single")
    assert tp.agree(got.inliers, want.inliers) >= 0.99
    assert _frob_rel(got.marg_info, want.marg_info) < TOL_INFO
    # and the JAX test's bounds against the truth
    P1, V1, R1 = truth
    tp.assert_close(got.P, P1, atol=5e-3)
    assert tp.rot_angle_deg(got.R, R1) < 0.2
    if vision:
        assert int(got.n_inliers) > 0.9 * N


def _pair_setup(seed=8, N=96):
    """test_vio_optim's pair case through the rig: an exact
    zero-noise preintegration between two states, reprojection on both."""
    rng = np.random.default_rng(seed)
    gw = np.array([0.0, 0.0, -9.81], np.float32)
    dt = 0.05
    P0 = np.zeros(3, np.float32)
    V0 = np.array([0.4, 0.1, 0.0], np.float32)
    R0 = np.eye(3, dtype=np.float32)
    R1 = _so3([0.01, 0.03, -0.02])
    P1 = (P0 + V0 * dt + 0.5 * gw * dt * dt
          + np.array([0.002, 0, 0.001], np.float32)).astype(np.float32)
    V1 = (V0 + gw * dt + np.array([0.04, 0.0, 0.02], np.float32)).astype(
        np.float32)
    z33 = np.zeros((3, 3), np.float32)
    jpre = JPreint(
        dP=_j(R0.T @ (P1 - P0 - V0 * dt - 0.5 * gw * dt * dt)),
        dV=_j(R0.T @ (V1 - V0 - gw * dt)), dR=_j(R0.T @ R1),
        J_P_bg=_j(z33), J_P_ba=_j(z33), J_V_bg=_j(z33), J_V_ba=_j(z33),
        J_R_bg=_j(z33), cov=_j(np.eye(9) * 1e-6), dt=_j(dt))
    X = _points(rng, N)
    uv0 = (_project(P0, R0, X) + rng.normal(0, 0.2, (N, 2))).astype(
        np.float32)
    uv1 = (_project(P1, R1, X) + rng.normal(0, 0.2, (N, 2))).astype(
        np.float32)
    b = np.zeros(3, np.float32)
    prev = (P0, V0, R0, b, b)
    cur = (P1 + np.array([0.05, -0.03, 0.04], np.float32),
           V1 + np.array([0.3, -0.2, 0.1], np.float32),
           R1 @ _so3([0.02, -0.02, 0.01]), b, b)
    return jpre, cur, prev, X, uv0, uv1, gw, (P1, V1, R1)


def _pair_integrated(seed=9, N=96):
    """A pair whose factor is a real preintegration of 0.25 s of samples
    (non-zero bias Jacobians): what the tracker runs without a prior, after
    its single-state step."""
    jpre, cur, prev, X, uv, valid, gw, truth = _single_setup(seed, N)
    rng = np.random.default_rng(seed + 1)
    uv0 = (_project(prev[0], prev[2], X)
           + rng.normal(0, 0.2, (N, 2))).astype(np.float32)
    return jpre, cur, prev, X, uv0, uv, gw, truth


@pytest.mark.parametrize("factor,has_prior", [
    ("exact", True), ("integrated", True), ("integrated", False)])
def test_vio_pose_optimization_pair_matches_jax(factor, has_prior):
    # without a prior, the exact zero-Jacobian factor leaves the previous
    # biases unobservable (both packages return NaN): only the integrated
    # factor runs without one
    jpre, cur, prev, X, uv0, uv1, gw, truth = \
        _pair_setup() if factor == "exact" else _pair_integrated()
    N = len(X)
    ones = np.ones(N, np.float32)
    validv = np.ones(N, bool)
    validv[::17] = False
    (jcur, tcur), (jprev, tprev) = _state_pair(cur), _state_pair(prev)
    info = (np.eye(15) * 1e4).astype(np.float32)
    b = np.zeros(3, np.float32)
    want = jvo.vio_pose_optimization_pair(
        jcur, jprev, jpre, (_j(b), _j(b)), jprev, _j(info),
        jnp.asarray(has_prior), _j(X), _j(uv0), _j(ones),
        jnp.asarray(validv), _j(X), _j(uv1), _j(ones), jnp.asarray(validv),
        _j(RCB), _j(TCB), INTR, _j(gw))
    got = tvo.vio_pose_optimization_pair(
        tcur, tprev, interop.preint_from_numpy(jpre, "cpu"),
        (tp.t_(b), tp.t_(b)), tprev, tp.t_(info), has_prior, tp.t_(X),
        tp.t_(uv0), tp.t_(ones), tp.t_(validv), tp.t_(X), tp.t_(uv1),
        tp.t_(ones), tp.t_(validv), tp.t_(RCB), tp.t_(TCB), INTR, tp.t_(gw))
    # without a prior two frames cannot observe ba: V0, V1 and ba trade off
    # exactly, and only the bias random walk and the 1e-8 damping pin it,
    # so float32 noise moves it by ~3e-5 (0.004-0.008 here); held to 1e-4
    # there, to 1e-5 everywhere else
    tol_ba = TOL_BIAS if has_prior else 1e-4
    _assert_state(got, want, "pair", tol_ba)
    _assert_state(got.prior_mean, want.prior_mean, "pair prior mean", tol_ba)
    assert tp.agree(got.inliers, want.inliers) >= 0.99
    assert _frob_rel(got.prior_info, want.prior_info) < TOL_INFO
    # the JAX test's bounds against the truth
    P1, V1, R1 = truth
    assert int(got.n_inliers) > 80
    tp.assert_close(got.P, P1, atol=5e-3)
    tp.assert_close(got.V, V1, atol=5e-2)
    assert tp.rot_angle_deg(got.R, R1) < 0.2
    M = tp.np_(got.prior_info)
    np.testing.assert_allclose(M, M.T, atol=1e-2 * max(1.0, abs(M).max()))
    ev = np.linalg.eigvalsh(M)
    assert ev.min() > -1e-2 * abs(ev).max(), ev.min()


def _link_fields(rng, n_links):
    """Random chain links: a JAX preintegration each, with bias Jacobians
    and covariance."""
    return [_jax_preint(_padded(
        rng.normal(0, 0.3, (40, 3)).astype(np.float32),
        (rng.normal(0, 0.5, (40, 3)) + [0, 0, 9.81]).astype(np.float32), 64))
        for _ in range(n_links)]


def _rand_state(rng, n=None):
    shape = (3,) if n is None else (n, 3)
    Rs = [_so3(rng.normal(0, 0.3, 3)) for _ in range(1 if n is None else n)]
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 0.5, shape).astype(np.float32),
            Rs[0] if n is None else np.stack(Rs),
            rng.normal(0, 0.01, shape).astype(np.float32),
            rng.normal(0, 0.05, shape).astype(np.float32))


def _jac_close(got, want, what):
    want = np.asarray(want)
    tol = TOL_JAC * float(np.abs(want).max())
    tp.assert_close(got, want, atol=tol, what=what)


def test_imu_and_bias_jacobians_match_jacfwd():
    """The IMU-factor and bias rows shared by all three optimizers, per
    link, against jax.jacfwd of the JAX package's _imu_pair_residual."""
    rng = np.random.default_rng(4)
    links = _link_fields(rng, 3)
    si, sj = _rand_state(rng, 3), _rand_state(rng, 3)
    bl_g = rng.normal(0, 0.01, 3).astype(np.float32)
    bl_a = rng.normal(0, 0.05, 3).astype(np.float32)
    gw = np.array([0.0, -9.81, 0.0], np.float32)
    pre = interop.preint_from_numpy(links, "cpu")
    imu_L, bias_L = tvo._imu_sqrt_info(pre.cov), tvo._bias_sqrt_w(pre.dt)
    ti, tj = interop.state_from_numpy(si, "cpu"), \
        interop.state_from_numpy(sj, "cpu")

    def fn(d):
        return tvo._imu_pair_residual(d[..., :15], d[..., 15:], ti, tj, pre,
                                      tp.t_(bl_g), tp.t_(bl_a), tp.t_(gw),
                                      imu_L, bias_L)
    r, J = tvo._jac_rows(fn, 15, 30, (3,), like=pre.dP)
    z = jnp.zeros(15)
    for e, jp in enumerate(links):
        args = (*(_j(a[e]) for a in si), *(_j(a[e]) for a in sj),
                jp.dP, jp.dV, jp.dR, jp.J_P_bg, jp.J_P_ba, jp.J_V_bg,
                jp.J_V_ba, jp.J_R_bg, jp.cov, jp.dt, _j(bl_g), _j(bl_a),
                _j(gw))
        want_r = jvo._imu_pair_residual(z, z, *args)
        tp.assert_close(r[e], want_r, atol=1e-4 * float(
            np.abs(np.asarray(want_r)).max()) + 1e-5, what=f"link {e} r")
        _jac_close(J[e, :, :15], jax.jacfwd(jvo._imu_pair_residual, 0)(
            z, z, *args), f"link {e} d/di")
        _jac_close(J[e, :, 15:], jax.jacfwd(jvo._imu_pair_residual, 1)(
            z, z, *args), f"link {e} d/dj")


def test_reprojection_and_prior_jacobians_match_jacfwd():
    """The analytic reprojection Jacobians (pose and point) against
    jax.jacfwd of the JAX package's _reproj_ns, and the prior rows' reverse
    mode against jax.jacfwd of the same prior residual in JAX."""
    rng = np.random.default_rng(6)
    P, V, R, bg, ba = _rand_state(rng)
    P = P * 0.1
    X = _points(rng, 32) @ R.T + P        # in front of the body
    X[0] = P + R @ np.array([0.0, 0.0, 1e-7])   # z clamped at 1e-6
    uv = rng.uniform(0, 640, (32, 2)).astype(np.float32)
    r, A, B, _ = tvo._reproj_body(tp.t_(P), tp.t_(R), tp.t_(X), tp.t_(uv),
                                  tp.t_(RCB), tp.t_(TCB), INTR)
    rows = [jax.jacfwd(jvo._reproj_ns, a)(
        jnp.zeros(15), jnp.zeros(3), _j(P), _j(R), _j(X[i]), _j(uv[i]),
        _j(RCB), _j(TCB), *INTR) for i in range(32) for a in (0, 1)]
    want_A = np.stack([np.asarray(j) for j in rows[0::2]])
    want_B = np.stack([np.asarray(j) for j in rows[1::2]])
    want_r = np.stack([np.asarray(jvo._reproj_ns(
        jnp.zeros(15), jnp.zeros(3), _j(P), _j(R), _j(X[i]), _j(uv[i]),
        _j(RCB), _j(TCB), *INTR)) for i in range(32)])
    ok = np.abs(want_r).max(1) < 1e5        # not the clamped point's r
    tp.assert_close(r[ok], want_r[ok], atol=1e-2)
    tp.assert_close(tvo._reproj_ns(torch.zeros(15), torch.zeros(3),
                                   tp.t_(P), tp.t_(R), tp.t_(X), tp.t_(uv),
                                   tp.t_(RCB), tp.t_(TCB), INTR)[ok],
                    want_r[ok], atol=1e-2)
    for i in range(32):
        _jac_close(A[i], want_A[i], f"d r / d pose, point {i}")
        _jac_close(B[i], want_B[i], f"d r / d point, point {i}")

    mean = _rand_state(rng)
    M = rng.normal(0, 1, (15, 15))
    info = (M @ M.T + np.eye(15)).astype(np.float32)
    L = tvo._prior_sqrt(tp.t_(info))
    st = interop.state_from_numpy((P, V, R, bg, ba), "cpu")
    tmean = interop.state_from_numpy(mean, "cpu")
    r, J = tvo._jac_rows(lambda d: tvo._prior_residual(
        tvo._inc(st, d), tmean, L, torch.tensor(1.0)), 15, 15, like=L)

    def jres(d):
        Pn, Vn, Rn, bgn, ban = jvo._inc(tuple(_j(a) for a in (P, V, R, bg,
                                                              ba)), d)
        e = jnp.concatenate([Pn - mean[0], Vn - mean[1],
                             jlie.so3_log_safe(_j(mean[2]).T @ Rn),
                             bgn - mean[3], ban - mean[4]])
        return jnp.asarray(tp.np_(L)).T @ e
    tp.assert_close(r, jres(jnp.zeros(15)), atol=1e-4 * float(
        np.abs(np.asarray(jres(jnp.zeros(15)))).max()))
    _jac_close(J, jax.jacfwd(jres)(jnp.zeros(15)), "prior rows")


def _window_setup(W_real, W, seed=0, L=64):
    """test_vio_window_ba's chain (constant world acceleration and body
    rate) through the rig, cut to L landmarks; padded to W with replicated
    states and identity links when W > W_real."""
    rng = np.random.default_rng(seed)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    a_w = np.array([0.3, -0.1, 0.05], np.float32)
    w_b = np.array([0.05, 0.1, -0.08], np.float32)
    P = [np.zeros(3, np.float32)]
    V = [np.array([0.4, 0.1, 0.0], np.float32)]
    R = [np.eye(3, dtype=np.float32)]
    links = []
    for _ in range(W_real - 1):
        p, v, r, om, ac = _integrate(P[-1], V[-1], R[-1], a_w, w_b, 40, g)
        P.append(p)
        V.append(v)
        R.append(r)
        links.append(_jax_preint(_padded(om, ac, 64)))
    z = JPreint.zero()
    links += [z._replace(cov=jnp.eye(9))] * (W - W_real)
    fields = tuple(np.stack([np.asarray(getattr(lk, f)) for lk in links])
                   for f in JPreint._fields)
    X = _points(rng, L)
    obs_k, obs_l, obs_uv = [], [], []
    for k in range(W_real):
        uv = _project(P[k], R[k], X) + rng.standard_normal((L, 2)) * 0.3
        inb = (uv > 10).all(1) & (uv < [630, 470]).all(1)
        for li in np.nonzero(inb)[0]:
            obs_k.append(k)
            obs_l.append(li)
            obs_uv.append(uv[li])
    O = 256
    n_o = len(obs_k)
    assert n_o <= O
    pad = O - n_o
    obs = (np.array(obs_k + [0] * pad, np.int32),
           np.array(obs_l + [0] * pad, np.int32),
           np.array(obs_uv + [[0, 0]] * pad, np.float32),
           np.array([1.0] * n_o + [0.0] * pad, np.float32))
    Pp, Vp, Rp = np.stack(P), np.stack(V), np.stack(R)
    for k in range(1, W_real):
        Pp[k] += rng.standard_normal(3).astype(np.float32) * 0.03
        Vp[k] += rng.standard_normal(3).astype(np.float32) * 0.05
        Rp[k] = Rp[k] @ _so3(rng.standard_normal(3) * 0.01)
    Xp = (X + rng.standard_normal(X.shape) * 0.25).astype(np.float32)
    idx = list(range(W_real)) + [W_real - 1] * (W - W_real)
    Pp, Vp, Rp = Pp[idx], Vp[idx], Rp[idx]
    fixed = np.array([True] + [False] * (W_real - 1) + [True] * (W - W_real))
    link_w = None if W == W_real else np.array(
        [1.0] * (W_real - 1) + [0.0] * (W - W_real), np.float32)
    return Pp, Vp, Rp, fixed, fields, Xp, obs, link_w, g, (P, V, R, X)


@pytest.mark.parametrize("W_real,W", [(4, 4), (4, 5)],
                         ids=["chain", "padded"])
def test_vio_window_ba_matches_jax(W_real, W):
    Pp, Vp, Rp, fixed, fields, Xp, obs, link_w, g, truth = \
        _window_setup(W_real, W)
    L = len(Xp)
    zW = np.zeros((W, 3), np.float32)
    z3 = np.zeros(3, np.float32)
    want = jvo.vio_window_ba(
        _j(Pp), _j(Vp), _j(Rp), _j(zW), _j(zW), jnp.asarray(fixed),
        tuple(jnp.asarray(f) for f in fields), _j(z3), _j(z3), _j(Xp),
        jnp.ones(L, bool), *(jnp.asarray(o) for o in obs), _j(RCB), _j(TCB),
        INTR, _j(g), n_win=W, n_points=L, iters=10,
        link_w=None if link_w is None else _j(link_w))
    got = tvo.vio_window_ba(
        tp.t_(Pp), tp.t_(Vp), tp.t_(Rp), tp.t_(zW), tp.t_(zW), tp.t_(fixed),
        tuple(tp.t_(f) for f in fields), tp.t_(z3), tp.t_(z3), tp.t_(Xp),
        torch.ones(L, dtype=torch.bool), *(tp.t_(o) for o in obs),
        tp.t_(RCB), tp.t_(TCB), INTR, tp.t_(g), n_win=W, n_points=L,
        iters=10, link_w=None if link_w is None else tp.t_(link_w))
    for k in range(W):
        _assert_state([a[k] for a in got[:5]], [a[k] for a in want[:5]],
                      f"state {k}")
    tp.assert_close(got.points, want.points, atol=1e-4)
    assert abs(float(got.total_chi2) / float(want.total_chi2) - 1) < 1e-3
    # the JAX test's bounds against the truth
    P, V, R, X = truth
    for k in range(1, W_real):
        assert np.linalg.norm(tp.np_(got.P[k]) - P[k]) < 5e-3, k
        assert tp.rot_angle_deg(got.R[k], R[k]) < 0.1, k
    err0 = np.linalg.norm(Xp - X, axis=1).mean()
    err1 = np.linalg.norm(tp.np_(got.points) - X, axis=1).mean()
    assert err1 < 0.5 * err0, (err0, err1)


def _vins_chain():
    """test_vins_init's chain: keyframes every 0.25 s over 3 s of exact IMU
    with biases, the rig's (non-identity) Tbc, metric = 4.2 vision units."""
    dt = 0.005
    ts, pos, rot, omegas, accs = make_trajectory_imu(T=3.0, dt=dt)
    bg_true = np.array([0.02, -0.015, 0.01], np.float32)
    ba_true = np.array([0.05, -0.03, 0.08], np.float32)
    omegas_m, accs_m = omegas + bg_true, accs + ba_true
    kf_idx = list(range(0, len(ts), int(0.25 / dt)))
    s_true = 4.2
    R_wc, c_vis = [], []
    for i in kf_idx:
        R_wb, p_wb = rot(ts[i]), pos(ts[i])
        R_wc.append((R_wb @ RBC).astype(np.float32))
        c_vis.append(((p_wb + R_wb @ TBC) / s_true).astype(np.float32))
    wins = [_padded(omegas_m[a:b], accs_m[a:b], 64, dt)
            for a, b in zip(kf_idx[:-1], kf_idx[1:])]
    return np.stack(c_vis), R_wc, wins, (s_true, bg_true, ba_true)


def test_vins_initialize_matches_jax():
    c_w, R_wc, wins, (s_true, bg_true, ba_true) = _vins_chain()

    def jax_preints(bg):
        return [_jax_preint(w, bg) for w in wins]

    want = jvi.vins_initialize(c_w, R_wc, jax_preints(np.zeros(3)),
                               jax_preints, TBC4)
    # the same linearization points, carried across
    got = tvi.vins_initialize(
        c_w, R_wc, interop.preint_from_numpy(jax_preints(np.zeros(3)), "cpu"),
        lambda bg: interop.preint_from_numpy(jax_preints(bg), "cpu"), TBC4)
    assert want.ok and got.ok
    assert abs(got.scale / want.scale - 1) < 1e-4
    assert np.linalg.norm(got.gravity_w - want.gravity_w) \
        < 1e-4 * np.linalg.norm(want.gravity_w)
    tp.assert_close(got.bg, want.bg, atol=1e-6)
    tp.assert_close(got.ba, want.ba, atol=1e-3)
    assert abs(got.scale_linear / want.scale_linear - 1) < 1e-4

    # the port end to end on its own batched preintegration: the JAX
    # test's bounds against the truth
    stacked = [tp.t_(np.stack(a)) for a in zip(*wins)]

    def port_preints(bg):
        return tpre.preintegrate(*stacked, tp.t_(np.asarray(bg, np.float32)),
                                 torch.zeros(3))
    own = tvi.vins_initialize(c_w, R_wc, port_preints(np.zeros(3)),
                              port_preints, TBC4)
    assert own.ok
    np.testing.assert_allclose(own.bg, bg_true, atol=2e-3)
    assert abs(own.scale / s_true - 1.0) < 0.03, own.scale
    np.testing.assert_allclose(own.gravity_w, [0, 0, -9.81], atol=0.15)
    np.testing.assert_allclose(own.ba, ba_true, atol=0.05)


def test_gyro_bias_jacobian_matches_jacfwd():
    c_w, R_wc, wins, _ = _vins_chain()
    R_wb = [R @ RBC.T for R in R_wc]
    jp = [_jax_preint(w) for w in wins]
    bg = np.array([0.01, -0.02, 0.005], np.float32)

    def jres(b):
        return jnp.concatenate([jlie.so3_log_safe(
            (p.dR @ jlie.so3_exp(p.J_R_bg @ b)).T @ (_j(R_wb[i]).T
                                                     @ _j(R_wb[i + 1])))
            for i, p in enumerate(jp)])
    R = tp.t_(np.stack(R_wb).astype(np.float32))
    r, J = tvi.gyro_residuals_jac(tp.t_(bg), interop.preint_from_numpy(
        jp, "cpu"), R[:-1].transpose(-1, -2) @ R[1:])
    tp.assert_close(r, jres(_j(bg)), atol=1e-5)
    _jac_close(J, jax.jacfwd(jres)(_j(bg)), "gyro bias")
