"""Parity of the torch port's relocalization and loop-closing numerics with
the JAX package: the EPnP / DLT / Kabsch / Horn solvers, the Sim3 algebra,
PnP and Sim3 RANSAC on injected samples, degenerate samples, and the dense
and PCG pose-graph solvers. Same numpy inputs through both packages, with
the tolerance stated at each comparison.

The RANSAC draws differ between the packages (torch.Generator vs
jax.random), so the RANSACs are compared on the same injected index sets:
the JAX side runs its own solvers, scoring and polish on them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_tpu.backend import pnp as jpnp
from ygz_tpu.backend import posegraph as jpg
from ygz_tpu.backend.optim import pose_optimization as jpose_opt
from ygz_tpu.geometry import lie as jlie
from ygz_tpu.geometry import sim3 as jsim3
from ygz_tpu_torch.backend import pnp as tpnp
from ygz_tpu_torch.backend import posegraph as tpg
from ygz_tpu_torch.geometry import sim3 as tsim3
from ygz_tpu_torch.geometry.twoview import draw_samples

from torch_parity import agree, assert_close, np_, rot_angle_deg, t_
import test_sim3_posegraph

INTR = (400.0, 400.0, 320.0, 240.0)


def _pnp_problem(N, planar=False, noise=0.3, n_out=0, seed=1):
    rng = np.random.default_rng(seed)
    z = (np.full(N, 6.0) + rng.uniform(-0.02, 0.02, N) if planar
         else rng.uniform(4, 9, N))
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), z],
                 1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.standard_normal(3).astype(np.float32) * 0.1)))
    t = np.array([0.3, -0.2, 0.4], np.float32)
    Xc = X @ R.T + t
    uv = np.stack([INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2],
                   INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]],
                  1).astype(np.float32)
    uv += rng.standard_normal(uv.shape).astype(np.float32) * noise
    uv[:n_out] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    return X, uv, R, t


def _uvn(uv):
    return np.stack([(uv[:, 0] - INTR[2]) / INTR[0],
                     (uv[:, 1] - INTR[3]) / INTR[1]], -1).astype(np.float32)


@pytest.fixture
def pinned_eigh(monkeypatch):
    """Both packages' symmetric eigensolvers with each eigenvector's sign
    pinned (largest component positive). EPnP's control points (centroid +
    signed principal axes) and the DLT's scale depend on the sign each
    library happens to return, so an unpinned comparison reads two valid
    but different solutions."""
    jeigh, teigh = jnp.linalg.eigh, tpnp.eigh_finite

    def jax_pinned(A):
        w, V = jeigh(A)
        i = jnp.argmax(jnp.abs(V), axis=-2)
        return w, V * jnp.sign(jnp.take_along_axis(V, i[..., None, :], -2))

    def torch_pinned(A):
        w, V = teigh(A)
        i = V.abs().argmax(-2, keepdim=True)
        return w, V * torch.sign(torch.gather(V, -2, i))

    monkeypatch.setattr(jnp.linalg, "eigh", jax_pinned)
    monkeypatch.setattr(tpnp, "eigh_finite", torch_pinned)


@pytest.mark.parametrize("solver", ["_epnp_pose", "_epnp_planar",
                                    "_epnp_best"])
@pytest.mark.parametrize("planar", [False, True])
def test_epnp_solvers_match_jax(pinned_eigh, solver, planar):
    """A batch of 6 samples of 20 points each through the port's batched
    solver and the JAX solver vmapped, both in float64 with pinned
    eigenvector signs: rotation within 1e-4 deg, translation within 1e-6.
    The port's float32 result stays within 0.01 deg and 1e-3 of that."""
    X, uv, R, t = _pnp_problem(60, planar)
    idx = np.random.default_rng(2).permutation(60).reshape(3, 20)
    idx = np.concatenate([idx, idx[:, ::-1]])
    Xs, us = X[idx].astype(np.float64), _uvn(uv)[idx].astype(np.float64)
    with jax.enable_x64(True):
        jout = jax.jit(jax.vmap(getattr(jpnp, solver)))(jnp.asarray(Xs),
                                                        jnp.asarray(us))
        jout = [np.asarray(a) for a in jout]
    tout = getattr(tpnp, solver)(t_(Xs), t_(us))
    t32 = getattr(tpnp, solver)(t_(Xs, torch.float32), t_(us, torch.float32))
    for b in range(len(idx)):
        assert rot_angle_deg(tout[0][b], jout[0][b]) < 1e-4, b
        assert rot_angle_deg(t32[0][b], jout[0][b]) < 0.01, b
        assert_close(tout[1][b], jout[1][b], atol=1e-6, what=str(b))
        assert_close(t32[1][b], jout[1][b], atol=1e-3, what=str(b))
    if solver != "_epnp_best":
        assert_close(tout[2], jout[2], atol=1e-12, rtol=1e-4)


def test_dlt_and_kabsch_match_jax(pinned_eigh):
    """The 6-point DLT on a general scene (float64, pinned eigenvector
    signs; unpinned, a negative DLT scale is not folded into R, a
    reference-side defect; a planar scene leaves it a multi-dimensional
    nullspace) and the batched Kabsch fit."""
    X, uv, R, t = _pnp_problem(20)
    X, uvn = X.astype(np.float64), _uvn(uv).astype(np.float64)
    with jax.enable_x64(True):
        Rj, tj = (np.asarray(a) for a in jpnp._dlt_pose(
            jnp.asarray(X), jnp.asarray(uvn)))
    Rt, tt = tpnp._dlt_pose(t_(X)[None], t_(uvn)[None])
    assert rot_angle_deg(Rt[0], Rj) < 1e-4
    assert_close(tt[0], tj, atol=1e-6)
    assert rot_angle_deg(Rt[0], R) < 1.0
    rng = np.random.default_rng(3)
    Xw = rng.normal(size=(4, 30, 3)).astype(np.float32)
    Rk = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.3, -0.2, 0.5],
                                                      np.float32))))
    Xc = Xw @ Rk.T + 0.5 + rng.normal(size=Xw.shape).astype(np.float32) * .01
    Rj, tj = jax.vmap(jpnp._kabsch)(jnp.asarray(Xw), jnp.asarray(Xc))
    Rt, tt = tpnp._kabsch(t_(Xw), t_(Xc))
    assert_close(Rt, Rj, atol=1e-5)
    assert_close(tt, tj, atol=1e-5)


def _rand_sim3s(rng, n):
    w = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    R = np.asarray(jax.vmap(jlie.so3_exp)(jnp.asarray(w)))
    t = rng.standard_normal((n, 3)).astype(np.float32)
    s = np.exp(rng.uniform(-0.3, 0.3, n)).astype(np.float32)
    return R, t, s


def test_sim3_algebra_matches_jax():
    rng = np.random.default_rng(0)
    Ra, ta, sa = _rand_sim3s(rng, 8)
    Rb, tb, sb = _rand_sim3s(rng, 8)
    X = rng.standard_normal((8, 10, 3)).astype(np.float32)
    T = [t_(a) for a in (Ra, ta, sa, Rb, tb, sb)]
    J = [jnp.asarray(a) for a in (Ra, ta, sa, Rb, tb, sb)]
    for got, want in zip(tsim3.sim3_mul(*T), jax.vmap(jsim3.sim3_mul)(*J)):
        assert_close(got, want, atol=1e-5)
    for got, want in zip(tsim3.sim3_inv(*T[:3]),
                         jax.vmap(jsim3.sim3_inv)(*J[:3])):
        assert_close(got, want, atol=1e-5)
    assert_close(tsim3.sim3_apply(*T[:3], t_(X)),
                 jax.vmap(jsim3.sim3_apply)(*J[:3], jnp.asarray(X)),
                 atol=1e-5)
    xi = rng.standard_normal((8, 7)).astype(np.float32) * 0.3
    for got, want in zip(tsim3.sim3_exp(t_(xi)),
                         jax.vmap(jsim3.sim3_exp)(jnp.asarray(xi))):
        assert_close(got, want, atol=1e-5)
    assert_close(tsim3.sim3_log(*T[:3]), jax.vmap(jsim3.sim3_log)(*J[:3]),
                 atol=1e-4)


def test_horn_matches_jax():
    """Batched Horn with masks, and with scale fixed. The SVD's signs
    differ between the libraries; R, t and s must not."""
    rng = np.random.default_rng(2)
    R, t, s = _rand_sim3s(rng, 6)
    X = rng.standard_normal((6, 40, 3)).astype(np.float32)
    Y = s[:, None, None] * (X @ R.transpose(0, 2, 1)) + t[:, None]
    Y += rng.normal(size=Y.shape).astype(np.float32) * 0.002
    mask = rng.random((6, 40)) > 0.3
    for with_scale in (True, False):
        got = tsim3.horn_sim3(t_(X), t_(Y), t_(mask), with_scale)
        want = jax.vmap(lambda a, b, m: jsim3.horn_sim3(a, b, m, with_scale))(
            jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask))
        for g, w in zip(got, want):
            assert_close(g, w, atol=2e-5)
    R0, _, s0 = tsim3.horn_sim3(t_(X), t_(Y), t_(mask))
    assert_close(R0, R, atol=2e-3)
    assert_close(s0, s, atol=2e-3)


def _jax_pnp_ransac(X, uv, valid, idx, min_inliers=10):
    """The JAX pnp_ransac body on given index sets."""
    fx, fy, cx, cy = INTR
    X, uv, valid = jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid)
    uvn = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    Rs, ts = jax.jit(jax.vmap(jpnp._epnp_best))(X[idx], uvn[idx])

    def count(R, t):
        Xc = X @ R.T + t
        zi = 1.0 / jnp.maximum(Xc[:, 2], 1e-6)
        e2 = ((fx * Xc[:, 0] * zi + cx - uv[:, 0]) ** 2
              + (fy * Xc[:, 1] * zi + cy - uv[:, 1]) ** 2)
        return jnp.sum(valid & (e2 < 5.991) & (Xc[:, 2] > 0))

    best = jnp.argmax(jax.vmap(count)(Rs, ts))
    res = jpose_opt(X, uv, jnp.ones(len(X)), valid, Rs[best], ts[best],
                    INTR, chi2_th=5.991)
    return res.n_inliers >= min_inliers, res


@pytest.mark.parametrize("planar", [False, True])
def test_pnp_ransac_on_injected_samples_matches_jax(planar):
    """300 4-point hypotheses (30% outliers): the winning hypotheses may
    differ (a 4-point EPnP leaves a 4-dim nullspace, solved differently by
    the two eigensolvers), but the polished pose agrees within 0.01 deg and
    1e-3, and the inlier masks in >= 99% of the entries."""
    X, uv, R, t = _pnp_problem(128, planar, noise=0.3, n_out=38, seed=5)
    valid = np.ones(128, bool)
    valid[-5:] = False
    g = torch.Generator()
    g.manual_seed(0)
    idx = draw_samples(t_(valid), 300, 4, g)
    okj, rj = _jax_pnp_ransac(X, uv, valid, np_(idx))
    rt = tpnp.pnp_ransac(t_(X), t_(uv), t_(valid), INTR, samples=idx)
    assert bool(rt.ok) and bool(okj)
    assert rot_angle_deg(rt.R, rj.R) < 0.01
    assert_close(rt.t, rj.t, atol=1e-3)
    assert agree(rt.inliers, rj.inliers) >= 0.99
    # and both recover the truth
    assert rot_angle_deg(rt.R, R) < 0.5
    assert np.linalg.norm(np_(rt.t) - t) < 0.05
    assert not np_(rt.inliers)[:38].any()


def test_pnp_degenerate_samples_are_rejected_without_raising():
    """Garbage correspondences (the JAX test's case), collinear points,
    repeated points and a non-finite point: no claim of success, and no
    exception from the eigen-solves, SVDs or inverses."""
    rng = np.random.default_rng(2)
    N = 64
    X = rng.uniform(-1, 1, (N, 3)).astype(np.float32) + [0, 0, 5]
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    g = torch.Generator()
    g.manual_seed(0)
    ones = np.ones(N, bool)
    res = tpnp.pnp_ransac(t_(X, torch.float32), t_(uv), t_(ones), INTR, g,
                          min_inliers=15)
    okj, _ = _jax_pnp_ransac(X, uv, ones, np_(draw_samples(t_(ones), 300, 4,
                                                           g)), 15)
    assert not bool(res.ok) and not bool(okj)
    line = np.zeros((N, 3), np.float32)
    line[:, 0] = np.linspace(-1, 1, N)
    line[:, 2] = 5.0
    same = np.repeat(X[:1], N, 0)
    bad = X.copy()
    bad[::2] = np.nan
    for Xd in (line, same, bad):
        res = tpnp.pnp_ransac(t_(Xd), t_(uv), t_(ones), INTR, g,
                              min_inliers=15)
        assert not bool(res.ok)
    # DLT hypotheses on degenerate samples: finite or masked, never raising
    Rs, ts = tpnp._dlt_pose(t_(np.stack([line[:6], same[:6], bad[:6]])),
                            t_(uv[None, :6].repeat(3, 0) / 640.0))
    assert Rs.shape == (3, 3, 3)


def _sim3_problem(n=200, n_out=60, seed=3):
    rng = np.random.default_rng(seed)
    R, t, s = (a[0] for a in _rand_sim3s(rng, 1))
    X = rng.standard_normal((n, 3)).astype(np.float32) * 2
    Y = s * (X @ R.T) + t + rng.normal(size=(n, 3)).astype(np.float32) * .005
    Y[:n_out] += rng.uniform(0.5, 2, (n_out, 3)).astype(np.float32)
    return X, Y.astype(np.float32), R, t, s


def test_sim3_ransac_on_injected_samples_matches_jax():
    X, Y, R, t, s = _sim3_problem()
    mask = np.ones(len(X), bool)
    mask[-10:] = False
    g = torch.Generator()
    g.manual_seed(1)
    idx = draw_samples(t_(mask), 300, 3, g)
    Xj, Yj, mj = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask)
    Rs, ts, ss = jax.jit(jax.vmap(lambda i: jsim3.horn_sim3(
        Xj[i], Yj[i], jnp.ones(3, bool))))(jnp.asarray(np_(idx)))

    def score(R_, t_, s_):
        e = jsim3.sim3_apply(R_, t_, s_, Xj) - Yj
        inl = (jnp.sum(e * e, -1) < 0.05) & mj
        return jnp.sum(inl), inl

    counts, inls = jax.vmap(score)(Rs, ts, ss)
    Rw, tw, sw = jsim3.horn_sim3(Xj, Yj, inls[jnp.argmax(counts)])
    nw, inlw = score(Rw, tw, sw)
    Rg, tg, sg, inlg, ng = tsim3.sim3_ransac(t_(X), t_(Y), t_(mask),
                                             th_b=0.05, samples=idx)
    assert rot_angle_deg(Rg, Rw) < 0.01
    assert_close(tg, tw, atol=1e-3)
    assert abs(float(sg) - float(sw)) < 1e-3
    assert agree(inlg, inlw) >= 0.99 and int(ng) == int(nw)
    assert not np_(inlg)[:60].any() and np_(inlg)[60:-10].all()
    assert rot_angle_deg(Rg, R) < 0.1 and abs(float(sg) - s) < 2e-3


def test_edge_residual_jacobians_match_jax():
    rng = np.random.default_rng(4)
    args = []
    for _ in range(3):
        args += list(_rand_sim3s(rng, 12))
    got = tpg._res_and_jac(*[t_(a) for a in args])
    want = jax.jit(jpg._res_and_jac)(*[jnp.asarray(a) for a in args])
    for g, w in zip(got, want):
        assert_close(g, w, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_matches_jax(solver):
    """The drifted 16-node chain with its loop edge of
    tests/test_sim3_posegraph.py: node poses within 1e-4."""
    _, _, args = test_sim3_posegraph.TestPoseGraphCG._chain_problem(
        16, np.random.default_rng(5))
    targs = [t_(a) for a in args]
    if solver == "dense":
        want = jpg.optimize_pose_graph(*args, n_nodes=16, iters=15)
        got = tpg.optimize_pose_graph(*targs, n_nodes=16, iters=15)
    else:
        want = jpg.optimize_pose_graph_cg(*args, n_nodes=16, iters=8,
                                          cg_iters=40)
        got = tpg.optimize_pose_graph_cg(*targs, n_nodes=16, iters=8,
                                         cg_iters=40)
    for g, w in zip(got, want):
        assert_close(g, w, atol=1e-4, rtol=1e-4)
