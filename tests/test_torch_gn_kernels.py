"""The frame step's two Gauss-Newton loops against the JAX package, at the
inputs where a one-launch kernel would most likely part from them.

``backend/optim.py::pose_optimization`` and ``frontend/sparse_align.py::
sparse_image_align`` launch hand-written CUDA kernels (``csrc/pose_gn.cu``,
``csrc/sparse_align.cu``) on CUDA tensors and run their plain PyTorch
versions on CPU tensors. Here the dispatchers get CPU tensors made from the
same seeded numpy arrays as the JAX functions: stereo rows, no valid row,
one row, a ragged 1,500 rows, points behind the camera, the PnP polish's
gate; two levels of three iterations, points at the level borders, no
valid point. Then the dispatch itself: a CPU tensor launches nothing, a
tensor on any other device raises. ``tests/test_torch_cuda.py`` holds the
kernels to the plain versions on a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.backend import optim as jopt
from ygz_tpu.frontend.sparse_align import sparse_image_align as jax_sia
from ygz_tpu.ops import image as jimage
from ygz_tpu_torch.backend import optim as topt
from ygz_tpu_torch.frontend import sparse_align as tsa
from ygz_tpu_torch.ops import image as timage

from torch_gn_cases import (ALIGN_CASES, BF, H0, INTR, NO_VALID, POSE_CASES,
                            R_TRUE, W0, align_points, plane_frames,
                            pose_problem, singular)
from torch_parity import agree, assert_close, np_, rot_angle_deg, t_


@pytest.fixture(scope="module")
def frames():
    return plane_frames()


def _run_pose(p, kw):
    bf = BF if p["ur"] is not None else 0.0
    rj = jopt.pose_optimization(
        jnp.asarray(p["X"]), jnp.asarray(p["uv"]), jnp.asarray(p["is2"]),
        jnp.asarray(p["valid"]), jnp.asarray(p["R0"]), jnp.asarray(p["t0"]),
        INTR, ur=None if p["ur"] is None else jnp.asarray(p["ur"]), bf=bf,
        **kw)
    rt = topt.pose_optimization(
        t_(p["X"]), t_(p["uv"]), t_(p["is2"]), t_(p["valid"]), t_(p["R0"]),
        t_(p["t0"]), INTR, ur=None if p["ur"] is None else t_(p["ur"]),
        bf=bf, **kw)
    return rj, rt


@pytest.mark.parametrize("case", list(POSE_CASES))
def test_pose_gn_edge_cases_match_jax(case):
    spec, kw = POSE_CASES[case]
    p = pose_problem(**spec)
    rj, rt = _run_pose(p, kw)
    inl_j, inl_t = np.asarray(rj.inliers), np_(rt.inliers)
    if singular(spec):
        # H = 0: non-finite steps in both packages, no inlier
        assert not bool(torch.isfinite(rt.R).all())
        assert not np.isfinite(np.asarray(rj.R)).all()
        assert int(rt.n_inliers) == int(rj.n_inliers) == 0
        return
    if spec["n"] == 1:
        # one row fixes 2 of 6 degrees of freedom: the solve is rank-
        # deficient (the 1e-8 regulariser vanishes beside the scaled unit
        # diagonal in float32) and the pose follows rounding, in either
        # package. What is determined: the row is fitted and kept.
        assert inl_j.tolist() == inl_t.tolist() == [bool(p["valid"][0])]
        assert float(np_(rt.chi2)[0]) < 1e-3
        assert float(np.asarray(rj.chi2)[0]) < 1e-3
        return
    # 40 GN steps of a float32 6x6 system summed in another order: the
    # optimum agrees to ~1e-6 of the pose (test_torch_optim.py's bounds)
    assert rot_angle_deg(rt.R, rj.R) < 1e-3
    assert_close(rt.t, rj.t, atol=1e-4)
    # a row whose chi2 sits at its gate may flip
    assert agree(inl_t, inl_j) >= 0.99
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int(rt.n_inliers) == int(inl_t.sum())
    # chi2 at the final pose: rows behind the camera reach ~1e16 (z
    # clamped to 1e-6), so the bound is relative
    assert_close(rt.chi2, rj.chi2, atol=1e-2, rtol=1e-3)
    assert not inl_t[:p["n_out"]].any()
    if spec.get("behind"):
        assert not inl_t[-spec["behind"]:].any()
    assert rot_angle_deg(rt.R, R_TRUE) < 0.1


def test_pose_gn_no_valid_row_matches_jax():
    p = pose_problem(**NO_VALID)
    rj, rt = _run_pose(p, {})
    # H = 0: the solve gives non-finite steps in both packages, the pose is
    # carried out non-finite, and no row is an inlier
    fin_j = np.isfinite(np.asarray(rj.R)).all() and np.isfinite(
        np.asarray(rj.t)).all()
    fin_t = bool(torch.isfinite(rt.R).all() and torch.isfinite(rt.t).all())
    assert fin_t == fin_j
    assert int(rt.n_inliers) == int(rj.n_inliers) == 0
    assert not np_(rt.inliers).any()


def _align(frames, uv0, valid, levels, iters):
    scene, I0, I1, t1 = frames
    X = scene.backproject(np.eye(3), np.zeros(3), uv0).astype(np.float32)
    intr = (scene.f, scene.f, scene.cx, scene.cy)
    rj = jax_sia(jimage.build_pyramid(jnp.asarray(I0), 4),
                 jimage.build_pyramid(jnp.asarray(I1), 4), jnp.asarray(uv0),
                 jnp.asarray(X), jnp.asarray(valid), intr, jnp.eye(3),
                 jnp.zeros(3), levels=levels, iters=iters)
    # the previous frame's levels as the frame step passes them: views of
    # the stacked carry pyramid (row stride W0)
    ref = timage.unstack_pyramid(
        timage.stack_pyramid(timage.build_pyramid(t_(I0), 4)), 4)
    rt = tsa.sparse_image_align(ref, timage.build_pyramid(t_(I1), 4),
                                t_(uv0), t_(X), t_(valid), intr,
                                torch.eye(3), torch.zeros(3), levels=levels,
                                iters=iters)
    return rj, rt


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_sparse_align_edge_cases_match_jax(frames, case):
    spec = ALIGN_CASES[case]
    uv0, valid = align_points(**spec)
    rj, rt = _align(frames, uv0, valid, (2, 1), 3)
    # 6 GN steps of a float32 6x6 solve whose normal equations are summed
    # in another order: the motion agrees to ~1e-6 (the 30-step test in
    # test_torch_image_align.py asks 1e-4)
    assert_close(rt.R, rj.R, atol=1e-4)
    assert_close(rt.t, rj.t, atol=1e-4)
    # a point on the border line or at z = 0.1 may flip its visibility
    assert abs(int(rt.n_meas) - int(rj.n_meas)) <= 2
    assert_close(rt.mean_res, rj.mean_res, atol=1e-2)
    assert 0 < int(rt.n_meas) <= int(valid.sum())
    if spec["border"]:
        # the points outside the border cannot be measured
        assert int(rt.n_meas) < int(valid.sum())
    # and it tracked the motion (3 iterations on two levels: ~2 mm)
    assert_close(rt.t, frames[3], atol=5e-3)


def test_sparse_align_no_valid_point_matches_jax(frames):
    rng = np.random.default_rng(10)
    uv0 = rng.uniform(40, [W0 - 40, H0 - 40], (256, 2)).astype(np.float32)
    rj, rt = _align(frames, uv0, np.zeros(256, bool), (3, 2, 1), 10)
    # no measurement: H = 0, the pose goes non-finite in both (the frame
    # step drops it through n_meas), and the diagnostics are 0
    assert int(rt.n_meas) == int(rj.n_meas) == 0
    assert float(rt.mean_res) == float(rj.mean_res) == 0.0
    fin_j = bool(np.isfinite(np.asarray(rj.R)).all())
    assert bool(torch.isfinite(rt.R).all()) == fin_j


def test_cpu_tensors_launch_no_kernel(frames):
    p = pose_problem(seed=11, n=64)
    before = (topt.pose_optimization.launches,
              tsa.sparse_image_align.launches)
    res = topt.pose_optimization(t_(p["X"]), t_(p["uv"]), t_(p["is2"]),
                                 t_(p["valid"]), t_(p["R0"]), t_(p["t0"]),
                                 INTR)
    assert res.R.device.type == "cpu"
    uv0 = np.random.default_rng(12).uniform(
        40, [W0 - 40, H0 - 40], (64, 2)).astype(np.float32)
    _align(frames, uv0, np.ones(64, bool), (3,), 1)
    assert (topt.pose_optimization.launches,
            tsa.sparse_image_align.launches) == before


def test_other_devices_raise():
    meta = torch.device("meta")
    X = torch.zeros(8, 3, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        topt.pose_optimization(X, torch.zeros(8, 2, device=meta),
                               torch.ones(8, device=meta),
                               torch.ones(8, dtype=torch.bool, device=meta),
                               torch.eye(3, device=meta),
                               torch.zeros(3, device=meta), INTR)
    pyr = tuple(torch.zeros(480 >> k, 752 >> k, device=meta)
                for k in range(4))
    with pytest.raises(ValueError, match="unsupported device"):
        tsa.sparse_image_align(pyr, pyr, torch.zeros(8, 2, device=meta), X,
                               torch.ones(8, dtype=torch.bool, device=meta),
                               INTR, torch.eye(3, device=meta),
                               torch.zeros(3, device=meta))
    # CPU points with a pose elsewhere: refused before the plain version
    with pytest.raises(ValueError, match="inputs on different devices"):
        topt.pose_optimization(torch.zeros(8, 3), torch.zeros(8, 2),
                               torch.ones(8), torch.ones(8, dtype=torch.bool),
                               torch.eye(3, device=meta), torch.zeros(3),
                               INTR)
