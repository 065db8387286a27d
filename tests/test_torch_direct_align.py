"""The direct tracker's per-point work against the JAX package, at the
inputs where a one-warp-per-point kernel would most likely part from it.

``frontend/direct_tracker.py::track_local_map_direct`` and
``refine_matches_core`` launch the hand-written CUDA kernel
``csrc/direct_align.cu`` on CUDA tensors and run their plain PyTorch
versions on CPU tensors. Here the dispatchers (and ``ops/align.py::
align2d_stacked``, the plain version's KLT) get CPU tensors made from the
same seeded numpy arrays as the JAX functions (``torch_direct_cases.py``):
points at each level's border and at the stacked buffer's clamp (C-ref1), a
NaN patch, no valid point, one point, a ragged 1,500, points that never
converge, points behind the camera. Then the dispatch itself: a CPU tensor
launches nothing, a tensor on any other device raises.
``tests/test_torch_cuda.py`` holds the kernel to the plain version on a
card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.frontend import direct_tracker as jdt
from ygz_tpu.ops import align as jalign
from ygz_tpu.ops.image import as_levels
from ygz_tpu_torch.frontend import direct_tracker as tdt
from ygz_tpu_torch.ops import align as talign
from ygz_tpu_torch.ops.image import pyramid_shapes, stack_rows

from torch_direct_cases import (CASES, INTR, N_LEVELS, R_CUR, R_PRED, T_CUR,
                                T_PRED, direct_case, scene_frames)
from torch_parity import agree, assert_close, np_, rot_angle_deg, t_

H0 = 480


def _case(case):
    spec = CASES[case]
    return spec, direct_case(**spec)


def _special(spec, n):
    """Rows no package may align: a NaN or a noise patch, behind the
    camera, not valid."""
    _, pts = spec
    X, valid, patch = pts[0], pts[1], pts[2]
    flat = patch.reshape(n, -1)
    noise = (np.abs(flat - 128.0) <= 0.05).all(1)
    return (~valid | np.isnan(flat).any(1) | noise | (X[:, 2] < 0))


def _level_px(uv_a, uv_b, level):
    """|uv_a - uv_b| at each point's search level."""
    return np.abs(np_(uv_a) - np_(uv_b)).max(1) / 2.0 ** np_(level)


@pytest.mark.parametrize("case", list(CASES))
def test_align2d_stacked_edge_cases_match_jax(case):
    """The batched IC-KLT alone, on the case's warped patches (the plain
    setup's) from the predicted pose."""
    spec, pts = _case(case)
    _, stack, _ = scene_frames()
    n = len(pts[0])
    vis, lvl, warped, wok = tdt._warp_setup(
        H0, stack.shape[1], t_(R_PRED), t_(T_PRED), *(t_(a) for a in pts),
        INTR, N_LEVELS)
    lvl = np_(lvl)
    uvp, z = tdt._project(t_(pts[0]), t_(R_PRED), t_(T_PRED), INTR)
    sel = np_(vis) & np_(wok)
    scale = 0.5 ** lvl[:, None]
    uv_l = ((np_(uvp) + 0.5) * scale - 0.5).astype(np.float32)
    offs, _ = stack_rows(H0, stack.shape[1], N_LEVELS)
    shapes = pyramid_shapes(H0, stack.shape[1], N_LEVELS)
    row_off = np.take(offs, lvl).astype(np.int32)
    h_l = np.array([shapes[k][0] for k in lvl], np.int32)
    w_l = np.array([shapes[k][1] for k in lvl], np.int32)
    warped = np_(warped)
    uj, okj, mj = jalign.align2d_stacked(
        *(jnp.asarray(a) for a in (stack, warped, uv_l, sel, row_off, w_l,
                                   h_l)))
    ut, okt, mt = talign.align2d_stacked(
        *(t_(a) for a in (stack, warped, uv_l, sel, row_off, w_l, h_l)))
    okj, okt = np.asarray(okj), np_(okt)
    # the convergence test compares a float32 step with 0.03 px: a point at
    # the threshold may flip
    assert agree(okj, okt) >= 0.99
    assert not okt[_special((spec, pts), n)].any()
    assert not okj[_special((spec, pts), n)].any()
    if case in ("main", "level_borders", "ragged_1500"):
        # half the border points lie outside the 20-px selection
        assert okt.sum() > (0.25 if case == "level_borders" else 0.5) * n
        # every level is searched
        assert set(lvl[okt].tolist()) == {0, 1, 2, 3}
    both = okj & okt
    # 10 IC steps of float32 3x3 solves summed in another order
    assert_close(np_(ut)[both], np.asarray(uj)[both], atol=1e-3)
    assert_close(np_(mt)[both], np.asarray(mj)[both], atol=1e-2)


def _run_track(pts, stack):
    # the JAX tracker takes the level tuple (its refine takes either)
    rj = jdt.track_local_map_direct(
        as_levels(jnp.asarray(stack), N_LEVELS), jnp.asarray(R_PRED),
        jnp.asarray(T_PRED),
        *(jnp.asarray(a) for a in pts), INTR, n_levels=N_LEVELS)
    rt = tdt.track_local_map_direct(
        t_(stack), t_(R_PRED), t_(T_PRED), *(t_(a) for a in pts), INTR,
        n_levels=N_LEVELS)
    return rj, rt


@pytest.mark.parametrize("case", list(CASES))
def test_track_local_map_direct_edge_cases_match_jax(case):
    spec, pts = _case(case)
    _, stack, _ = scene_frames()
    n = len(pts[0])
    rj, rt = _run_track(pts, stack)
    assert rt.R.device.type == "cpu"
    al_j, al_t = np.asarray(rj.aligned), np_(rt.aligned)
    vis_t = np_(rt.visible)
    # a point on the border line or at z = 0.1 may flip its visibility; the
    # level is a ceil of log2 |det|, equal but on a level boundary (points
    # behind the camera project through z clamped to 1e-6: their warp is
    # rounding noise and their level too)
    assert agree(vis_t, np.asarray(rj.visible)) >= 0.99
    assert agree(np_(rt.level)[vis_t], np.asarray(rj.level)[vis_t]) >= 0.99
    assert agree(al_t, al_j) >= 0.99
    assert agree(np_(rt.tracked), np.asarray(rj.tracked)) >= 0.99
    assert not al_t[_special((spec, pts), n)].any()
    both = al_j & al_t
    # the warped patch by direct gather against the reference's hat-weight
    # matmuls, then 10 float32 KLT steps: 2e-3 px at the search level (the
    # median is ~4e-6); a point whose last step sits at the 0.03-px test
    # stops one step earlier or later in one package (2 of 1,182 here)
    d = _level_px(rt.uv, rj.uv, rt.level)[both]
    assert (d < 2e-3).mean() >= 0.99 if len(d) else True
    assert (d < 0.1).all()
    n_al = int(al_t.sum())
    if n_al < 8:
        # no point (or one) to fix the pose: the GN's normal equations are
        # singular in both packages, and nothing is tracked
        assert int(rt.n_inliers) == int(rj.n_inliers) <= 1
        return
    # 2 x 40 GN steps of a float32 6x6 system over positions that agree to
    # ~1e-3 px
    assert rot_angle_deg(rt.R, rj.R) < 1e-3
    assert_close(rt.t, rj.t, atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= max(2, n // 100)
    # and it found the true pose from the predicted one
    assert rot_angle_deg(rt.R, R_CUR) < 0.05
    assert_close(rt.t, T_CUR, atol=5e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_refine_matches_core_edge_cases_match_jax(case):
    spec, pts = _case(case)
    _, stack, _ = scene_frames()
    n = len(pts[0])
    uj, okj = jdt.refine_matches_direct(
        jnp.asarray(stack), jnp.asarray(R_CUR), jnp.asarray(T_CUR),
        *(jnp.asarray(a) for a in pts), INTR, n_levels=N_LEVELS)
    ut, okt = tdt.refine_matches_core(
        t_(stack), t_(R_CUR), t_(T_CUR), *(t_(a) for a in pts), INTR,
        n_levels=N_LEVELS)
    okj, okt = np.asarray(okj), np_(okt)
    assert agree(okt, okj) >= 0.99
    assert not okt[_special((spec, pts), n)].any()
    if case in ("main", "ragged_1500", "one_point"):
        assert okt.sum() > 0.5 * n
    both = okj & okt
    # every point's level where the case is built: 2e-3 px at level 0 is
    # what test_torch_mapping.py asks of the same comparison
    lvl = np_(tdt._warp_setup(
        H0, stack.shape[1], t_(R_CUR), t_(T_CUR), *(t_(a) for a in pts),
        INTR, N_LEVELS)[1])
    assert (_level_px(ut, uj, lvl)[both] < 2e-3).all()


def test_cpu_tensors_launch_no_kernel():
    _, pts = _case("one_point")
    _, stack, _ = scene_frames()
    before = tdt.direct_align.launches
    res = tdt.track_local_map_direct(
        t_(stack), t_(R_PRED), t_(T_PRED), *(t_(a) for a in pts), INTR)
    uv, ok = tdt.refine_matches_core(
        t_(stack), t_(R_CUR), t_(T_CUR), *(t_(a) for a in pts), INTR)
    assert res.uv.device.type == uv.device.type == "cpu"
    assert tdt.direct_align.launches == before


def test_other_devices_raise():
    meta = torch.device("meta")
    n = 8
    pts = (torch.zeros(n, 3, device=meta),
           torch.ones(n, dtype=torch.bool, device=meta),
           torch.zeros(n, 20, 20, device=meta),
           torch.zeros(n, 2, device=meta),
           torch.zeros(n, dtype=torch.int32, device=meta),
           torch.zeros(n, 3, 3, device=meta), torch.zeros(n, 3, device=meta))
    stack = torch.zeros(900, 752, device=meta)
    eye, zero = torch.eye(3, device=meta), torch.zeros(3, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tdt.track_local_map_direct(stack, eye, zero, *pts, INTR)
    with pytest.raises(ValueError, match="unsupported device"):
        tdt.refine_matches_core(stack, eye, zero, *pts, INTR)
    with pytest.raises(ValueError, match="unsupported device"):
        tdt.direct_align(stack, 480, pts, INTR, eye, zero)
