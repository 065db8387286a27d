"""Image ops, patch alignment and sparse image alignment of the torch port
against the JAX reference, on the same seeded inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.ops import align as jalign, image as jimage
from ygz_tpu.frontend.sparse_align import sparse_image_align as jax_sia
from ygz_tpu_torch.ops import align as talign, image as timage
from ygz_tpu_torch.frontend.sparse_align import sparse_image_align
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.utils.synthetic import PlaneScene

from torch_parity import agree, assert_close, np_, render_u8, t_

H, W = 240, 320


@pytest.fixture(scope="module")
def frames():
    scene = PlaneScene(seed=5, w=W, h=H, f=200.0, tex_size=800)
    R1 = np_(so3_exp(t_(np.array([0.01, -0.02, 0.0], np.float32))))
    t1 = np.array([0.04, 0.015, 0.01], np.float32)
    I0 = render_u8(scene, np.eye(3), np.zeros(3))
    I1 = render_u8(scene, R1, t1)
    return scene, I0, I1, R1, t1


def test_pyramid_blur_stack_roundtrip(frames):
    _, I0, _, _, _ = frames
    pj = jimage.build_pyramid(jnp.asarray(I0), 4)
    pt = timage.build_pyramid(t_(I0), 4)
    for a, b in zip(pj, pt):
        # halving an integer image: every level's sums are exact in f32
        np.testing.assert_array_equal(np.asarray(a), np_(b))
    stack = timage.stack_pyramid(pt)
    np.testing.assert_array_equal(np_(stack),
                                  np.asarray(jimage.stack_pyramid(pj)))
    for a, b in zip(pt, timage.unstack_pyramid(stack, 4)):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert timage.infer_height(stack.shape[0], W, 4) == H
    # separable blur: 14 products summed in a different association order
    # than XLA's convolution; 1e-4 of a 0..255 range is float32 rounding
    for lvl in range(4):
        assert_close(timage.gaussian_blur(pt[lvl].contiguous(), 7, 2.0),
                     jimage.gaussian_blur(pj[lvl], 7, 2.0), atol=1e-4)
    with pytest.raises(NotImplementedError):
        timage.build_pyramid(t_(I0), 4, scale_factor=1.2)


def test_extract_patches_and_pyramid_dispatch_match_jax(frames):
    _, I0, _, _, _ = frames
    from ygz_tpu.frontend.framestep import build_pyramid_dispatch as jbpd
    from ygz_tpu_torch.frontend.framestep import build_pyramid_dispatch as tbpd
    # an integer image halved: the level tuple is exact
    for a, b in zip(jbpd(jnp.asarray(I0), None, 4), tbpd(t_(I0), None, 4)):
        np.testing.assert_array_equal(np_(b), np.asarray(a))
    rng = np.random.default_rng(6)
    # centres anywhere, edges included: both clamp them into the image
    uv = rng.uniform(-5, [W + 5, H + 5], (100, 2)).astype(np.float32)
    for half in (3, 15):
        # an integer gather: exact
        np.testing.assert_array_equal(
            np_(timage.extract_patches(t_(I0), t_(uv), half)),
            np.asarray(jimage.extract_patches(jnp.asarray(I0),
                                              jnp.asarray(uv), half)))
    # a 31-px patch on a 30-row level (C7): refused, as JAX refuses it
    with pytest.raises(ValueError):
        timage.extract_patches(t_(I0[:30]), t_(uv), 15)


def test_sample_patches_incl_level_edges(frames):
    """Patches from the stacked pyramid, including points within 6 px of a
    level's right and bottom edges, where the shared-fraction gather clamps
    to the stacked width W0 and bleeds into the next level (C-ref1)."""
    _, I0, _, _, _ = frames
    stack = np.asarray(jimage.stack_pyramid(jimage.build_pyramid(
        jnp.asarray(I0), 4)))
    offs, _ = jimage.stack_rows(H, W, 4)
    rng = np.random.default_rng(1)
    uv = [rng.uniform([0, 0], [W, stack.shape[0]], (200, 2))]
    for lvl, (h, w) in enumerate(jimage.pyramid_shapes(H, W, 4)):
        edge = np.stack([rng.uniform(w - 6, w, 20),
                         offs[lvl] + rng.uniform(0, h, 20)], 1)
        bottom = np.stack([rng.uniform(0, w, 20),
                           offs[lvl] + rng.uniform(h - 6, h, 20)], 1)
        uv += [edge, bottom]
    uv = np.concatenate(uv).astype(np.float32)
    for size in (6, 10, 20):
        # same float ops in the same order: exact
        np.testing.assert_array_equal(
            np_(talign.sample_patches(t_(stack), t_(uv), size)),
            np.asarray(jalign.sample_patches(jnp.asarray(stack),
                                             jnp.asarray(uv), size)))


def test_align2d_stacked_matches_jax(frames):
    scene, I0, I1, R1, t1 = frames
    pj1 = jimage.build_pyramid(jnp.asarray(I1), 4)
    stack1 = np.asarray(jimage.stack_pyramid(pj1))
    rng = np.random.default_rng(2)
    n = 256
    uv0 = rng.uniform(30, [W - 30, H - 30], (n, 2)).astype(np.float32)
    Xw = scene.backproject(np.eye(3), np.zeros(3), uv0)
    uv1, _ = scene.project(R1, t1, Xw)
    lvl = rng.integers(0, 3, n).astype(np.int32)
    offs, _ = jimage.stack_rows(H, W, 4)
    shapes = jimage.pyramid_shapes(H, W, 4)
    s = 0.5 ** lvl[:, None]
    ref = np.asarray(jimage.stack_pyramid(jimage.build_pyramid(
        jnp.asarray(I0), 4)))
    uv0_l = ((uv0 + 0.5) * s - 0.5).astype(np.float32)
    ref_border = np.asarray(jalign.sample_patches(
        jnp.asarray(ref), jnp.asarray(uv0_l + np.stack(
            [np.zeros(n), np.take(offs, lvl)], 1).astype(np.float32)), 10))
    init = ((uv1 + 0.5) * s - 0.5 + rng.uniform(-1.5, 1.5, (n, 2))
            ).astype(np.float32)
    row_off = np.take(offs, lvl).astype(np.int32)
    h_l = np.array([shapes[k][0] for k in lvl], np.int32)
    w_l = np.array([shapes[k][1] for k in lvl], np.int32)
    valid = np.ones(n, bool)
    uj, okj, mj = jalign.align2d_stacked(
        jnp.asarray(stack1), jnp.asarray(ref_border), jnp.asarray(init),
        jnp.asarray(valid), jnp.asarray(row_off), jnp.asarray(w_l),
        jnp.asarray(h_l))
    ut, okt, mt = talign.align2d_stacked(
        t_(stack1), t_(ref_border), t_(init), t_(valid), t_(row_off),
        t_(w_l), t_(h_l))
    okj, okt = np.asarray(okj), np_(okt)
    # the convergence test compares a float32 step with 0.03 px: a point at
    # the threshold may flip, so masks agree to >= 99%, not exactly
    assert agree(okj, okt) >= 0.99
    assert okj.sum() > 0.6 * n
    both = okj & okt
    # 10 IC iterations of float32 3x3 solves in another summation order:
    # positions agree to 1e-3 px (the KLT converges to 0.03 px steps)
    assert_close(np_(ut)[both], np.asarray(uj)[both], atol=1e-3)
    assert_close(np_(mt)[both], np.asarray(mj)[both], atol=1e-2)


def test_sparse_image_align_matches_jax(frames):
    scene, I0, I1, R1, t1 = frames
    rng = np.random.default_rng(3)
    n = 300
    uv0 = rng.uniform(20, [W - 20, H - 20], (n, 2)).astype(np.float32)
    X = scene.backproject(np.eye(3), np.zeros(3), uv0)
    valid = rng.random(n) > 0.1
    intr = (scene.f, scene.f, scene.cx, scene.cy)
    pj0 = jimage.build_pyramid(jnp.asarray(I0), 4)
    pj1 = jimage.build_pyramid(jnp.asarray(I1), 4)
    rj = jax_sia(pj0, pj1, jnp.asarray(uv0), jnp.asarray(X),
                 jnp.asarray(valid), intr, jnp.eye(3), jnp.zeros(3))
    pt0 = timage.build_pyramid(t_(I0), 4)
    pt1 = timage.build_pyramid(t_(I1), 4)
    rt = sparse_image_align(pt0, pt1, t_(uv0), t_(X), t_(valid), intr,
                            torch.eye(3), torch.zeros(3))
    # 30 GN iterations of a float32 6x6 solve whose normal equations are
    # summed in another order: the optimum agrees to ~1e-5 of the motion
    assert_close(rt.R, rj.R, atol=1e-4)
    assert_close(rt.t, rj.t, atol=1e-4)
    assert abs(int(rt.n_meas) - int(rj.n_meas)) <= 2
    assert_close(rt.mean_res, rj.mean_res, atol=1e-2)
    # and it actually tracked the motion
    assert_close(rt.t, t1, atol=5e-3)


def test_align2d_and_affine_warps_match_jax(frames):
    scene, I0, I1, R1, t1 = frames
    rng = np.random.default_rng(4)
    n = 128
    uv0 = rng.uniform(40, [W - 40, H - 40], (n, 2)).astype(np.float32)
    X = scene.backproject(np.eye(3), np.zeros(3), uv0)
    uv1, _ = scene.project(R1, t1, X)
    intr = (scene.f, scene.f, scene.cx, scene.cy)
    args = (X, uv0, *intr, R1, t1, *intr)
    Aj = jalign.affine_warp_matrix(*(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args))
    At = talign.affine_warp_matrix(*(t_(a) if isinstance(a, np.ndarray)
                                     else a for a in args))
    # finite differences of float32 projections over d = 5 px
    assert_close(At, Aj, atol=1e-4)
    np.testing.assert_array_equal(np_(talign.best_search_level(At, 3)),
                                  np.asarray(jalign.best_search_level(Aj, 3)))
    A_rc = np.linalg.inv(np.asarray(Aj)).astype(np.float32)
    ref_j = jalign.warp_affine_patches(jnp.asarray(I0), jnp.asarray(uv0),
                                       jnp.asarray(A_rc), 10)
    ref_t = talign.warp_affine_patches(t_(I0), t_(uv0), t_(A_rc), 10)
    # the same bilinear formula; XLA may contract a multiply-add (1 ulp)
    assert_close(ref_t, ref_j, atol=1e-3)
    init = (uv1 + rng.uniform(-1.5, 1.5, (n, 2))).astype(np.float32)
    valid = np.ones(n, bool)
    uj, okj, _ = jalign.align2d(jnp.asarray(I1), ref_j, jnp.asarray(init),
                                jnp.asarray(valid))
    ut, okt, _ = talign.align2d(t_(I1), ref_t, t_(init), t_(valid))
    # convergence at the 0.03 px step test may flip for one point
    assert agree(okt, okj) >= 0.99
    both = np_(okt) & np.asarray(okj)
    assert both.sum() > 0.7 * n
    assert_close(np_(ut)[both], np.asarray(uj)[both], atol=1e-3)


def test_camera_matches_jax():
    from ygz_tpu.geometry import camera as jcam
    from ygz_tpu_torch.geometry import camera as tcam

    dist = [-0.28, 0.07, 2e-4, 1.8e-5]          # EuRoC cam0 radtan
    cj = jcam.Camera.make(458.654, 457.296, 367.215, 248.375, 752, 480, dist)
    ct = tcam.Camera.make(458.654, 457.296, 367.215, 248.375, 752, 480, dist)
    assert ct.has_distortion
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50),
                  rng.uniform(2, 6, 50)], 1).astype(np.float32)
    uv = rng.uniform(50, [700, 430], (50, 2)).astype(np.float32)
    # float32 polynomial distortion evaluated in the same order
    for fj, ft in ((jcam.project, tcam.project),
                   (jcam.project_ideal, tcam.project_ideal)):
        assert_close(ft(ct, t_(X)), fj(cj, jnp.asarray(X)), atol=1e-3)
    assert_close(tcam.undistort_points(ct, t_(uv)),
                 jcam.undistort_points(cj, jnp.asarray(uv)), atol=1e-3)
    assert_close(tcam.unproject(ct, t_(uv), t_(X[:, 2])),
                 jcam.unproject(cj, jnp.asarray(uv), jnp.asarray(X[:, 2])),
                 atol=1e-5)
    mu_j, mv_j = jcam.undistort_remap_grid(cj)
    mu_t, mv_t = tcam.undistort_remap_grid(ct)
    assert_close(mu_t, mu_j, atol=1e-3)
    assert_close(mv_t, mv_j, atol=1e-3)
    # the remapped (undistorted) image and its pyramid, as the frame step
    # builds them
    rng_img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    from ygz_tpu.frontend.framestep import build_pyramid_stacked as jbps
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked as tbps
    sj = jbps(jnp.asarray(rng_img), jnp.stack([mu_j, mv_j]), 4)
    st = tbps(t_(rng_img), torch.stack([mu_t, mv_t]), 4)
    # bilinear remap at grid points that agree to 1e-3 px of a noise image
    assert np.median(np.abs(np_(st) - np.asarray(sj))) < 0.5
