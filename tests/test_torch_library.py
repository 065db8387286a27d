"""The torch port's library functions that no tracking path calls, each
against its JAX twin on the same seeded inputs: the Lie-group helpers and
quaternions, scale_camera, the image gradients and pyramid scales, the
descriptor bit packing, the robust scale estimators, the mapper's
bind_map_points, and the synthetic scene's terraced surface and camera
nuisances."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ygz_tpu.backend import optim as joptim
from ygz_tpu.backend.mapping import LocalMapper as JaxMapper
from ygz_tpu.geometry import camera as jcam
from ygz_tpu.geometry import lie as jlie
from ygz_tpu.ops import image as jimage
from ygz_tpu.ops import orb as jorb
from ygz_tpu.utils import synthetic as jsyn
from ygz_tpu_torch.backend import optim as toptim
from ygz_tpu_torch.backend.mapping import LocalMapper
from ygz_tpu_torch.backend.mapstate import SlamMap
from ygz_tpu_torch.geometry import camera as tcam
from ygz_tpu_torch.geometry import lie as tlie
from ygz_tpu_torch.ops import image as timage
from ygz_tpu_torch.ops import orb as torb
from ygz_tpu_torch.utils import synthetic as tsyn

from torch_parity import assert_close, np_, t_


def _rotvecs():
    """Axis-angle samples: generic angles, the small-angle branch, and
    rotations near pi about each axis (each Shepperd pivot)."""
    rng = np.random.default_rng(0)
    w = [rng.standard_normal(3) * s for s in (0.01, 0.3, 1.0, 2.0)
         for _ in range(4)]
    w += [rng.standard_normal(3) * 1e-5, np.zeros(3)]
    w += [np.eye(3)[i] * 3.0 + rng.standard_normal(3) * 0.05
          for i in range(3)]
    return np.asarray(w, np.float32)


def _jax_each(fn, *arrays):
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(len(arrays[0]))])


def test_lie_helpers_match_jax():
    """Within 1e-6 (float32 of O(1) entries)."""
    w = _rotvecs()
    assert_close(tlie.so3_right_jacobian_inv(t_(w)),
                 _jax_each(jlie.so3_right_jacobian_inv, w), atol=1e-6,
                 what="so3_right_jacobian_inv")
    R = np_(tlie.so3_exp(t_(w)))
    rng = np.random.default_rng(1)
    t = rng.standard_normal((len(w), 3)).astype(np.float32)
    X = rng.standard_normal((len(w), 7, 3)).astype(np.float32)
    Ri, ti = tlie.se3_inv(t_(R), t_(t))
    for i in range(len(w)):
        jR, jt = jlie.se3_inv(jnp.asarray(R[i]), jnp.asarray(t[i]))
        assert_close(Ri[i], jR, atol=1e-6, what="se3_inv R")
        assert_close(ti[i], jt, atol=1e-6, what="se3_inv t")
        assert_close(tlie.se3_apply(t_(R[i]), t_(t[i]), t_(X[i])),
                     jlie.se3_apply(jnp.asarray(R[i]), jnp.asarray(t[i]),
                                    jnp.asarray(X[i])), atol=1e-6,
                     what="se3_apply")
    assert_close(tlie.se3_matrix(t_(R), t_(t)),
                 _jax_each(jlie.se3_matrix, R, t), atol=0.0,
                 what="se3_matrix")


def test_quaternions_match_jax():
    """rotmat_to_quat over every Shepperd pivot and quat_to_rotmat, within
    1e-6; the round trip restores the rotation."""
    R = np_(tlie.so3_exp(t_(_rotvecs())))
    q = tlie.rotmat_to_quat(t_(R))
    assert_close(q, _jax_each(jlie.rotmat_to_quat, R), atol=1e-6,
                 what="rotmat_to_quat")
    rng = np.random.default_rng(2)
    qs = rng.standard_normal((12, 4)).astype(np.float32)
    assert_close(tlie.quat_to_rotmat(t_(qs)),
                 _jax_each(jlie.quat_to_rotmat, qs), atol=1e-6,
                 what="quat_to_rotmat")
    assert_close(tlie.quat_to_rotmat(q), R, atol=1e-6, what="round trip")
    # float64, as the trajectory writers call it
    q64 = tlie.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float64))
    assert q64.dtype == torch.float64
    assert_close(q64, q, atol=1e-6)


def test_scale_camera_matches_jax():
    dist = np.array([-0.28, 0.07, 1.9e-4, 1.8e-5], np.float32)
    for scale in (0.5, 0.25, 1.0 / 3.0):
        got = tcam.scale_camera(tcam.Camera.make(458.654, 457.296, 367.215,
                                                 248.375, 752, 480, dist,
                                                 bf=47.9), scale)
        want = jcam.scale_camera(jcam.Camera.make(458.654, 457.296, 367.215,
                                                  248.375, 752, 480, dist,
                                                  bf=47.9), scale)
        for name in ("fx", "fy", "cx", "cy", "bf"):
            assert abs(getattr(got, name) - float(getattr(want, name))) \
                < 1e-6 * abs(float(getattr(want, name))) + 1e-6, name
        assert (got.width, got.height) == (want.width, want.height)
        assert_close(got.dist, np.asarray(want.dist), atol=0.0)


def test_gradients_and_pyramid_scales_match_jax():
    img = np.random.default_rng(3).uniform(0, 255, (37, 53)).astype(
        np.float32)
    for got, want in zip(timage.gradients(t_(img)),
                         jimage.gradients(jnp.asarray(img))):
        assert_close(got, want, atol=1e-6)
    for n, s in ((4, 2.0), (8, 1.2), (1, 2.0)):
        assert timage.pyramid_scales(n, s) == jimage.pyramid_scales(n, s)


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (19, 256)).astype(np.uint8)
    packed = torb.pack_bits(t_(bits))
    assert packed.dtype == torch.uint8 and packed.shape == (19, 32)
    np.testing.assert_array_equal(np_(packed),
                                  np.asarray(jorb.pack_bits(
                                      jnp.asarray(bits))))
    np.testing.assert_array_equal(np_(torb.unpack_bits(packed)), bits)
    np.testing.assert_array_equal(
        np_(torb.unpack_bits(packed)),
        np.asarray(jorb.unpack_bits(jnp.asarray(np_(packed)))))


@pytest.mark.parametrize("n_valid", [0, 1, 2, 57, 200])
def test_robust_scales_match_jax(n_valid):
    """Within 1e-5 relative; an empty selection gives the JAX values."""
    rng = np.random.default_rng(5 + n_valid)
    res = (rng.standard_t(4, 200) * 1.7).astype(np.float32)
    valid = np.zeros(200, bool)
    valid[rng.permutation(200)[:n_valid]] = True
    for name in ("mad_scale", "normal_scale", "tdist_scale"):
        got = float(getattr(toptim, name)(t_(res), t_(valid)))
        want = float(getattr(joptim, name)(jnp.asarray(res),
                                           jnp.asarray(valid)))
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-30, \
            (name, got, want)


def _fusion_map():
    """Three keyframes over 40 landmarks: the newest binds 25 of them,
    leaves 10 features unbound, and binds 5 to duplicate landmarks (same
    position and descriptor) with fewer observations."""
    rng = np.random.default_rng(6)
    n = 40
    X = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                  rng.uniform(4, 6, n)], 1).astype(np.float32)
    desc = (rng.random((n, 256)) > 0.5).astype(np.uint8)
    m = SlamMap(max_kf=8, max_pt=128, max_feat=64)
    eye = np.eye(3, dtype=np.float32)
    kfs = []
    for k in range(3):
        t = np.array([0.08 * k, 0.01 * k, 0.0], np.float32)
        Xc = X + t
        uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 320,
                       400 * Xc[:, 1] / Xc[:, 2] + 240], -1)
        kfs.append(m.add_keyframe(eye, t, {
            "uv": uv.astype(np.float32), "level": np.zeros(n, np.int32),
            "angle": np.zeros(n, np.float32), "desc": desc,
            "valid": np.ones(n, bool)}))
    ids = m.alloc_points(n)
    m.pt_xyz[ids] = X
    m.pt_valid[ids] = True
    m.pt_desc[ids] = desc
    m.bind(kfs[0], np.arange(n), ids)
    m.bind(kfs[1], np.arange(n), ids)
    m.bind(kfs[2], np.arange(25), ids[:25])
    dup = m.alloc_points(5)
    m.pt_xyz[dup] = X[35:]
    m.pt_valid[dup] = True
    m.pt_desc[dup] = desc[35:]
    m.bind(kfs[2], np.arange(35, 40), dup)
    return m, kfs[2], ids, dup


def test_bind_map_points_matches_jax():
    """The same bindings and fusions on the same map."""
    m, kf, ids, dup = _fusion_map()
    a, b = copy.deepcopy(m), copy.deepcopy(m)
    cam = tcam.Camera.make(400.0, 400.0, 320.0, 240.0, 640, 480)
    jc = jcam.Camera.make(400.0, 400.0, 320.0, 240.0, 640, 480)
    got = LocalMapper(cam, device="cpu").bind_map_points(a, kf)
    want = JaxMapper(jc).bind_map_points(b, kf)
    assert got == want == 15
    for name in ("pt_valid", "kf_feat_pt", "pt_obs", "pt_xyz"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    # the 10 unbound features bound, the 5 duplicates fused into the
    # stronger originals
    np.testing.assert_array_equal(a.kf_feat_pt[kf, :40], ids)
    assert not a.pt_valid[dup].any()


def test_step_scene_and_nuisance_match_jax():
    """step_depth, StepScene.render and Nuisance.apply bit for bit over 8
    frames (the JAX scene rendered on its numpy route)."""
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-5, 5, (2, 1000))
    np.testing.assert_array_equal(tsyn.step_depth(x, y),
                                  jsyn.step_depth(x, y))
    kw = dict(seed=5, w=96, h=72, f=80.0, tex_size=400)
    ts, js = tsyn.StepScene(**kw), jsyn.StepScene(**kw)
    tn = tsyn.Nuisance(seed=9, blur_p=0.5)
    jn = jsyn.Nuisance(seed=9, blur_p=0.5)
    for i in range(8):
        R = np_(tlie.so3_exp(torch.tensor([0.0, 0.02 * i, 0.0])))
        t = np.array([-0.1 * i, 0.0, 0.0], np.float32)
        img = ts.render(R, t)
        np.testing.assert_array_equal(img, js.render(R, t, backend="numpy"))
        np.testing.assert_array_equal(tn.apply(img, i), jn.apply(img, i))
