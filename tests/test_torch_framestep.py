"""The fused frame step, the torch port against the JAX reference: both
start from the same carry and direct-tracking cache (built once from a
synthetic map and carried across through ygz_tpu_torch.interop) and then
chain their own carries over consecutive frames."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ygz_tpu.frontend import framestep as jfs
from ygz_tpu.frontend.direct_tracker import capture_ref_patches
from ygz_tpu.ops.image import build_pyramid
from ygz_tpu_torch import interop
from ygz_tpu_torch.frontend import framestep as tfs
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import agree, np_, render_u8, rot_angle_deg, t_

H, W, F = 240, 320, 200.0
CAP = 256
N_FRAMES = 8


def _pose(i):
    w = np.array([0.015 * np.sin(i * 0.09 + 1.0), 0.03 * np.sin(i * 0.15),
                  0.0], np.float32)
    R = np_(so3_exp(t_(w)))
    c = np.array([0.02 * i, 0.1 * np.sin(i * 0.1), 0.0], np.float32)
    return R, (-R @ c).astype(np.float32)


@pytest.fixture(scope="module")
def sequence():
    scene = SmoothScene(seed=11, w=W, h=H, f=F, tex_size=1200)
    frames = [render_u8(scene, *_pose(i)) for i in range(N_FRAMES + 1)]
    rng = np.random.default_rng(0)
    n = 200
    lvl = rng.integers(0, 3, n).astype(np.int32)
    margin = 12.0 * 2.0 ** lvl[:, None]
    uv = (margin + rng.random((n, 2)) * ([W, H] - 2 * margin)).astype(
        np.float32)
    R0, t0 = _pose(0)
    X = scene.backproject(R0, t0, uv)
    pyr0 = build_pyramid(jnp.asarray(frames[0]), 4)
    patch = np.asarray(capture_ref_patches(pyr0, jnp.asarray(uv),
                                           jnp.asarray(lvl)))

    def pad(a):
        return np.concatenate([a, np.zeros((CAP - n,) + a.shape[1:],
                                           a.dtype)])

    cache = jfs.pack_cache_np(
        pad(X), pad(np.ones(n, bool)), pad(patch), pad(uv), pad(lvl),
        pad(np.tile(R0, (n, 1, 1))), pad(np.tile(t0, (n, 1))))
    Xc = X @ R0.T + t0
    carry = jfs.make_carry(pyr0, R0, t0, pad(uv), pad(Xc),
                           pad(np.ones(n, bool)))
    return frames, cache, carry


def test_interop_and_packing_roundtrip(sequence):
    _, cache, carry = sequence
    tc = interop.carry_from_numpy(*(np.asarray(a) for a in carry))
    np.testing.assert_array_equal(np_(tc.pyr), np.asarray(carry.pyr))
    np.testing.assert_array_equal(np_(tc.pts), np.asarray(carry.pts))
    cj = jfs.unpack_cache(jnp.asarray(cache))
    ct = tfs.unpack_cache(interop.cache_from_numpy(cache))
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    assert tfs.CACHE_COLS == jfs.CACHE_COLS == 419
    assert tfs.N_SCALARS == jfs.N_SCALARS == 29
    with pytest.raises(ValueError):
        interop.cache_from_numpy(cache[:, :100])
    np.testing.assert_array_equal(tfs.pack_pred_np(), jfs.pack_pred_np())


def test_frame_step_matches_jax_over_frames(sequence):
    frames, cache, carry = sequence
    intr = (F, F, W / 2.0 - 0.5, H / 2.0 - 0.5)
    cj = carry
    ct = interop.carry_from_numpy(*(np.asarray(a) for a in carry))
    cache_j = jnp.asarray(cache)
    cache_t = interop.cache_from_numpy(cache)
    pred = jfs.pack_pred_np()
    for i in range(1, N_FRAMES + 1):
        img = frames[i].astype(np.uint8)
        cj, pj = jfs.frame_step(jnp.asarray(img), cj, cache_j,
                                jnp.asarray(pred), None, intr)
        ct, pt = tfs.frame_step(torch.as_tensor(img), ct, cache_t,
                                t_(pred), None, intr)
        oj = jfs.unpack_out(np.asarray(pj), CAP)
        ot = tfs.unpack_out(np_(pt), CAP)
        # pose: both chains converge on the same optimum of a float32 GN
        # whose sums run in another order; a KLT point flipping at its
        # 0.03 px convergence test moves it by ~1e-5, so 1e-3 deg / 1e-4
        # leave an order of margin
        assert rot_angle_deg(ot.R, oj.R) < 1e-3, i
        np.testing.assert_allclose(ot.t, oj.t, atol=1e-4, err_msg=str(i))
        assert rot_angle_deg(ot.R_pred, oj.R_pred) < 1e-3, i
        assert ot.align_ok == oj.align_ok
        assert agree(ot.tracked, oj.tracked) >= 0.99, i
        assert agree(ot.visible, oj.visible) >= 0.99, i
        assert agree(ot.level, oj.level) >= 0.99, i
        both = ot.tracked & oj.tracked
        np.testing.assert_allclose(ot.uv[both], oj.uv[both], atol=2e-2)
        assert ot.n_inliers > 60
        # and the step tracks the true motion
        R_true, t_true = _pose(i)
        assert rot_angle_deg(ot.R, R_true) < 0.2
        np.testing.assert_allclose(ot.t, t_true, atol=1e-2)
