"""The port's hand-written CUDA kernels against their plain PyTorch versions,
and the numerics of the later slices (RANSACs, IMU preintegration, the
NavState pair optimization) against the same on the CPU, on a card.
Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Without a CUDA device every test skips."""
import numpy as np
import pytest
import torch

from ygz_tpu_torch.ops import fast
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import render_u8

# the main path's pyramid levels (EuRoC 752x480, 4 levels, factor 2) and
# ragged shapes that leave partial tiles on both axes
SHAPES = [(480, 752), (240, 376), (120, 188), (60, 94), (101, 137), (7, 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_fast_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    imgs = [rng.uniform(0, 255, shape).astype(np.float32),
            rng.integers(0, 256, shape).astype(np.float32)]
    if shape == SHAPES[0]:
        scene = SmoothScene(seed=11, w=shape[1], h=shape[0], f=458.0,
                            tex_size=2000)
        imgs.append(render_u8(scene, np.eye(3), np.zeros(3)))
    for img in imgs:
        x = torch.as_tensor(img, device=cuda)
        for th in (20.0, 7.0):
            before = fast.fast_score_map.launches
            got = fast.fast_score_map(x, th)
            assert fast.fast_score_map.launches == before + 1
            torch.cuda.synchronize()
            # the same float ops in the same order (no multiply): bit-exact
            assert torch.equal(got, fast.fast_score_map_torch(x, th))


@pytest.mark.cuda
def test_fast_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x = torch.zeros(64, 96, device=cuda)
    with pytest.raises(ValueError):
        fast.fast_score_map(x.t(), 20.0)          # not contiguous
    with pytest.raises(TypeError):
        fast.fast_score_map(x.half(), 20.0)


# stacked 4-level pyramids: EuRoC (480x752 .. 60x94), TUM RGB-D (480x640
# .. 60x80), ragged (101x137 .. 12x17) and one whose top level (5x6) is all
# 3-px frame
PYRAMIDS = [(480, 752), (480, 640), (101, 137), (40, 52)]


def _stacked(img, device):
    from ygz_tpu_torch.ops.image import build_pyramid, stack_pyramid

    return stack_pyramid(build_pyramid(torch.as_tensor(img, device=device),
                                       4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PYRAMIDS)
def test_fast_corners_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    imgs = [rng.uniform(0, 255, shape).astype(np.float32),
            rng.integers(0, 256, shape).astype(np.float32)]
    if shape == PYRAMIDS[0]:
        scene = SmoothScene(seed=11, w=shape[1], h=shape[0], f=458.0,
                            tex_size=2000)
        imgs.append(render_u8(scene, np.eye(3), np.zeros(3)))
    for img in imgs:
        stack = _stacked(img, cuda)
        for th_hi, th_lo in ((20.0, 7.0), (2.0, 1.0)):
            before = fast.fast_corner_maps.launches
            got = fast.fast_corner_maps(stack, shape[0], 4, th_hi, th_lo)
            assert fast.fast_corner_maps.launches == before + 1
            torch.cuda.synchronize()
            # one arc value for both thresholds, exact min/max, the
            # reference's adds in its order: bit-exact
            assert torch.equal(got, fast.fast_corner_maps_torch(
                stack, shape[0], 4, th_hi, th_lo))


@pytest.mark.cuda
def test_fast_corners_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    stack = _stacked(np.zeros((64, 96), np.float32), cuda)
    with pytest.raises(ValueError):
        fast.fast_corner_maps(stack.t().contiguous().t(), 64, 4, 20.0, 7.0)
    with pytest.raises(TypeError):
        fast.fast_corner_maps(stack.half(), 64, 4, 20.0, 7.0)
    with pytest.raises(ValueError):
        fast.fast_corner_maps(stack[:-1], 64, 4, 20.0, 7.0)


def _pnp_problem(rng, n=512, n_out=154):
    """PnP with 30% outliers: world points, pixels, truth (R, t)."""
    from ygz_tpu_torch.geometry.lie import so3_exp

    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 9, n)], 1).astype(np.float32)
    R = so3_exp(torch.tensor([0.1, -0.15, 0.05])).numpy()
    t = np.array([0.3, -0.2, 0.4], np.float32)
    Xc = X @ R.T + t
    uv = np.stack([458 * Xc[:, 0] / Xc[:, 2] + 376,
                   458 * Xc[:, 1] / Xc[:, 2] + 240], 1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:n_out] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    return X, uv, R, t


@pytest.mark.cuda
def test_pnp_ransac_cuda_matches_cpu(cuda):
    """The same injected hypotheses on the card and on the CPU: rotation
    within 0.01 deg, translation within 1e-3, inlier masks >= 99% equal."""
    from ygz_tpu_torch.backend.pnp import pnp_ransac
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.geometry.twoview import draw_samples

    X, uv, R, t = _pnp_problem(np.random.default_rng(0))
    valid = torch.ones(len(X), dtype=torch.bool)
    g = torch.Generator()
    g.manual_seed(0)
    idx = draw_samples(valid, 300, 4, g)
    intr = (458.0, 458.0, 376.0, 240.0)
    out = []
    for dev in ("cpu", cuda):
        r = pnp_ransac(torch.as_tensor(X, device=dev),
                       torch.as_tensor(uv, device=dev), valid.to(dev), intr,
                       samples=idx.to(dev))
        out.append([a.cpu().numpy() for a in r])
    (ok_c, R_c, t_c, in_c, _), (ok_g, R_g, t_g, in_g, _) = out
    assert ok_c and ok_g
    assert rotation_angle_deg(R_g, R_c) < 0.01
    assert np.abs(t_g - t_c).max() < 1e-3
    assert (in_g == in_c).mean() >= 0.99
    assert rotation_angle_deg(R_g, R) < 0.5 and not in_g[:154].any()


@pytest.mark.cuda
def test_sim3_ransac_cuda_matches_cpu(cuda):
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.geometry.lie import so3_exp
    from ygz_tpu_torch.geometry.sim3 import sim3_ransac
    from ygz_tpu_torch.geometry.twoview import draw_samples

    rng = np.random.default_rng(1)
    n, n_out = 200, 60
    R = so3_exp(torch.tensor([0.2, -0.1, 0.3])).numpy()
    t, s = np.array([0.5, -0.2, 0.1], np.float32), 1.1
    X = rng.normal(size=(n, 3)).astype(np.float32) * 2
    Y = (s * X @ R.T + t).astype(np.float32)
    Y[:n_out] += rng.uniform(0.5, 2, (n_out, 3)).astype(np.float32)
    mask = torch.ones(n, dtype=torch.bool)
    g = torch.Generator()
    g.manual_seed(1)
    idx = draw_samples(mask, 300, 3, g)
    out = []
    for dev in ("cpu", cuda):
        r = sim3_ransac(torch.as_tensor(X, device=dev),
                        torch.as_tensor(Y, device=dev), mask.to(dev),
                        th_b=0.05, samples=idx.to(dev))
        out.append([a.cpu().numpy() for a in r])
    (R_c, t_c, s_c, in_c, _), (R_g, t_g, s_g, in_g, _) = out
    assert rotation_angle_deg(R_g, R_c) < 0.01
    assert np.abs(t_g - t_c).max() < 1e-3 and abs(s_g - s_c) < 1e-3
    assert (in_g == in_c).mean() >= 0.99
    assert abs(s_g - s) < 1e-3 and not in_g[:n_out].any()


# ---- mono-VI: the IMU numerics on the card against the CPU, and the
# default device of System(Sensor.MONO_VI)


def _imu_windows(rng, n_links=4, cap=128):
    om = rng.normal(0, 0.3, (n_links, cap, 3)).astype(np.float32)
    ac = (rng.normal(0, 0.5, (n_links, cap, 3))
          + [0.0, 9.81, 0.0]).astype(np.float32)
    dts = np.full((n_links, cap), 0.005, np.float32)
    valid = np.arange(cap)[None, :] < rng.integers(20, cap, n_links)[:, None]
    return om, ac, dts, valid


@pytest.mark.cuda
def test_preintegrate_cuda_matches_cpu(cuda):
    from ygz_tpu_torch.imu.preintegration import preintegrate

    rng = np.random.default_rng(0)
    win = _imu_windows(rng)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.0, -0.1], np.float32)
    cpu, card = (preintegrate(
        *(torch.as_tensor(a, device=dev) for a in win),
        torch.as_tensor(bg, device=dev), torch.as_tensor(ba, device=dev))
        for dev in ("cpu", cuda))
    for f, a, b in zip(cpu._fields, card, cpu):
        b = b.numpy()
        # float32 in another order: within 1e-5 of each field's scale
        np.testing.assert_allclose(a.cpu().numpy(), b, err_msg=f,
                                   atol=1e-6 + 1e-5 * float(np.abs(b).max()))


@pytest.mark.cuda
def test_vio_pose_optimization_pair_cuda_matches_cpu(cuda):
    from ygz_tpu_torch.backend.vio_optim import vio_pose_optimization_pair
    from ygz_tpu_torch.eval.ate import rotation_angle_deg
    from ygz_tpu_torch.geometry.lie import so3_exp
    from ygz_tpu_torch.imu.preintegration import preintegrate

    rng = np.random.default_rng(3)
    g = np.array([0.0, -9.81, 0.0], np.float32)
    om = np.tile([0.1, 0.2, -0.15], (64, 1)).astype(np.float32)
    ac = np.tile(-g + [0.3, 0.0, 0.1], (64, 1)).astype(np.float32)
    dts = np.full(64, 0.005, np.float32)
    valid = np.arange(64) < 10
    intr = (458.0, 458.0, 375.5, 239.5)
    N = 512
    X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                  rng.uniform(4, 9, N)], 1).astype(np.float32)
    R1 = so3_exp(torch.tensor([0.005, 0.01, -0.0075])).numpy()
    P1 = np.array([0.03, 0.0, 0.0], np.float32)

    def proj(P, R):
        Xc = (X - P) @ R
        return (np.stack([intr[0] * Xc[:, 0] / Xc[:, 2] + intr[2],
                          intr[1] * Xc[:, 1] / Xc[:, 2] + intr[3]], 1)
                + rng.normal(0, 0.3, (N, 2))).astype(np.float32)

    uv0, uv1 = proj(np.zeros(3, np.float32), np.eye(3)), proj(P1, R1)
    z = np.zeros(3, np.float32)
    outs = []
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        pre = preintegrate(t(om), t(ac), t(dts),
                           torch.as_tensor(valid, device=dev), t(z), t(z))
        prev = (t(z), t([0.6, 0.0, 0.0]), t(np.eye(3)), t(z), t(z))
        cur = (t(P1), t([0.6, 0.0, 0.0]), t(R1), t(z), t(z))
        res = vio_pose_optimization_pair(
            cur, prev, pre, (t(z), t(z)), prev, t(np.eye(15) * 1e3), True,
            t(X), t(uv0), t(np.ones(N)), torch.ones(N, dtype=torch.bool,
                                                    device=dev),
            t(X), t(uv1), t(np.ones(N)), torch.ones(N, dtype=torch.bool,
                                                    device=dev),
            t(np.eye(3)), t(z), intr, t(g))
        outs.append([a.cpu().numpy() for a in (res.P, res.V, res.R, res.bg,
                                               res.ba, res.inliers,
                                               res.prior_info)])
    (P_c, V_c, R_c, bg_c, ba_c, in_c, M_c), (P_g, V_g, R_g, bg_g, ba_g,
                                             in_g, M_g) = outs
    np.testing.assert_allclose(P_g, P_c, atol=1e-4)
    np.testing.assert_allclose(V_g, V_c, atol=1e-4)
    assert rotation_angle_deg(R_g, R_c) < 1e-3
    np.testing.assert_allclose(bg_g, bg_c, atol=1e-5)
    np.testing.assert_allclose(ba_g, ba_c, atol=1e-5)
    assert (in_g == in_c).mean() >= 0.99
    assert np.linalg.norm(M_g - M_c) < 1e-3 * np.linalg.norm(M_c)


@pytest.mark.cuda
def test_mono_vi_system_builds_on_cuda_by_default(cuda):
    from ygz_tpu_torch.frontend.vi_tracker import MonoViTracker
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System

    cam = Camera.make(458.0, 458.0, 375.5, 239.5, 752, 480)
    tr = System(cam, Sensor.MONO_VI).tracker
    assert isinstance(tr, MonoViTracker) and tr.device.type == "cuda"
