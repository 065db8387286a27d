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


# ---------------------------------------------------------------------------
# The frame step replayed as a CUDA graph, the batched path and the async
# mapping worker on the card

def _sweep(n, step=0.03):
    """tests/test_vo_e2e.py's sideways sweep (make_trajectory), with the
    port's so3_exp."""
    from ygz_tpu_torch.geometry.lie import so3_exp

    poses = []
    for i in range(n):
        w = np.array([0.015 * np.sin(i * 0.09 + 1.0), 0.03 * np.sin(i * 0.15),
                      0.0], np.float32)
        R = so3_exp(torch.as_tensor(w)).numpy()
        c = np.array([step * i, 0.15 * np.sin(i * 0.1), 0.0], np.float32)
        poses.append((R, (-R @ c).astype(np.float32)))
    return poses


def _sweep_frames(n):
    from ygz_tpu_torch.geometry.camera import Camera

    scene = SmoothScene(seed=11)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    return cam, [scene.render_u8(R, t) for R, t in _sweep(n)]


@pytest.mark.cuda
def test_frame_step_graph_replays_the_eager_step(cuda):
    """A tracker's captured frame step against the eager frame_step on the
    same static inputs, frame after frame over 24 frames (the graph chains
    its own carry): poses within 1e-5, tracked and visible masks equal."""
    from ygz_tpu_torch.frontend.framestep import (FrameCarry, frame_step,
                                                  unpack_out)
    from ygz_tpu_torch.system import Sensor, System

    cam, frames = _sweep_frames(36)
    system = System(cam, Sensor.MONOCULAR)
    for i, img in enumerate(frames[:12]):
        system.track_monocular(img, i * 0.05)
    tr = system.tracker
    graph = tr._graph
    assert tr.state.name == "OK" and graph is not None and graph.replays > 0
    cap = tr.cfg.max_track
    cache = tr._snap[1]
    exact = True
    for img in frames[12:]:
        carry = FrameCarry(*(a.clone() for a in graph.carry))
        new, eager = frame_step(torch.as_tensor(img, device=cuda), carry,
                                cache, graph.no_pred, None, tr.intr)
        graph.load(graph.carry, cache, graph.no_pred)
        replay = graph.step(torch.as_tensor(img)).clone()
        a = unpack_out(eager.cpu().numpy(), cap)
        b = unpack_out(replay.cpu().numpy(), cap)
        np.testing.assert_allclose(b.R, a.R, atol=1e-5)
        np.testing.assert_allclose(b.t, a.t, atol=1e-5)
        assert np.array_equal(a.tracked, b.tracked)
        assert np.array_equal(a.visible, b.visible)
        assert a.n_inliers > 100
        exact &= bool(torch.equal(eager, replay)) and all(
            torch.equal(x, y) for x, y in zip(new, graph.carry))
    print(f"graph replay bit-exact against eager over 24 frames: {exact}")


@pytest.mark.cuda
def test_batched_path_on_the_card_matches_the_cpu(cuda):
    """System.track_monocular_batch (B = 8, two chunks in flight) on the
    card and on the CPU over 32 frames: the same state per frame."""
    from ygz_tpu_torch.frontend.tracker import TrackerConfig
    from ygz_tpu_torch.system import Sensor, System

    cam, frames = _sweep_frames(32)
    stamps = [i * 0.05 for i in range(32)]
    states = []
    for dev in (cuda, "cpu"):
        system = System(cam, Sensor.MONOCULAR, device=dev,
                        config=TrackerConfig(track_batch=8))
        out = system.track_monocular_batch(frames, stamps)
        states.append([name for name, _ in out])
        if dev is cuda:
            assert system.tracker._graph.replays >= 24
    assert states[0] == states[1], states
    assert states[0][-1] == "OK"


CAPTURE_FAILS = """
import torch
from ygz_tpu_torch.frontend import framestep_graph
real = framestep_graph.frame_step

def syncing_step(*args, **kw):
    carry, packed = real(*args, **kw)
    if packed.sum().item() > -1.0:     # a host sync inside the step
        return carry, packed
    return carry, packed

framestep_graph.frame_step = syncing_step
try:
    framestep_graph.FrameStepGraph(120, 160, 64, (100.0, 100.0, 79.5, 59.5))
except RuntimeError as e:
    print("capture refused:", str(e).splitlines()[0])
    raise SystemExit(3)
raise SystemExit(0)
"""


@pytest.mark.cuda
def test_a_capture_that_cannot_succeed_raises(cuda):
    """A frame step that syncs the host cannot be captured: the capture
    raises (no silent eager fall back). In a child process, so the failed
    capture leaves no state behind in this one."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", CAPTURE_FAILS],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "capture refused" in proc.stdout


@pytest.mark.cuda
def test_fast_corners_from_the_mapping_worker_stream(cuda):
    """The fused FAST launch issued from another thread on its own stream
    (where the async worker runs deferred keyframe extraction) equals its
    plain version, and is counted."""
    import threading

    scene = SmoothScene(seed=11, w=752, h=480, f=458.0, tex_size=2000)
    stack = _stacked(render_u8(scene, np.eye(3), np.zeros(3)), cuda)
    want = fast.fast_corner_maps_torch(stack, 480, 4, 20.0, 7.0)
    stream = torch.cuda.Stream(cuda)
    got = {}

    def worker():
        with torch.cuda.stream(stream):
            got["map"] = fast.fast_corner_maps(stack, 480, 4, 20.0, 7.0)
            got["stream"] = torch.cuda.current_stream(cuda).cuda_stream
        stream.synchronize()

    before = fast.fast_corner_maps.launches
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert got["stream"] == stream.cuda_stream
    assert fast.fast_corner_maps.launches == before + 1
    assert torch.equal(got["map"], want)


@pytest.mark.cuda
def test_async_system_builds_on_cuda_by_default(cuda):
    from ygz_tpu_torch.frontend.tracker import TrackerConfig
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System

    cam = Camera.make(458.0, 458.0, 375.5, 239.5, 752, 480)
    system = System(cam, Sensor.MONOCULAR,
                    config=TrackerConfig(async_mapping=True, track_batch=32))
    tr = system.tracker
    assert tr.device.type == "cuda" and tr._map_worker.is_alive()
    assert tr._map_stream is not None and tr.cfg.pipeline_depth == 2
    system.shutdown()


@pytest.mark.cuda
def test_frame_step_batch_on_cuda_needs_its_graph(cuda):
    """frame_step_batch on CUDA tensors replays the caller's graph; without
    one it raises instead of capturing a graph per call."""
    from ygz_tpu_torch.frontend.framestep import (CACHE_COLS, FrameCarry,
                                                  frame_step_batch)

    carry = FrameCarry(pyr=torch.zeros(180, 160, device=cuda),
                       state=torch.zeros(24, device=cuda),
                       pts=torch.zeros(64, 6, device=cuda))
    with pytest.raises(ValueError, match="FrameStepGraph"):
        frame_step_batch(torch.zeros(2, 120, 160, device=cuda), carry,
                         torch.zeros(64, CACHE_COLS, device=cuda), None,
                         (100.0, 100.0, 79.5, 59.5))


@pytest.mark.cuda
def test_segment_sum_repeats_on_the_card(cuda):
    """optim.segment_sum on the card: bit-identical from call to call with
    heavily repeated ids (where atomic adds vary), and equal to the CPU's
    row-order sum within float32 rounding."""
    from ygz_tpu_torch.backend.optim import segment_sum

    g = torch.Generator().manual_seed(3)
    x = torch.randn(40000, 6, 3, generator=g)
    ids = torch.randint(0, 37, (40000,), generator=g)
    xd, idd = x.to(cuda), ids.to(cuda)
    first = segment_sum(xd, idd, 37)
    assert all(torch.equal(first, segment_sum(xd, idd, 37))
               for _ in range(5))
    torch.testing.assert_close(first.cpu(), segment_sum(x, ids, 37),
                               atol=1e-3, rtol=1e-5)
