"""The port's hand-written CUDA kernels against their plain PyTorch versions,
and the numerics of the later slices (RANSACs, IMU preintegration, the
NavState pair optimization) against the same on the CPU, on a card.
Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Without a CUDA device every test skips."""
import functools

import numpy as np
import pytest
import torch

from ygz_tpu_torch.ops import fast
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_gn_cases import ALIGN_CASES as ALIGN_GN_CASES
from torch_gn_cases import BF as BF_GN
from torch_gn_cases import INTR as INTR_GN
from torch_gn_cases import NO_VALID as NO_VALID_GN
from torch_gn_cases import POSE_CASES as POSE_GN_CASES
from torch_gn_cases import align_points as gn_align_points
from torch_gn_cases import plane_frames as gn_plane_frames
from torch_gn_cases import pose_problem as gn_pose_problem
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
# .. 60x80), KITTI (376x1241 .. 47x155, ragged at every level), ragged
# (101x137 .. 12x17) and one whose top level (5x6) is all 3-px frame
PYRAMIDS = [(480, 752), (480, 640), (376, 1241), (101, 137), (40, 52)]
KITTI_F = 718.856


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
    if shape in ((480, 752), (376, 1241)):
        scene = SmoothScene(seed=11, w=shape[1], h=shape[0],
                            f=458.0 if shape[0] == 480 else KITTI_F,
                            tex_size=2000 if shape[0] == 480 else 2400)
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


@pytest.mark.cuda
def test_octree_extraction_on_the_card_matches_the_cpu(cuda):
    """OrbExtractor(mode="octree") and its keyframe form on a EuRoC
    pyramid, card against CPU: uv, level, score and valid equal, angles
    within 1e-4, descriptors equal; one fused FAST launch per call."""
    from ygz_tpu_torch.frontend.extractor import OrbExtractor
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked

    scene = SmoothScene(seed=11, w=752, h=480, f=458.0, tex_size=2000)
    img = render_u8(scene, np.eye(3), np.zeros(3))
    ext = OrbExtractor(mode="octree")
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        pyr = build_pyramid_stacked(torch.as_tensor(img, device=dev), None, 4)
        before = fast.fast_corner_maps.launches
        feats = ext(pyr)
        half = feats.valid.clone()
        half[1::2] = False
        ang, desc, kf = ext.extract_keyframe(pyr, feats.uv, feats.level,
                                             half)
        if dev.type == "cuda":
            assert fast.fast_corner_maps.launches == before + 2
        outs[dev.type] = [x.cpu() for x in (*feats, ang, desc, *kf)]
    a, b = outs["cuda"], outs["cpu"]
    for j in (0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13):
        assert torch.equal(a[j], b[j]), j
    for j in (2, 6, 10):
        assert float((a[j] - b[j]).abs().max()) <= 1e-4
    assert int(a[5].sum()) > 400


@pytest.mark.cuda
def test_kitti_extraction_on_the_card_matches_the_cpu(cuda):
    """The grid extraction and its keyframe form at KITTI's 1241x376 (its
    pyramid is ragged at every level) on three views, card against CPU:
    uv, level, score and valid equal, angles within 1e-4, descriptors
    equal."""
    from ygz_tpu_torch.frontend.extractor import OrbExtractor
    from ygz_tpu_torch.frontend.framestep import build_pyramid_stacked

    scene = SmoothScene(seed=11, w=1241, h=376, f=KITTI_F, tex_size=2400)
    ext = OrbExtractor()
    for R, t in _sweep(3):
        img = render_u8(scene, R, t)
        outs = {}
        for dev in (cuda, torch.device("cpu")):
            pyr = build_pyramid_stacked(torch.as_tensor(img, device=dev),
                                        None, 4)
            feats = ext(pyr)
            ang, desc, kf = ext.extract_keyframe(pyr, feats.uv, feats.level,
                                                 feats.valid)
            outs[dev.type] = [x.cpu() for x in (*feats, ang, desc, *kf)]
        a, b = outs["cuda"], outs["cpu"]
        for j in (0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13):
            assert torch.equal(a[j], b[j]), j
        for j in (2, 6, 10):
            assert float((a[j] - b[j]).abs().max()) <= 1e-4
        assert int(a[5].sum()) > 400


@pytest.mark.cuda
def test_frame_step_graph_with_a_remap_grid_replays_the_eager_step(cuda):
    """A camera with radtan distortion (examples/mono_euroc.py's default
    camera): the captured frame step, with the undistort remap as its
    static grid, against the eager frame_step given the same grid, over 10
    frames: bit-exact."""
    from ygz_tpu_torch.examples.mono_euroc import EUROC_CAM
    from ygz_tpu_torch.frontend.framestep import FrameCarry, frame_step
    from ygz_tpu_torch.geometry.camera import Camera
    from ygz_tpu_torch.system import Sensor, System

    scene = SmoothScene(seed=11, w=752, h=480, f=458.0, tex_size=3000)
    c = EUROC_CAM
    grid = scene.distorted_grid(c["fx"], c["fy"], c["cx"], c["cy"],
                                c["dist"])
    frames = [np.clip(scene.render_at(R, t, grid), 0, 255).astype(np.uint8)
              for R, t in _sweep(34)]
    system = System(Camera.make(**c), Sensor.MONOCULAR)
    for i, img in enumerate(frames[:24]):
        system.track_monocular(img, i * 0.05)
    tr = system.tracker
    graph = tr._graph
    assert tr.state.name == "OK" and graph.remap is not None
    assert torch.equal(graph.remap, tr._remap)
    cache = tr._snap[1]
    for img in frames[24:]:
        carry = FrameCarry(*(a.clone() for a in graph.carry))
        new, eager = frame_step(torch.as_tensor(img, device=cuda), carry,
                                cache, graph.no_pred, tr._remap, tr.intr)
        graph.load(graph.carry, cache, graph.no_pred)
        replay = graph.step(torch.as_tensor(img)).clone()
        assert torch.equal(eager, replay)
        assert all(torch.equal(x, y) for x, y in zip(new, graph.carry))


@pytest.mark.cuda
def test_dist_ba_on_the_card_matches_the_cpu_and_repeats(cuda):
    """The distributed BA step with 2 shards on one card against 2 shards on
    the CPU (parallel/worker.py's problem): kf_t within 1e-4, chi2 within
    1%; a second card solve bit for bit; 1 and 2 card shards agree."""
    from ygz_tpu_torch.parallel.dist_ba import Mesh
    from ygz_tpu_torch.parallel.worker import solve

    run, card = solve(Mesh([cuda, cuda]))
    again = run()
    _, cpu = solve(Mesh(["cpu", "cpu"]))
    _, one = solve(Mesh([cuda]))
    assert card.kf_t.device.type == "cuda"
    assert torch.equal(card.kf_t, again.kf_t)
    assert torch.equal(card.points, again.points)
    for other in (cpu, one):
        assert (card.kf_t.cpu() - other.kf_t.cpu()).abs().max() < 1e-4
        assert abs(float(card.total_chi2) - float(other.total_chi2)) \
            < 0.01 * float(other.total_chi2)


# ---- the frame step's two Gauss-Newton loops, one launch each
# (csrc/pose_gn.cu, csrc/sparse_align.cu), against their plain versions on
# the same card inputs: tests/torch_gn_cases.py's seeded cases (the CPU
# parity tests against JAX use the same ones)

def _pose_on(p, kw, dev, fn):
    from ygz_tpu_torch.backend.optim import CHI2_MONO

    ur = p["ur"]
    res = fn(*(torch.as_tensor(p[k], device=dev)
               for k in ("X", "uv", "is2", "valid", "R0", "t0")),
             INTR_GN,
             ur=None if ur is None else torch.as_tensor(ur, device=dev),
             bf=BF_GN if ur is not None else 0.0, **kw)
    gate = kw.get("chi2_th", CHI2_MONO)
    th = np.full(len(p["X"]), gate, np.float32)
    if ur is not None:
        th[ur >= 0] = 7.815 * gate / CHI2_MONO
    return res, th


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(POSE_GN_CASES) + ["no_valid"])
def test_pose_gn_kernel_matches_plain(cuda, case):
    from ygz_tpu_torch.backend import optim

    spec, kw = POSE_GN_CASES.get(case, (NO_VALID_GN, {}))
    p = gn_pose_problem(**spec)
    before = optim.pose_optimization.launches
    got, th = _pose_on(p, kw, cuda, optim.pose_optimization)
    assert optim.pose_optimization.launches == before + 1
    want, _ = _pose_on(p, kw, cuda, optim.pose_optimization_torch)
    torch.cuda.synchronize()
    g_inl, w_inl = got.inliers.cpu().numpy(), want.inliers.cpu().numpy()
    assert int(got.n_inliers) == int(g_inl.sum())
    if case == "no_valid":
        # H = 0: non-finite steps in both, no inlier
        assert not torch.isfinite(got.R).all()
        assert not torch.isfinite(want.R).all()
        assert int(got.n_inliers) == 0
        return
    if spec["n"] == 1:
        # rank-deficient (torch_gn_cases / test_torch_gn_kernels.py): the
        # pose follows rounding; the row is fitted and kept in both
        assert g_inl.tolist() == w_inl.tolist() == [bool(p["valid"][0])]
        assert float(got.chi2[0]) < 1e-3 and float(want.chi2[0]) < 1e-3
        return
    # the same float32 GN with its sums in another order (the kernel's
    # fixed tree against cuBLAS / cuSOLVER): the fixed point agrees to
    # ~1e-7 (the kernel's arithmetic emulated on the CPU: 6e-8 / 8e-7)
    assert (got.R - want.R).abs().max() < 1e-5
    assert (got.t - want.t).abs().max() < 1e-5
    # masks equal but for rows whose chi2 sits within 1e-4 of the gate
    c2 = want.chi2.cpu().numpy()
    near = np.abs(c2 - th) <= 1e-4 * th
    assert np.array_equal(g_inl[~near], w_inl[~near])
    # chi2 at the final pose; rows behind the camera reach ~1e16
    np.testing.assert_allclose(got.chi2.cpu().numpy(), c2, atol=1e-2,
                               rtol=1e-3)


@pytest.mark.cuda
def test_gn_kernels_repeat_bit_for_bit(cuda):
    """No atomics, one summation order: two launches on the same inputs
    give the same bits (what a graph replay of the frame step needs)."""
    from ygz_tpu_torch.backend import optim

    p = gn_pose_problem(**POSE_GN_CASES["stereo"][0])
    a, _ = _pose_on(p, {}, cuda, optim.pose_optimization)
    b, _ = _pose_on(p, {}, cuda, optim.pose_optimization)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ref, cur, uv0, X, valid, intr = _align_inputs(cuda, seed=8, border=False)
    from ygz_tpu_torch.frontend.sparse_align import sparse_image_align

    a = sparse_image_align(ref, cur, uv0, X, valid, intr,
                           torch.eye(3, device=cuda),
                           torch.zeros(3, device=cuda))
    b = sparse_image_align(ref, cur, uv0, X, valid, intr,
                           torch.eye(3, device=cuda),
                           torch.zeros(3, device=cuda))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _align_inputs(dev, seed, border, no_valid=False):
    """The plane frames' pyramids (the reference's levels as views of a
    stacked buffer, as the frame step passes the carry's) and the case's
    points, on `dev`."""
    from ygz_tpu_torch.ops.image import (build_pyramid, stack_pyramid,
                                         unstack_pyramid)

    scene, I0, I1, _ = _plane_frames()
    uv0, valid = gn_align_points(seed, border)
    if no_valid:
        valid[:] = False
    X = scene.backproject(np.eye(3), np.zeros(3), uv0).astype(np.float32)
    ref = unstack_pyramid(stack_pyramid(build_pyramid(
        torch.as_tensor(I0, device=dev), 4)), 4)
    cur = build_pyramid(torch.as_tensor(I1, device=dev), 4)
    return (ref, cur, torch.as_tensor(uv0, device=dev),
            torch.as_tensor(X, device=dev),
            torch.as_tensor(valid, device=dev),
            (scene.f, scene.f, scene.cx, scene.cy))


# rendered once, at the first test that runs on a card
_plane_frames = functools.lru_cache(maxsize=None)(gn_plane_frames)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ALIGN_GN_CASES)
                         + ["main_path", "no_valid"])
def test_sparse_align_kernel_matches_plain(cuda, case):
    from ygz_tpu_torch.frontend import sparse_align as sa

    spec = ALIGN_GN_CASES.get(case, dict(seed=8, border=False))
    levels, iters = ((2, 1), 3) if case in ALIGN_GN_CASES else ((3, 2, 1),
                                                                10)
    ref, cur, uv0, X, valid, intr = _align_inputs(
        cuda, **spec, no_valid=case == "no_valid")
    eye, zero = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
    before = sa.sparse_image_align.launches
    got = sa.sparse_image_align(ref, cur, uv0, X, valid, intr, eye, zero,
                                levels=levels, iters=iters)
    assert sa.sparse_image_align.launches == before + 1
    want = sa.sparse_image_align_torch(ref, cur, uv0, X, valid, intr, eye,
                                       zero, levels=levels, iters=iters)
    torch.cuda.synchronize()
    if case == "no_valid":
        assert int(got.n_meas) == int(want.n_meas) == 0
        assert float(got.mean_res) == float(want.mean_res) == 0.0
        assert not torch.isfinite(got.R).all()
        return
    # float32 sums in another order (the kernel's arithmetic emulated on
    # the CPU agrees to 1.2e-7 / 4.9e-7 on these cases)
    assert (got.R - want.R).abs().max() < 1e-5
    assert (got.t - want.t).abs().max() < 1e-5
    # a point on a border line may flip its visibility
    assert abs(int(got.n_meas) - int(want.n_meas)) <= 2
    assert abs(float(got.mean_res) - float(want.mean_res)) < 1e-3
    assert int(got.n_meas) > 300


@pytest.mark.cuda
def test_gn_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    from ygz_tpu_torch.backend.optim import pose_optimization
    from ygz_tpu_torch.frontend.sparse_align import sparse_image_align

    n = 16
    X = torch.rand(n, 3, device=cuda) + 2.0
    uv = torch.rand(n, 2, device=cuda)
    ones = torch.ones(n, device=cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    eye, zero = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
    with pytest.raises(TypeError):
        pose_optimization(X.double(), uv, ones, valid, eye, zero, INTR_GN)
    with pytest.raises(ValueError):
        pose_optimization(X[:, :2], uv, ones, valid, eye, zero, INTR_GN)
    with pytest.raises(TypeError):
        pose_optimization(X, uv, ones, valid, eye.double(), zero, INTR_GN)
    with pytest.raises(ValueError):
        pose_optimization(X, uv[:-1], ones, valid, eye, zero, INTR_GN)
    # a level below sample_patches' 7x7 gather
    tiny = tuple(torch.zeros(48 >> k, 64 >> k, device=cuda)
                 for k in range(4))
    with pytest.raises(ValueError):
        sparse_image_align(tiny, tiny, uv, X, valid, INTR_GN, eye, zero)
    with pytest.raises(TypeError):
        sparse_image_align(tuple(x.double() for x in tiny), tiny, uv, X,
                           valid, INTR_GN, eye, zero, levels=(1,))


@pytest.mark.cuda
def test_frame_step_launches_each_gn_kernel(cuda):
    """One eager frame step launches pose_gn twice (direct tracking's two
    passes) and sparse_align once; one graph replay runs the same three
    kernels (torch.profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    from ygz_tpu_torch.backend import optim
    from ygz_tpu_torch.frontend import sparse_align as sa
    from ygz_tpu_torch.frontend.framestep import FrameCarry, frame_step
    from ygz_tpu_torch.system import Sensor, System

    cam, frames = _sweep_frames(14)
    system = System(cam, Sensor.MONOCULAR)
    for i, img in enumerate(frames[:12]):
        system.track_monocular(img, i * 0.05)
    tr = system.tracker
    graph = tr._graph
    assert tr.state.name == "OK" and graph is not None
    cache = tr._snap[1]
    before = (optim.pose_optimization.launches,
              sa.sparse_image_align.launches)
    frame_step(torch.as_tensor(frames[12], device=cuda),
               FrameCarry(*(a.clone() for a in graph.carry)), cache,
               graph.no_pred, None, tr.intr)
    assert (optim.pose_optimization.launches - before[0],
            sa.sparse_image_align.launches - before[1]) == (2, 1)
    graph.load(graph.carry, cache, graph.no_pred)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.step(torch.as_tensor(frames[13]))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("pose_gn_kernel" in k for k in names) == 2
    assert sum("sparse_align_kernel" in k for k in names) == 1


# ---- the direct tracker's per-point work, one launch per pass
# (csrc/direct_align.cu), against its plain version on the same card
# inputs: tests/torch_direct_cases.py's seeded cases (the CPU parity tests
# against JAX use the same ones) and one eager frame step's own inputs

def _direct_inputs(case, dev):
    from torch_direct_cases import (CASES, R_CUR, R_PRED, T_CUR, T_PRED,
                                    direct_case, scene_frames)

    _, stack, _ = scene_frames()
    t = functools.partial(torch.as_tensor, device=dev)
    pts = tuple(t(a) for a in direct_case(**CASES[case]))
    return (t(stack), (t(R_PRED), t(T_PRED)), (t(R_CUR), t(T_CUR)), pts)


@functools.lru_cache(maxsize=None)
def _main_path_direct():
    """track_local_map_direct's arguments in one eager frame step of a
    tracker on the card (its cache of max_track rows, as the graph's
    replay passes them), with the tracker itself."""
    from ygz_tpu_torch.frontend import framestep
    from ygz_tpu_torch.frontend.framestep import FrameCarry
    from ygz_tpu_torch.system import Sensor, System

    cam, frames = _sweep_frames(14)
    system = System(cam, Sensor.MONOCULAR)
    for i, img in enumerate(frames[:12]):
        system.track_monocular(img, i * 0.05)
    tr = system.tracker
    graph = tr._graph
    assert tr.state.name == "OK" and graph is not None
    calls = []
    real = framestep.track_local_map_direct

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    framestep.track_local_map_direct = record
    try:
        framestep.frame_step(
            torch.as_tensor(frames[12], device="cuda"),
            FrameCarry(*(a.clone() for a in graph.carry)), tr._snap[1],
            graph.no_pred, None, tr.intr)
    finally:
        framestep.track_local_map_direct = real
    torch.cuda.synchronize()
    assert len(calls) == 1
    return system, frames, calls[0]


def _direct_case_names():
    from torch_direct_cases import CASES

    return list(CASES) + ["main_path"]


def _hold_direct(got, want, level, both_ok):
    """uv within 1e-3 px at the point's search level on >= 99% of the
    points aligned in both (median ~1e-5 on the CPU rehearsal), and every
    one within 0.1 px: a point whose last step sits at the 0.03-px test
    stops one step earlier or later (float32 sums in another order)."""
    d = ((got - want).abs().max(1).values
         / 2.0 ** level.float())[both_ok].cpu().numpy()
    if len(d):
        assert (d < 1e-3).mean() >= 0.99
        assert (d < 0.1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", _direct_case_names())
def test_direct_align_kernel_matches_plain(cuda, case):
    """track_local_map_direct (2 launches) and refine_matches_core (1) on
    the card against their plain versions on the same card tensors: ok on
    >= 99% of the points (sums in another order near the eps-0.03 test),
    uv as _hold_direct says, visible and level equal on visible points."""
    from ygz_tpu_torch.frontend import direct_tracker as dt
    from ygz_tpu_torch.ops.image import infer_height

    if case == "main_path":
        _, _, (args, kw) = _main_path_direct()
        stack, (R, t), pts, intr = args[0], args[1:3], args[3:10], args[10]
        pose_ref = (R, t)
    else:
        stack, (R, t), pose_ref, pts = _direct_inputs(case, cuda)
        from torch_direct_cases import INTR as intr
        kw = {}
    before = dt.direct_align.launches
    got = dt.track_local_map_direct(stack, R, t, *pts, intr, **kw)
    assert dt.direct_align.launches == before + 2
    want = dt.track_local_map_direct_torch(stack, R, t, *pts, intr, **kw)
    torch.cuda.synchronize()
    n = pts[0].shape[0]
    a_g, a_w = got.aligned.cpu().numpy(), want.aligned.cpu().numpy()
    assert (a_g == a_w).mean() >= 0.99
    vis = want.visible
    assert torch.equal(got.visible, vis)
    if vis.any():
        assert (got.level == want.level)[vis].float().mean() >= 0.99
    _hold_direct(got.uv, want.uv, want.level, got.aligned & want.aligned)
    assert (got.uv[~got.aligned] == 0).all()
    if a_w.sum() >= 8:
        # the GN kernels over positions that agree to ~1e-4 px
        assert (got.R - want.R).abs().max() < 1e-4
        assert (got.t - want.t).abs().max() < 1e-4
        assert abs(int(got.n_inliers) - int(want.n_inliers)) <= max(2,
                                                                    n // 100)
    else:
        assert int(got.n_inliers) == int(want.n_inliers) <= 1

    before = dt.direct_align.launches
    Rr, tr_ = pose_ref
    uv, ok = dt.refine_matches_core(stack, Rr, tr_, *pts, intr, **kw)
    assert dt.direct_align.launches == before + 1
    uv_w, ok_w = dt.refine_matches_core_torch(stack, Rr, tr_, *pts, intr,
                                              **kw)
    torch.cuda.synchronize()
    assert (ok == ok_w).float().mean() >= 0.99
    h0 = infer_height(stack.shape[0], stack.shape[1], 4)
    lvl = dt._warp_setup(h0, stack.shape[1], Rr, tr_, *pts, intr, 4)[1]
    _hold_direct(uv, uv_w, lvl, ok & ok_w)


@pytest.mark.cuda
def test_direct_align_repeats_bit_for_bit(cuda):
    """No atomics, one summation order: two launches on the same inputs
    give the same bits (what a graph replay of the frame step needs)."""
    from torch_direct_cases import INTR
    from ygz_tpu_torch.frontend import direct_tracker as dt

    stack, (R, t), pose_ref, pts = _direct_inputs("main", cuda)
    a = dt.track_local_map_direct(stack, R, t, *pts, INTR)
    b = dt.track_local_map_direct(stack, R, t, *pts, INTR)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = dt.refine_matches_core(stack, *pose_ref, *pts, INTR)
    b = dt.refine_matches_core(stack, *pose_ref, *pts, INTR)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_direct_align_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    from torch_direct_cases import INTR
    from ygz_tpu_torch.frontend.direct_tracker import direct_align

    stack, (R, t), _, pts = _direct_inputs("one_point", cuda)
    h0 = 480

    def with_pt(k, x):
        return pts[:k] + (x,) + pts[k + 1:]

    with pytest.raises(TypeError):                 # float64 points
        direct_align(stack, h0, with_pt(0, pts[0].double()), INTR, R, t)
    with pytest.raises(TypeError):                 # an int64 level
        direct_align(stack, h0, with_pt(4, pts[4].long()), INTR, R, t)
    with pytest.raises(ValueError):                # a 10x10 stored patch
        direct_align(stack, h0, with_pt(2, pts[2][:, :10, :10]), INTR, R, t)
    with pytest.raises(ValueError):                # rows of unequal length
        direct_align(stack, h0, with_pt(3, torch.cat([pts[3], pts[3]])),
                     INTR, R, t)
    with pytest.raises(TypeError):                 # a float64 pose
        direct_align(stack, h0, pts, INTR, R.double(), t)
    with pytest.raises(TypeError):                 # a float64 pyramid
        direct_align(stack.double(), h0, pts, INTR, R, t)
    with pytest.raises(ValueError):                # below the 9x9 gather
        direct_align(torch.zeros(8, 8, device=cuda), 4, pts, INTR, R, t)
    with pytest.raises(ValueError):                # CPU points
        direct_align(stack, h0, tuple(x.cpu() for x in pts), INTR, R, t)
    prev = (torch.zeros(1, 2, device=cuda),
            torch.zeros(1, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):                # prev without a setup
        direct_align(stack, h0, pts, INTR, R, t, prev=prev)
    _, _, setup = direct_align(stack, h0, pts, INTR, R, t)
    with pytest.raises(ValueError):                # prev of another length
        direct_align(stack, h0, pts, INTR, R, t, setup=setup,
                     prev=(torch.zeros(2, 2, device=cuda), prev[1]))


@pytest.mark.cuda
def test_frame_step_launches_the_direct_align_kernel_twice(cuda):
    """One eager frame step launches direct_align twice (its two passes);
    one graph replay runs 2 direct_align and 2 pose_gn kernels
    (torch.profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile
    from ygz_tpu_torch.frontend import direct_tracker as dt
    from ygz_tpu_torch.frontend.framestep import FrameCarry, frame_step

    system, frames, _ = _main_path_direct()
    tr = system.tracker
    graph = tr._graph
    cache = tr._snap[1]
    before = dt.direct_align.launches
    frame_step(torch.as_tensor(frames[12], device=cuda),
               FrameCarry(*(a.clone() for a in graph.carry)), cache,
               graph.no_pred, None, tr.intr)
    assert dt.direct_align.launches - before == 2
    saved = FrameCarry(*(a.clone() for a in graph.carry))
    graph.load(graph.carry, cache, graph.no_pred)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.step(torch.as_tensor(frames[13]))
        torch.cuda.synchronize()
    graph.load(saved)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("direct_align_kernel" in k for k in names) == 2
    assert sum("pose_gn_kernel" in k for k in names) == 2


@pytest.mark.cuda
def test_refine_matches_on_the_worker_stream_launches_once(cuda):
    """The mapping worker's triangulation refines on its own CUDA stream:
    one launch there, the same bits as on the default stream."""
    import threading

    from torch_direct_cases import INTR
    from ygz_tpu_torch.frontend import direct_tracker as dt

    stack, _, pose_ref, pts = _direct_inputs("ragged_1500", cuda)
    want = dt.refine_matches_core(stack, *pose_ref, *pts, INTR)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream(cuda)
    got = {}

    def worker():
        with torch.cuda.stream(stream):
            before = dt.direct_align.launches
            got["out"] = dt.refine_matches_core(stack, *pose_ref, *pts, INTR)
            got["launches"] = dt.direct_align.launches - before
        stream.synchronize()

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert got["launches"] == 1
    assert all(torch.equal(x, y) for x, y in zip(got["out"], want))
