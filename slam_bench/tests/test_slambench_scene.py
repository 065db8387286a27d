"""The generator: the lap repeats, its IMU integrates back to it, the
torch renderer matches the port's numpy renderer, the distorted rays
invert the lens model."""
import json

import numpy as np
import pytest
import torch

from slam_bench import harness, scene

LAP = json.loads((harness.BENCH / "traffic" / "live.json").read_text())[
    "lap"]
# EuRoC cam0's published body-to-camera extrinsic T_BS (sensor.yaml)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])


# ---- frozen copy of ygz_tpu_torch/utils/synthetic.py (commit 9b79ab1):
# the numpy render path of PlaneScene / SmoothScene, for this test only
def _np_bilinear(img, uv):
    H, W = img.shape
    x = np.clip(uv[..., 0], 0.0, W - 1.001)
    y = np.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01)
            + fy * ((1 - fx) * i10 + fx * i11)).astype(np.float32)


def _np_smooth_depth(x, y, base=5.0, amp=0.5, period=4.0):
    w = 2.0 * np.pi / period
    return base + amp * np.sin(w * x) * np.sin(w * y)


def _np_render(tex, R, t, w, h, f):
    """SmoothScene.render: a pinhole (f, centred) view of the surface."""
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d_cam = np.stack([(xs - cx) / f, (ys - cy) / f, np.ones_like(xs)], -1)
    Rwc = R.T
    o_w, d_w = -Rwc @ t, d_cam @ Rwc.T
    lam = (5.0 - o_w[2]) / d_w[..., 2]
    for _ in range(8):
        x = o_w[0] + lam * d_w[..., 0]
        y = o_w[1] + lam * d_w[..., 1]
        lam = (_np_smooth_depth(x, y) - o_w[2]) / d_w[..., 2]
    Xw = o_w[None, None, :] + lam[..., None] * d_w
    c = tex.shape[0] / 2.0
    uv = np.stack([Xw[..., 0] * 60.0 + c, Xw[..., 1] * 60.0 + c], -1)
    return _np_bilinear(tex, uv)


def _np_blur(tex, ksize, sigma):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = tex
    for axis in (1, 0):
        p = np.pad(out, [(0, 0), (r, r)] if axis == 1 else [(r, r), (0, 0)],
                   mode="edge")
        acc = np.zeros_like(out)
        for i, w in enumerate(k):
            sl = (slice(None), slice(i, i + out.shape[1])) if axis == 1 \
                else (slice(i, i + out.shape[0]), slice(None))
            acc += w * p[sl]
        out = acc
    return out
# ---- end of the frozen copy


@pytest.mark.parametrize("phase", [0.0, 17.3, 59.9])
def test_lap_repeats_after_one_lap(phase):
    lap = scene.Lap(LAP["seconds"], LAP["terms"], phase)
    T = LAP["seconds"]
    t = np.linspace(0.0, T, 97)
    for a, b in ((lap.pose(t), lap.pose(t + T)),):
        np.testing.assert_allclose(a[0], b[0], atol=1e-12)
        np.testing.assert_allclose(a[1], b[1], atol=1e-10)
    np.testing.assert_allclose(lap.velocity(t), lap.velocity(t + T),
                               atol=1e-10)


def test_lap_stays_on_the_texture_and_keeps_moving():
    lap = scene.Lap(LAP["seconds"], LAP["terms"])
    t = np.arange(0.0, LAP["seconds"], 0.05)
    c = lap.centre(t)
    half = LAP["texture_px"] / scene.TEX_SCALE / 2.0
    # view half-span at the surface's far side: 5.5 * 376 / 458 < 4.6
    assert np.abs(c[:, :2]).max() + 4.6 < half
    assert np.linalg.norm(lap.velocity(t), axis=1).min() > 0.1


@pytest.mark.parametrize("Tbc", [np.eye(4), TBC], ids=["identity", "euroc"])
def test_lap_imu_integrates_back_to_the_lap(Tbc):
    """The body's path from its IMU alone over 10 s (Euler at 2 kHz, whose
    own error is a few mm and mm/s) against the lap's body path: the
    samples are the lap's derivatives. A wrong lever arm or frame reads
    metres off."""
    lap = scene.Lap(LAP["seconds"], LAP["terms"], 7.3)
    hz = 2000.0
    gyro, acc = scene.lap_imu(lap, hz, Tbc)
    Rbc, tbc = Tbc[:3, :3], Tbc[:3, 3]

    def R_wb(t):
        return lap.R_cw(t).T @ Rbc.T

    R = R_wb(0.0)
    p = lap.centre(0.0) - R @ tbc
    v = scene.body_velocity(lap, 0.0, Tbc)
    dt = 1.0 / hz
    for k in range(int(10 * hz)):
        a_w = R @ acc[k] + scene.G_W
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ scene.rodrigues(gyro[k] * dt)
    assert np.linalg.norm(p - (lap.centre(10.0) - R_wb(10.0) @ tbc)) < 0.01
    assert np.linalg.norm(v - scene.body_velocity(lap, 10.0, Tbc)) < 0.005
    assert np.linalg.norm(scene.log_so3(R.T @ R_wb(10.0))) < 1e-4
    # one lap of samples wraps onto the next
    g2, a2 = scene.lap_imu(scene.Lap(LAP["seconds"], LAP["terms"],
                                     7.3 + LAP["seconds"]), hz,
                           Tbc)
    np.testing.assert_allclose(g2, gyro, atol=1e-4)
    np.testing.assert_allclose(a2, acc, atol=1e-4)


def test_blur_matches_the_numpy_blur():
    rng = np.random.default_rng(3)
    tex = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    np.testing.assert_allclose(scene.blur(torch.from_numpy(tex)).numpy(),
                               _np_blur(tex, 9, 2.0), atol=1e-3)


def test_torch_render_matches_smooth_scene_render():
    rng = np.random.default_rng(5)
    tex = rng.uniform(0, 255, (600, 600)).astype(np.float32)
    w, h, f = 96, 64, 80.0
    cam = {"fx": f, "fy": f, "cx": w / 2.0 - 0.5, "cy": h / 2.0 - 0.5,
           "width": w, "height": h, "dist": []}
    lap = scene.Lap(LAP["seconds"], {"x": [[1.0, 1]], "y": [[0.5, 2]],
                                     "pitch": [[0.04, 7]], "yaw": [[0.1, 5]]})
    R, t = lap.pose(np.array([3.0, 11.0]))
    got = scene.render(torch.from_numpy(tex), scene.ray_grid(cam, "cpu"),
                       torch.as_tensor(R, dtype=torch.float32),
                       torch.as_tensor(t, dtype=torch.float32)).numpy()
    for k in range(2):
        want = _np_render(tex, R[k], t[k], w, h, f)
        for y, x in ((0, 0), (5, 90), (31, 47), (63, 95), (40, 12)):
            assert abs(got[k, y, x] - want[y, x]) < 0.05, (k, y, x)


def test_rays_invert_the_lens_model():
    nums = harness.settings_numbers(harness.BENCH / "configs"
                                    / "euroc_mono.yaml")
    cam = harness.camera_dict(nums)
    rays = scene.ray_grid(cam, "cpu").double().numpy()
    k1, k2, p1, p2, _ = cam["dist"]
    for y, x in ((0, 0), (0, 751), (479, 0), (240, 376), (100, 600)):
        xu, yu = rays[y, x, 0], rays[y, x, 1]
        r2 = xu * xu + yu * yu
        rad = 1 + k1 * r2 + k2 * r2 * r2
        xd = xu * rad + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        yd = yu * rad + p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        assert abs(xd * cam["fx"] + cam["cx"] - x) < 1e-3
        assert abs(yd * cam["fy"] + cam["cy"] - y) < 1e-3


def test_texture_is_made_from_the_seed():
    a = scene.make_texture(64, 2**40 + 7, "cpu")
    b = scene.make_texture(64, 2**40 + 7, "cpu")
    c = scene.make_texture(64, 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0
    assert scene.lap_phase(2**33 + 1, 60.0) == scene.lap_phase(2**33 + 1, 60.0)


def test_every_live_window_holds_the_same_frames():
    """One scene for every seed, and a lap as long as the window: each
    run's window holds the lap's frames once, from the seed's start."""
    mix = json.loads((harness.BENCH / "traffic" / "live.json").read_text())
    spec = harness.benchmark_spec()
    assert isinstance(mix["lap"]["texture_seed"], int)
    assert mix["lap"]["seconds"] == spec["run_seconds"]
    assert (scene.lap_phase(2**40 + 1, LAP["seconds"])
            != scene.lap_phase(2**40 + 2, LAP["seconds"]))
