"""The harness drives the sensor its configuration names: a stub System
records every call, so these check what each sensor's entry is handed (the
right view, the depth, the IMU) against the generator, at a tiny size."""
import copy
import json

import numpy as np
import pytest
import torch

from slam_bench import harness, scene
from slam_bench.tests import sensor_cells
from ygz_tpu_torch import system as system_mod

SCALE = 0.1            # 75 x 48 frames
SEED = 2**31 + 4321
ENTRIES = {"euroc_mono.live": "track_monocular",
           "euroc_stereo.live": "track_stereo",
           "euroc_rgbd.live": "track_rgbd",
           "euroc_mono_vi.live": "track_mono_vi"}


class StubSystem:
    """Records its construction and every entry call; answers OK with the
    identity. A mono-inertial one reads VINS-initialized after
    `vi_init_after` calls."""

    made = []
    vi_init_after = 5

    def __init__(self, cam, sensor, config=None, device="cpu", **kw):
        self.cam, self.sensor, self.config, self.kw = cam, sensor, config, kw
        self.calls = []
        self.tracker = type("T", (), {})()
        self.tracker.vins_scale = None
        StubSystem.made.append(self)

    def _answer(self, *call):
        self.calls.append(call)
        if len(self.calls) >= self.vi_init_after:
            self.tracker.vins_scale = 1.0
        return "OK", np.eye(4, dtype=np.float32)

    def track_monocular(self, img, ts):
        return self._answer("track_monocular", img, ts)

    def track_stereo(self, left, right, ts):
        return self._answer("track_stereo", left, right, ts)

    def track_rgbd(self, img, depth, ts):
        return self._answer("track_rgbd", img, depth, ts)

    def track_mono_vi(self, img, imu, ts):
        return self._answer("track_mono_vi", img, imu, ts)

    def shutdown(self):
        pass


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(system_mod, "System", StubSystem)
    StubSystem.made.clear()
    return StubSystem


def toy_cell(name, **lap):
    cell = (harness.load_cell(name) if name == "euroc_mono.live"
            else sensor_cells.cell(name))
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["lap"].update(lap)
    return cell


def prepared(name, lap_frames=4, control=None, **lap):
    run = harness.Run(toy_cell(name, **lap), SEED, device="cpu",
                      scale=SCALE, lap_frames=lap_frames, control=control)
    run.prepare()
    return run, StubSystem.made[-1]


def lap_poses(run, n):
    R, t = run.lap.pose(np.arange(n) / run.stream.fps)
    return (torch.as_tensor(R, dtype=torch.float32),
            torch.as_tensor(t, dtype=torch.float32))


def toy_camera(run):
    return harness.camera_dict(harness.settings_numbers(
        run.cell.config["settings_path"]), SCALE)


@pytest.mark.parametrize("name", ENTRIES)
def test_each_sensor_calls_its_entry_with_its_inputs(stub, name):
    run, sys_ = prepared(name)
    assert sys_.sensor == system_mod.Sensor[harness.sensor_of(
        run.cell.config)]
    out = run._feed(3)
    assert [r[1] for r in out] == ["OK"] * 3
    H, W = run.stream.frames.shape[1:]
    for j, call in enumerate(sys_.calls):
        assert call[0] == ENTRIES[name]
        img, ts = call[1], call[-1]
        assert img.dtype == np.uint8 and img.shape == (H, W)
        assert ts == j / run.stream.fps
        if name == "euroc_stereo.live":
            assert call[2].dtype == np.uint8 and call[2].shape == (H, W)
        elif name == "euroc_rgbd.live":
            assert call[2].dtype == np.float32 and call[2].shape == (H, W)
        elif name == "euroc_mono_vi.live":
            assert len(call[2]) == 10          # 200 Hz over a 20-Hz frame
            for t, gyro, acc in call[2]:
                assert isinstance(t, float)
                assert gyro.shape == (3,) and acc.shape == (3,)
        else:
            assert len(call) == 3


def test_the_right_view_is_render_at_the_moved_pose(stub):
    """The right image is the view of the left camera moved by the
    baseline along its own +x, under the same intrinsics; the System gets
    bf scaled with fx, so the baseline keeps its metres."""
    run, sys_ = prepared("euroc_stereo.live")
    run._feed(4)
    cam = toy_camera(run)
    b = cam["bf"] / cam["fx"]
    assert b == pytest.approx(47.90639384423901 / 435.2046959714599)
    assert sys_.cam.bf / sys_.cam.fx == pytest.approx(b, rel=1e-6)
    lapd = run.mix["lap"]
    tex = scene.make_texture(lapd["texture_px"], lapd["texture_seed"], "cpu")
    rays = scene.ray_grid(cam, "cpu")
    R, t = lap_poses(run, 4)
    t_right = t - torch.tensor([b, 0.0, 0.0])
    want = scene.render(tex, rays, R, t_right).clamp(0, 255).to(torch.uint8)
    left = scene.render(tex, rays, R, t).clamp(0, 255).to(torch.uint8)
    for k, call in enumerate(sys_.calls):
        np.testing.assert_array_equal(call[2], want[k].numpy())
        np.testing.assert_array_equal(call[1], left[k].numpy())
        assert not np.array_equal(call[1], call[2])


def test_the_depth_is_the_rendered_point_along_each_ray(stub):
    """Each pixel's depth is the camera-frame z of the ray-surface point
    whose texture the pixel shows: the renderer's eight iterations redone
    in float64 numpy, within 1e-4 m."""
    run, sys_ = prepared("euroc_rgbd.live")
    run._feed(4)
    rays = scene.ray_grid(toy_camera(run), "cpu").double().numpy()
    R, t = (np.asarray(a, np.float64) for a in lap_poses(run, 4))
    for k, call in enumerate(sys_.calls):
        o = -R[k].T @ t[k]
        d = rays @ R[k]                       # R_wc applied to each ray
        lam = (5.0 - o[2]) / d[..., 2]
        for _ in range(8):
            x, y = o[0] + lam * d[..., 0], o[1] + lam * d[..., 1]
            lam = (scene.smooth_depth(x, y) - o[2]) / d[..., 2]
        np.testing.assert_allclose(call[2], lam, atol=1e-4, rtol=0)
        # the surface's z where the ray meets it, in the camera frame
        P = o + lam[..., None] * d
        z_cam = ((P - o) @ R[k].T)[..., 2]
        np.testing.assert_allclose(call[2], z_cam, atol=1e-4, rtol=0)


def test_the_imu_slices_cover_the_lap_once_across_the_wrap(stub):
    """A 2-s lap (40 frames, 400 samples) fed for 2.5 laps: frame j gets
    the samples in ((j - 1) / fps, j / fps], in order, each the lap's own
    at that time, and the 800 samples of frames 1..80 hold every lap
    sample exactly twice."""
    run, sys_ = prepared("euroc_mono_vi.live", lap_frames=None,
                         seconds=2.0)
    run._feed(100)
    fps, hz = run.stream.fps, run.imu_hz
    gyro, acc = scene.lap_imu(run.lap, hz, harness.settings_matrix(
        run.cell.config["settings_path"], "Camera.Tbc").reshape(4, 4))
    n = len(gyro)
    assert n == 400
    seen = np.zeros(n, int)
    times = []
    for j, call in enumerate(sys_.calls):
        ts = call[-1]
        for t, g, a in call[2]:
            assert (j - 1) / fps < t <= ts
            i = (round(t * hz) - 1) % n
            np.testing.assert_array_equal(g, gyro[i])
            np.testing.assert_array_equal(a, acc[i])
            if 1 <= j <= 80:
                seen[i] += 1
            times.append(t)
    assert (seen == 2).all()
    np.testing.assert_allclose(np.diff(times), 1.0 / hz, rtol=1e-9)


def test_a_mono_inertial_warm_up_waits_for_vins_init(stub):
    StubSystem.vi_init_after = 9
    try:
        run, sys_ = prepared("euroc_mono_vi.live", lap_frames=None)
        assert "Tbc" in sys_.kw and sys_.kw["vins_init_time"] == 15.0
        run.cell.workload["warm_frames"] = 3
        run.initialize()
        # one frame to initialize, eight more until VINS init has run
        assert run.notes["init_frames"] == 1
        assert run.notes["vi_init_frames"] == 8
        assert len(sys_.calls) == 12
        run, sys_ = prepared("euroc_mono_vi.live", lap_frames=None)
        run.cell.workload["max_vi_init_frames"] = 4
        with pytest.raises(RuntimeError, match="VINS not initialized"):
            run.initialize()
    finally:
        StubSystem.vi_init_after = 5


def test_the_metric_scale_control_misstates_the_scale(stub):
    run, sys_ = prepared("euroc_stereo.live", control="metric_scale")
    cam = toy_camera(run)
    assert sys_.cam.bf == pytest.approx(1.25 * cam["bf"], rel=1e-6)
    sound, _ = prepared("euroc_rgbd.live")
    run, _ = prepared("euroc_rgbd.live", control="metric_scale")
    np.testing.assert_allclose(run.side, 1.25 * sound.side, rtol=1e-6)
    with pytest.raises(ValueError, match="metric_scale"):
        harness.Run(toy_cell("euroc_mono.live"), SEED,
                    control="metric_scale")


def write_config(tmp_path, name, sensor=None, edit=None):
    """A copy of a test-local configuration under tmp_path, its sensor
    and its settings' text edited."""
    src = json.loads((sensor_cells.CELLS / f"{name}.json").read_text())
    text = (sensor_cells.CELLS / src["settings"]).read_text()
    (tmp_path / src["settings"]).write_text(edit(text) if edit else text)
    if sensor is not None:
        src["sensor"] = sensor
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(src))
    return harness.read_config(path)


def test_what_a_configuration_may_not_ask_is_refused(stub, tmp_path):
    cell = toy_cell("euroc_stereo.live")
    # a stereo pair with distortion is not rectified
    cell.config = write_config(tmp_path, "euroc_stereo", edit=lambda s:
                               s.replace("Camera.k1: 0.0", "Camera.k1: 0.1"))
    with pytest.raises(ValueError, match="rectified"):
        harness.Run(cell, SEED, device="cpu", scale=SCALE,
                    lap_frames=4).prepare()
    cell.config["sensor"] = "LIDAR"
    with pytest.raises(ValueError, match="sensor"):
        harness.Run(cell, SEED, device="cpu")
    # a NavState window the port does not run
    cell = toy_cell("euroc_mono_vi.live")
    cell.config = write_config(tmp_path, "euroc_mono_vi", edit=lambda s:
                               s.replace("WindowSize: 10", "WindowSize: 12"))
    with pytest.raises(ValueError, match="LocalWindowSize"):
        harness.Run(cell, SEED, device="cpu", scale=SCALE,
                    lap_frames=4).prepare()


def test_the_ports_own_checks_still_raise(tmp_path):
    """The real StereoTracker refuses a pair without its baseline."""
    cell = toy_cell("euroc_stereo.live")
    cell.config = write_config(tmp_path, "euroc_stereo", edit=lambda s:
                               s.replace("Camera.bf:", "# Camera.bf:"))
    with pytest.raises(ValueError, match="Camera.bf"):
        harness.Run(cell, SEED, device="cpu", scale=SCALE,
                    lap_frames=4).prepare()


def test_a_configuration_without_a_sensor_is_monocular():
    assert harness.sensor_of({}) == "MONOCULAR"
    assert harness.sensor_of(harness.load_cell("euroc_mono.live").config) \
        == "MONOCULAR"
