"""End-to-end monocular VO of the torch port on the CPU: System.track_monocular
with the default configuration (BoW, relocalization and loop closing on)
over the first 30 frames of the JAX package's synthetic VO sequence
(tests/test_vo_e2e.py, SmoothScene seed 11), held to that test's ATE bound."""
import numpy as np
import pytest

from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.frontend.tracker import (RgbdTracker, StereoTracker,
                                            TrackerConfig)
from ygz_tpu_torch.frontend.vi_tracker import MonoViTracker
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

import torch_parity  # noqa: F401  (caps torch threads)
from test_vo_e2e import make_trajectory


def test_port_mono_vo_30_frames(tmp_path):
    scene = SmoothScene(seed=11)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(30)
    system = System(cam, Sensor.MONOCULAR, device="cpu")
    states = [system.track_monocular(scene.render(R, t), i * 0.05)[0]
              for i, (R, t) in enumerate(poses)]
    assert "OK" in states, states
    assert sum(s == "OK" for s in states) > 20, states
    assert states[-1] == "OK", states[-5:]
    assert system.map.n_kf >= 3, "no keyframe after the initial two"

    est, gt = [], []
    for rec, (R, t) in zip(system.trajectory, poses):
        if rec.state == "OK":
            Rr, tr = system.tracker.recovered_pose(rec)
            est.append(-Rr.T @ tr)
            gt.append(-R.T @ t)
    rmse, _ = ate_rmse(np.array(est), np.array(gt), with_scale=True)
    assert rmse < 0.045, f"ATE RMSE {rmse:.4f}"

    smap = system.map
    pts = smap.pt_xyz[: smap.n_pt][smap.pt_valid[: smap.n_pt]]
    assert len(pts) > 100
    z = pts[:, 2]
    assert np.mean((z > 0.5 * np.median(z)) & (z < 2 * np.median(z))) > 0.95

    path = tmp_path / "traj.txt"
    system.save_trajectory_tum(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (len(est), 8) and np.isfinite(rows).all()
    path = tmp_path / "kf_traj.txt"
    system.save_keyframe_trajectory_tum(str(path))
    rows = np.loadtxt(path)
    assert rows.shape == (int(smap.kf_valid[: smap.n_kf].sum()), 8)
    assert np.isfinite(rows).all()


def test_port_rejects_unported_settings():
    scene = SmoothScene(seed=0, w=64, h=48, f=40.0, tex_size=64)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    for cfg, item in ((TrackerConfig(keypoint_mode="octree"), "A3"),
                      (TrackerConfig(mesh_devices=2), "A8")):
        with pytest.raises(NotImplementedError, match=item):
            System(cam, Sensor.MONOCULAR, config=cfg, device="cpu")
    # mono-VI is ported: the VI tracker, with the rig and its settings
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, 3] = [0.02, 0.0, -0.01]
    vi = System(cam, Sensor.MONO_VI, Tbc=Tbc, device="cpu",
                vins_init_kfs=6).tracker
    assert isinstance(vi, MonoViTracker) and not vi.vio_ready
    assert vi.vins_init_kfs == 6 and np.array_equal(vi.Tbc, Tbc)
    assert vi.device.type == "cpu" and not vi.cfg.enable_loop_closing
    # stereo and RGB-D are ported; stereo needs the rig's Camera.bf (its
    # depths are bf / disparity), RGB-D without it gets the JAX package's
    # virtual 0.08 m baseline
    with pytest.raises(ValueError, match="Camera.bf"):
        System(cam, Sensor.STEREO, device="cpu")
    stereo_cam = cam._replace(bf=0.11 * cam.fx)
    stereo = System(stereo_cam, Sensor.STEREO, device="cpu").tracker
    assert isinstance(stereo, StereoTracker) and stereo.cam == stereo_cam
    rgbd = System(cam, Sensor.RGBD, device="cpu").tracker
    assert type(rgbd) is RgbdTracker and rgbd.cam.bf == 0.08 * cam.fx
    # the JAX package's default configuration is ported
    cfg = System(cam, Sensor.MONOCULAR, device="cpu").tracker.cfg
    assert cfg.enable_loop_closing and cfg.enable_relocalization
    assert cfg.vocab_path == "auto"
