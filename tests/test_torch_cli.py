"""The torch port's dataset runners end to end on the CPU: synthesized
EuRoC, TUM RGB-D and KITTI trees (frames written with the port's PNG
encoder, ground truth, settings files) driven through each runner's
main(argv) with --device cpu, as tests/test_cli_e2e.py drives the JAX
package's examples."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ygz_tpu_torch.examples import (mono_euroc, mono_euroc_vins, mono_kitti,
                                    rgbd_tum, stereo_euroc, stereo_kitti)
from ygz_tpu_torch.io.datasets import EurocDataset
from ygz_tpu_torch.utils import dataset_trees as trees
from ygz_tpu_torch.utils.synthetic import SmoothScene, pose_fn, synth_imu

import torch_parity  # noqa: F401  (caps torch threads)
from test_vo_e2e import make_trajectory

N_MONO, N_DEPTH, N_VI, VI_FPS = 25, 16, 85, 20.0
TBC_IDENTITY = """!!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]"""


def _settings(root, name, scene, fps, extra=None):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(trees.settings_yaml(scene.f, scene.f, scene.cx, scene.cy,
                                    scene.w, scene.h, fps, extra))
    return path


@pytest.fixture(scope="module")
def scene():
    return SmoothScene(seed=11)


@pytest.fixture(scope="module")
def mono_tree(tmp_path_factory, scene):
    """EuRoC layout: N_MONO frames at 20 fps along test_vo_e2e.py's path,
    its ground truth, a grid and an octree settings file."""
    root = str(tmp_path_factory.mktemp("euroc_mono"))
    poses = make_trajectory(N_MONO)
    trees.write_euroc(root, [scene.render_u8(R, t) for R, t in poses], poses)
    _settings(root, "grid.yaml", scene, 20.0)
    _settings(root, "octree.yaml", scene, 20.0,
              {"ORBextractor.keypointMode": "octree"})
    return root


@pytest.fixture(scope="module")
def stereo_views(scene):
    poses = make_trajectory(N_DEPTH)
    return poses, [tuple(np.clip(v, 0, 255).astype(np.uint8)
                         for v in scene.render_pair(R, t, 0.12))
                   for R, t in poses]


def _states(system):
    return [rec.state for rec in system.trajectory]


def _rows(path):
    return np.loadtxt(path, ndmin=2)


def _check_mono(system, out, text, n):
    states = _states(system)
    assert states[-1] == "OK" and states.count("OK") > 15, states
    assert f"tracked {n} frames: median" in text
    assert f"trajectory -> {out}" in text
    rows = _rows(out)
    assert rows.shape == (states.count("OK"), 8) and np.isfinite(rows).all()


def test_mono_euroc_runner(mono_tree, tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    viz = tmp_path / "viz"
    system, timer = mono_euroc.main(
        [mono_tree, "--settings", f"{mono_tree}/grid.yaml", "--device",
         "cpu", "--out", out, "--eval-ate", "--timings", "--viz", str(viz)])
    text = capsys.readouterr().out
    _check_mono(system, out, text, N_MONO)
    assert system.tracker.extractor.mode == "grid"
    assert system.tracker.device.type == "cpu"
    # the settings file's camera and its fps: kf_max_gap = round(fps)
    assert system.cam.fx == 400.0 and system.tracker.cfg.kf_max_gap == 20
    ate = float(text.split("ATE RMSE: ")[1].split()[0])
    assert ate < 0.045, text
    assert "7-DoF aligned" in text and "per-stage mean wall time" in text
    assert f"decoded {N_MONO} images" in text and len(timer.decode) == N_MONO
    names = sorted(p.name for p in viz.iterdir())
    assert names == ["map.png"] + [f"frame_{i:06d}.png"
                                   for i in range(30, N_MONO + 1, 30)]


def test_mono_euroc_runner_batched(mono_tree, tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    system, timer = mono_euroc.main(
        [mono_tree, "--settings", f"{mono_tree}/grid.yaml", "--device",
         "cpu", "--out", out, "--batch", "8"])
    _check_mono(system, out, capsys.readouterr().out, N_MONO)
    assert system.tracker.cfg.track_batch == 8
    # three chunks of 8 per-frame attributed, the remainder per frame
    assert len(timer.times) == N_MONO
    assert len(set(timer.times[:8])) == 1


def test_mono_euroc_runner_octree_from_settings(mono_tree, tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    system, _ = mono_euroc.main(
        [mono_tree, "--settings", f"{mono_tree}/octree.yaml", "--device",
         "cpu", "--out", out, "--eval-ate"])
    text = capsys.readouterr().out
    _check_mono(system, out, text, N_MONO)
    assert system.tracker.cfg.keypoint_mode == "octree"
    assert system.tracker.extractor.mode == "octree"
    assert float(text.split("ATE RMSE: ")[1].split()[0]) < 0.045


def test_rgbd_tum_runner(tmp_path, scene, capsys):
    root = str(tmp_path / "tum")
    poses = make_trajectory(N_DEPTH)
    rgb = []
    for R, t in poses:
        g = scene.render(R, t)
        rgb.append(np.clip(np.stack([g, 0.9 * g + 12, 1.05 * g - 6], -1),
                           0, 255).astype(np.uint8))
    trees.write_tum(root, rgb, [scene.depth(R, t) for R, t in poses], poses)
    yml = _settings(root, "tum.yaml", scene, 30.0,
                    {"DepthMapFactor": 5000.0})
    out = str(tmp_path / "traj.txt")
    system, timer = rgbd_tum.main([root, "--settings", yml, "--device",
                                   "cpu", "--out", out, "--eval-ate"])
    text = capsys.readouterr().out
    states = _states(system)
    assert states[0] == "OK" and states.count("OK") >= 0.9 * N_DEPTH
    assert f"tracked {N_DEPTH} frames" in text
    # the TUM reader carries no ground truth (as in the JAX package)
    assert "ATE" not in text
    assert len(timer.decode) == 2 * N_DEPTH
    assert _rows(out).shape == (states.count("OK"), 8)
    ok = [i for i, s in enumerate(states) if s == "OK"]
    est = np.array([-R.T @ t for R, t in (system.tracker.recovered_pose(
        system.trajectory[i]) for i in ok)])
    gt = np.array([-poses[i][0].T @ poses[i][1] for i in ok])
    # metric poses from the 16-bit depth: no scale alignment needed
    assert np.abs((est - est[0]) - (gt - gt[0])).max() < 0.02


def test_stereo_euroc_runner(tmp_path, scene, stereo_views, capsys):
    poses, pairs = stereo_views
    root = str(tmp_path / "euroc_stereo")
    trees.write_euroc(root, [a for a, _ in pairs], poses,
                      right=[b for _, b in pairs])
    yml = _settings(root, "stereo.yaml", scene, 20.0,
                    {"Camera.bf": 0.12 * scene.f})
    out = str(tmp_path / "traj.txt")
    system, _ = stereo_euroc.main([root, "--settings", yml, "--device",
                                   "cpu", "--out", out, "--eval-ate"])
    text = capsys.readouterr().out
    states = _states(system)
    assert system.cam.bf == pytest.approx(0.12 * scene.f)
    assert states[0] == "OK" and states.count("OK") >= 0.9 * N_DEPTH
    assert float(text.split("ATE RMSE: ")[1].split()[0]) < 0.03
    assert "6-DoF aligned" in text


def test_kitti_runners(tmp_path, scene, stereo_views, capsys):
    poses, pairs = stereo_views
    root = str(tmp_path / "kitti")
    trees.write_kitti(root, [a for a, _ in pairs], right=[b for _, b in pairs],
                      seq="04")
    yml = _settings(root, "kitti.yaml", scene, 10.0,
                    {"Camera.bf": 0.12 * scene.f})
    out = str(tmp_path / "mono.txt")
    system, _ = mono_kitti.main([root, "--seq", "04", "--settings", yml,
                                 "--device", "cpu", "--out", out])
    states = _states(system)
    assert states[-1] == "OK" and states.count("OK") >= N_DEPTH // 2, states
    # KITTI format: one 3x4 row per frame
    assert _rows(out).shape == (N_DEPTH, 12)
    out = str(tmp_path / "stereo.txt")
    system, _ = stereo_kitti.main([root, "--seq", "04", "--settings", yml,
                                   "--device", "cpu", "--out", out])
    states = _states(system)
    assert states[0] == "OK" and states.count("OK") >= 0.9 * N_DEPTH
    assert _rows(out).shape == (N_DEPTH, 12)
    text = capsys.readouterr().out
    assert text.count(f"tracked {N_DEPTH} frames") == 2


@pytest.fixture(scope="module")
def vi_tree(tmp_path_factory, scene):
    """tests/test_cli_e2e.py's tree: 85 frames at 20 fps along the VI
    tests' trajectory with its 200 Hz IMU, the ground truth and settings
    with bUseIMU, test.VINSInitTime 1.2 and an identity Camera.Tbc."""
    root = str(tmp_path_factory.mktemp("euroc_vi"))
    poses = [pose_fn(i / VI_FPS) for i in range(N_VI)]
    imu = [s for i in range(1, N_VI)
           for s in synth_imu((i - 1) / VI_FPS, i / VI_FPS)]
    trees.write_euroc(root, [scene.render_u8(R, t) for R, t in poses], poses,
                      fps=VI_FPS, imu=imu)
    _settings(root, "settings.yaml", scene, VI_FPS,
              {"bUseIMU": 1, "test.VINSInitTime": 1.2,
               "Camera.Tbc": TBC_IDENTITY})
    return root


def test_mono_euroc_vins_runner(vi_tree, tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    nav = str(tmp_path / "nav.txt")
    system, _ = mono_euroc_vins.main(
        [vi_tree, "--settings", f"{vi_tree}/settings.yaml", "--device", "cpu",
         "--out", out, "--eval-ate", "--save-navstate", nav])
    text = capsys.readouterr().out
    assert "VINS initialized: True" in text, text
    tr = system.tracker
    assert tr.vins_init_time == 1.2 and np.array_equal(tr.Tbc, np.eye(4))
    # every frame after the first carried its IMU samples (t <= frame t)
    frames = EurocDataset(vi_tree, with_imu=True).frames
    assert [len(f.imu) for f in frames] == [0] + [10] * (N_VI - 1)
    rows = _rows(out)
    assert len(rows) > 65, f"only {len(rows)} trajectory rows"
    assert float(text.split("ATE RMSE: ")[1].split()[0]) < 0.1
    assert "6-DoF aligned" in text
    assert _rows(nav).shape[1] == 17


def test_runner_refusals(mono_tree, tmp_path):
    # --devices 2 with --device cpu: the global BA sharded over two CPU
    # shards (the distributed BA is ported)
    system, _ = mono_euroc.main([mono_tree, "--devices", "2", "--device",
                                 "cpu", "--out", str(tmp_path / "t.txt")])
    mapper = system.tracker.mapper
    assert mapper.mesh.size == 2 and system.tracker.cfg.mesh_devices == 2
    assert _states(system)[-1] == "OK"
    mapper.global_ba(system.map)
    assert mapper._dist_ba_cache, "the sharded step did not dispatch"
    if not torch.cuda.is_available():
        # no fallback to the CPU: --device cuda (the default) raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mono_euroc.main([mono_tree])


def test_runners_import_no_jax():
    code = ("import sys\n"
            "from ygz_tpu_torch.examples import (mono_euroc, "
            "mono_euroc_vins, mono_kitti, rgbd_tum, stereo_euroc, "
            "stereo_kitti)\n"
            "import ygz_tpu_torch.viz, ygz_tpu_torch.native\n"
            "bad = [m for m in ('jax', 'ygz_tpu', 'PIL', 'yaml', "
            "'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
