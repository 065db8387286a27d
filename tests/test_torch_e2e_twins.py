"""Slow end-to-end twins of the JAX package's long runs, through the port on
the CPU: the 400-frame endurance run (test_long_sequence.py) through the
port's tool, the nuisanced mono and RGB-D runs (test_robust_e2e.py) at
their bounds, the 50-frame VO run (test_vo_e2e.py) tracked by both
packages on the same frames, the port's ATE beside the JAX run's, and the
keyframe decisions of both packages on the nuisanced loop circuit with
the JAX reference count (the witness for C-ref15)."""
import importlib.util
import os

import numpy as np
import pytest

from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.tools import long_sequence
from ygz_tpu_torch.utils.synthetic import Nuisance, SmoothScene

import torch_parity  # noqa: F401  (caps torch threads)
from test_vo_e2e import make_trajectory


def _logged_ate(system, poses, with_scale):
    """ATE of the logged poses of the OK frames, as the JAX tests read
    them (rec.R, rec.t)."""
    est = [-rec.R.T @ rec.t for rec in system.trajectory if rec.state == "OK"]
    gt = [-R.T @ t for rec, (R, t) in zip(system.trajectory, poses)
          if rec.state == "OK"]
    return ate_rmse(np.array(est), np.array(gt), with_scale=with_scale)[0]


@pytest.mark.slow
def test_port_long_sequence_400(tmp_path):
    res = long_sequence.main(["--frames", "400", "--device", "cpu",
                              "--out", str(tmp_path / "longrun.json")])
    assert res["ok_fraction"] > 0.9, res
    assert res["ate_rmse_7dof"] < 0.25, res
    # the tail kept up: what remains queued at the end drains in seconds
    assert res["mapping_drain_s"] < 30.0, res


@pytest.mark.slow
@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_port_robust_e2e(sensor):
    """test_robust_e2e.py through the port: mono under nuisances at the
    0.09 bound (twice the clean 0.045; the JAX run measures 0.3212 there),
    RGB-D at its 0.06 metric bound."""
    if sensor == "mono":
        scene, nuis, n, sens = SmoothScene(seed=11), Nuisance(seed=3), 50, \
            Sensor.MONOCULAR
    else:
        scene, nuis, n, sens = SmoothScene(seed=13), \
            Nuisance(seed=5, n_occluders=1), 40, Sensor.RGBD
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(n)
    system = System(cam, sens, device="cpu")
    states = []
    for i, (R, t) in enumerate(poses):
        img = nuis.apply(scene.render(R, t), i)
        if sensor == "mono":
            states.append(system.track_monocular(img, i * 0.05)[0])
        else:
            # the depth stays clean (sensor domain)
            states.append(system.track_rgbd(img, scene.depth(R, t),
                                            i * 0.05)[0])
    n_ok = sum(s == "OK" for s in states)
    rmse = _logged_ate(system, poses, with_scale=sensor == "mono")
    print(f"{sensor} under nuisances: {n_ok}/{n} OK, ATE RMSE {rmse:.4f}")
    if sensor == "mono":
        assert n_ok > 35, states
        assert states[-1] == "OK", states[-10:]
        assert rmse < 0.09, f"ATE RMSE {rmse:.4f} under nuisances"
    else:
        assert n_ok > 30, states
        assert rmse < 0.06, f"metric ATE RMSE {rmse:.4f} under nuisances"


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12, 13, 14, 15, 16])
def test_port_vo_50_frames_beside_jax(seed):
    """test_vo_e2e.py's 50 frames (its scene seed 11, and five more),
    rendered once, through both packages' System(MONOCULAR) with the
    default configuration: each within the JAX test's bounds (> 35 OK,
    last OK, ATE < 0.045), and the port's ATE at most twice the JAX run's
    plus 0.002. Over the six seeds the port read 0.50-1.98x the JAX ATE
    (the most at seed 11: 0.0096 against 0.0048)."""
    from ygz_tpu.geometry import camera as jcam
    from ygz_tpu.system import Sensor as JSensor, System as JSystem

    scene = SmoothScene(seed=seed)
    poses = make_trajectory(50)
    frames = [scene.render(R, t) for R, t in poses]
    port = System(Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                              scene.h), Sensor.MONOCULAR, device="cpu")
    ref = JSystem(jcam.Camera.make(scene.f, scene.f, scene.cx, scene.cy,
                                   scene.w, scene.h), JSensor.MONOCULAR)
    rmse = {}
    for name, system in (("port", port), ("jax", ref)):
        states = [system.track_monocular(img, timestamp=i * 0.05)[0]
                  for i, img in enumerate(frames)]
        assert sum(s == "OK" for s in states) > 35, (name, states)
        assert states[-1] == "OK", (name, states[-10:])
        rmse[name] = _logged_ate(system, poses, with_scale=True)
        assert rmse[name] < 0.045, (name, rmse)
    print(f"ATE RMSE over the 50 frames: port {rmse['port']:.4f}, JAX "
          f"{rmse['jax']:.4f}")
    assert rmse["port"] < 2.0 * rmse["jax"] + 0.002, rmse


@pytest.mark.slow
def test_weak_keyframe_stall_beside_jax(monkeypatch):
    """ate_report's nuisanced 640-frame circuit (async worker, batches of
    8) through both packages with the JAX reference count: the port's
    C-ref15 refresh is undone after each tail. In the JAX package a
    keyframe made under weak tracking holds c2 shut until kf_max_gap while
    the tracker sees at least twice its points; the port does the same
    without the refresh. The port's run with its refresh is printed
    beside them."""
    from ygz_tpu.frontend import tracker as jtracker
    from ygz_tpu_torch.frontend import tracker as ptracker
    from ygz_tpu_torch.tools import ate_report

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_ate_report", os.path.join(root, "tools", "ate_report.py"))
    jax_ate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_ate)

    def run_logged(name, cls, run):
        with ate_report.keyframe_log(cls) as (created, decided):
            run()
        stalls[name] = ate_report.weak_keyframe_stalls(
            created, decided, ptracker.TrackerConfig().kf_max_gap)
        print(f"{name}: {len(created)} keyframes, "
              f"{sum(n < 50 for _, n in created)} under weak tracking; "
              f"stalls (frame, points, gap, median inliers) {stalls[name]}")

    stalls = {}
    port_run = lambda: ate_report.run_mono_loop(True, "cpu")  # noqa: E731
    run_logged("port (refreshed count)", ptracker.MonoTracker, port_run)
    tail = ptracker.MonoTracker._mapping_tail

    def tail_with_jax_count(self, smap, kf, pyr):
        with self._map_lock:
            count = self._kf_ref_tracked
            tail(self, smap, kf, pyr)
            self._kf_ref_tracked = count

    monkeypatch.setattr(ptracker.MonoTracker, "_mapping_tail",
                        tail_with_jax_count)
    run_logged("jax", jtracker.MonoTracker,
               lambda: jax_ate.run_mono_loop(True))
    run_logged("port (JAX count)", ptracker.MonoTracker, port_run)
    assert stalls["jax"], stalls
    assert stalls["port (JAX count)"], stalls
