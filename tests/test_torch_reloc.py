"""Relocalization and map persistence of the torch port, end to end on the CPU.

The scenarios of the JAX package's tests/test_reloc.py (track, blackout,
revisit) and tests/test_map_io.py (save the map, load it into a fresh
session in localization-only mode, relocalize into it and track), on the
same synthetic sequence (SmoothScene seed 11, tests/test_vo_e2e.py's
trajectory), held to those tests' bounds. One 30-frame mapping run serves
both.
"""
import numpy as np
import pytest

from ygz_tpu_torch.frontend.tracker import TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

import torch_parity  # noqa: F401  (caps torch threads)
from test_vo_e2e import make_trajectory

N_TRACK = 30


def _camera(scene):
    return Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                       scene.h)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """30 tracked frames with the default config (BoW, relocalization and
    loop closing on, the shipped vocabulary), the map saved after them."""
    scene = SmoothScene(seed=11)
    poses = make_trajectory(36)
    imgs = [scene.render(R, t) for R, t in poses]
    system = System(_camera(scene), Sensor.MONOCULAR,
                    config=TrackerConfig(kf_max_gap=4), device="cpu")
    states = [system.track_monocular(imgs[i], i * 0.05)[0]
              for i in range(N_TRACK)]
    path = tmp_path_factory.mktemp("map") / "session.npz"
    system.save_map(str(path))
    return scene, poses, imgs, system, states, path


def test_relocalization_after_blackout(mapped):
    scene, poses, imgs, system, states, _ = mapped
    assert states[-1] == "OK", states
    # past the reset-on-early-loss gate of 5 keyframes
    assert system.map.n_kf > 5, system.map.n_kf
    tr = system.tracker
    assert tr.bow_index is not None and tr.loop_closer is not None
    # every alive keyframe is in the BoW index, and detect ran once per
    # keyframe after the initial two
    n = system.map.n_kf
    np.testing.assert_array_equal(tr.bow_index.kf_valid[:n],
                                  system.map.kf_valid[:n])
    assert tr.loop_closer.n_detect == n - 2

    black = np.zeros_like(imgs[0])
    for j in range(3):
        state, _ = system.track_monocular(black, (N_TRACK + j) * 0.05)
    assert state == "LOST"

    # a view close to an already-mapped pose: must relocalize
    c_err = None
    for j in range(3):
        state, T = system.track_monocular(imgs[12], (N_TRACK + 3 + j) * 0.05)
        if state == "OK":
            R_gt, t_gt = poses[12]
            c_gt = -R_gt.T @ t_gt
            c_est = -T[:3, :3].T @ T[:3, 3]
            # up to map scale: the map's median depth stands for the scene's
            # ~5 units (the JAX test's comparison)
            smap = system.map
            ids = np.nonzero(smap.pt_valid[: smap.n_pt])[0]
            s = np.median(smap.pt_xyz[ids, 2]) / 5.0
            c_err = np.linalg.norm(c_est - c_gt * s)
            break
    assert c_err is not None, "did not relocalize"
    assert c_err < 0.05, f"reloc pose error {c_err}"


def test_localization_from_saved_map(mapped):
    scene, poses, imgs, first, _, path = mapped
    system = System(_camera(scene), Sensor.MONOCULAR, device="cpu")
    system.load_map(str(path))
    assert system.tracker.state.name == "LOST"
    n_kf_before = system.map.n_kf
    # the first session's own estimates share the map frame and scale
    ref = {round(r.ts, 6): -r.R.T @ r.t for r in first.trajectory[:N_TRACK]
           if r.state == "OK"}
    states, errs = [], []
    for i in range(10, 28):
        state, T = system.track_monocular(imgs[i], i * 0.05)
        states.append(state)
        key = round(i * 0.05, 6)
        if state == "OK" and key in ref:
            errs.append(np.linalg.norm(-T[:3, :3].T @ T[:3, 3] - ref[key]))
    assert states[0] == "OK", states      # relocalized on the first frame
    assert states.count("OK") >= 12, states
    # localization-only: the frozen map grew no keyframes
    assert system.map.n_kf == n_kf_before
    assert np.median(errs) < 0.05, (np.median(errs), errs[:5])
