"""The distributed BA as a product path of the torch port, on the CPU (the
twin of tests/test_dist_e2e.py): a tracking run configured with
TrackerConfig(mesh_devices=2) builds its mapper on a 2-shard mesh, runs the
map-wide optimization through the landmark-block-sharded step, and gives
the trajectory of the dense configuration within that test's bound."""
import numpy as np
import torch

from ygz_tpu_torch.frontend.tracker import TrackerConfig
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.geometry.lie import so3_exp
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

import torch_parity  # noqa: F401  (caps torch threads)

N = 60


def pose(i):
    yaw = 0.02 * np.sin(i * 0.3)
    R = so3_exp(torch.tensor([0.0, yaw, 0.0])).numpy()
    c = np.array([0.035 * i, 0.1 * np.sin(i * 0.13), 0.0], np.float32)
    return R, (-R @ c).astype(np.float32)


def _run(mesh_devices):
    scene = SmoothScene(seed=21, w=480, h=360, f=600.0, tex_size=2000)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w,
                      scene.h)
    sys_ = System(cam, Sensor.MONOCULAR, device="cpu",
                  config=TrackerConfig(kf_max_gap=8,
                                       mesh_devices=mesh_devices))
    for i in range(N):
        R, t = pose(i)
        sys_.track_monocular(scene.render(R, t), timestamp=i * 0.05)
    assert sys_.tracker.state.name == "OK"
    # map-wide optimization through the product path (the global BA the
    # loop closer and VINS init call; with a mesh, the sharded step)
    sys_.tracker.mapper.global_ba(sys_.tracker.map)
    est = []
    for r in sys_.trajectory:
        if r.state == "OK":
            R, t = sys_.tracker.recovered_pose(r)
            est.append(-R.T @ t)
    return sys_, np.asarray(est)


def test_mesh_configured_system_matches_single_device():
    sys1, est1 = _run(mesh_devices=0)
    sys2, est2 = _run(mesh_devices=2)
    assert sys1.tracker.mapper.mesh is None
    assert sys2.tracker.mapper.mesh.size == 2
    assert sys2.tracker.mapper._dist_ba_cache, \
        "global BA never dispatched the distributed step"
    m = min(len(est1), len(est2))
    assert m > 0.9 * N
    span = np.linalg.norm(est1[-1] - est1[0])
    err = np.linalg.norm(est1[:m] - est2[:m], axis=1).max()
    # identical tracking; only the final global BA differs (dense solve vs
    # distributed PCG)
    assert err < 0.05 * span + 5e-3, (err, span)
