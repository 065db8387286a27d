"""RGB-D tracking in the torch port on the CPU: System.track_rgbd end to
end against the ground truth with the JAX test's bounds
(tests/test_rgbd_e2e.py), and one RGB-D run through both packages, frame
for frame. The depth seeds themselves are held against JAX in
test_torch_stereo.py."""
import numpy as np

from ygz_tpu.geometry import camera as jcam
from ygz_tpu.system import Sensor as JSensor, System as JSystem
from ygz_tpu_torch.eval.ate import ate_rmse
from ygz_tpu_torch.geometry.camera import Camera
from ygz_tpu_torch.system import Sensor, System
from ygz_tpu_torch.utils.synthetic import SmoothScene

from torch_parity import rot_angle_deg
from test_vo_e2e import make_trajectory


def test_port_rgbd_tracking_20_frames():
    """The JAX RGB-D end-to-end test's bounds on 20 frames of its sequence
    (SmoothScene seed 13, no Camera.bf: the virtual baseline applies)."""
    scene = SmoothScene(seed=13)
    cam = Camera.make(scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(20)
    system = System(cam, Sensor.RGBD, device="cpu")
    states = [system.track_rgbd(scene.render(R, t), scene.depth(R, t),
                                i * 0.05)[0]
              for i, (R, t) in enumerate(poses)]
    assert states[0] == "OK", "RGB-D must initialize on the first frame"
    assert states.count("OK") == len(states), states
    assert system.tracker.cam.bf == 0.08 * scene.f and system.cam.bf == 0.0

    est = np.array([-r.R.T @ r.t for r in system.trajectory])
    gt = np.array([-R.T @ t for R, t in poses])
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    assert rmse < 0.05, f"metric ATE RMSE {rmse:.4f}"
    span = np.linalg.norm(est[-1] - est[0]) / np.linalg.norm(gt[-1] - gt[0])
    assert abs(span - 1.0) < 0.05, span


def test_rgbd_matches_jax_frame_for_frame():
    """Both packages' System(Sensor.RGBD) over the same 10 frames at
    320x256: RGB-D initializes without RANSAC, so the runs agree to float32
    rounding."""
    scene = SmoothScene(seed=13, w=320, h=256, f=200.0)
    intr = (scene.f, scene.f, scene.cx, scene.cy, scene.w, scene.h)
    poses = make_trajectory(10)
    frames = [(scene.render_u8(R, t).astype(np.float32), scene.depth(R, t))
              for R, t in poses]
    jsys = JSystem(jcam.Camera.make(*intr), JSensor.RGBD)
    tsys = System(Camera.make(*intr), Sensor.RGBD, device="cpu")
    for i, (img, depth) in enumerate(frames):
        sj, Tj = jsys.track_rgbd(img, depth, i * 0.05)
        st, Tt = tsys.track_rgbd(img, depth, i * 0.05)
        assert st == sj == "OK", (i, st, sj)
        # float32 GN and BA sums in another order: ~2e-4 deg and ~5e-5 m
        # apart over 10 frames; an order of margin
        assert rot_angle_deg(Tt[:3, :3], Tj[:3, :3]) < 5e-3, i
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() < 5e-4, i
    assert tsys.map.n_kf == jsys.map.n_kf >= 2
    n_t = int(tsys.map.pt_valid[: tsys.map.n_pt].sum())
    n_j = int(jsys.map.pt_valid[: jsys.map.n_pt].sum())
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
