"""System facade: the public entry point of the PyTorch port.

Port of ``ygz_tpu/system.py`` for ``Sensor.MONOCULAR``: construction,
``track_monocular``, the TUM trajectory savers, ``trajectory``, ``map`` and
``reset``. The other sensors, batched tracking and map persistence are not
ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from .geometry import camera as cam_mod
from .frontend.tracker import MonoTracker, TrackerConfig


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    MONO_VI = 3


def rotmat_to_quat(R):
    """[3, 3] rotation -> unit quaternion [w, x, y, z] (Shepperd)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    k = int(np.argmax([tr, R[0, 0], R[1, 1], R[2, 2]]))
    if k == 0:
        w = 0.5 * np.sqrt(max(1.0 + tr, 1e-12))
        q = [w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w)]
    elif k == 1:
        x = 0.5 * np.sqrt(max(1.0 + R[0, 0] - R[1, 1] - R[2, 2], 1e-12))
        q = [(R[2, 1] - R[1, 2]) / (4 * x), x, (R[0, 1] + R[1, 0]) / (4 * x),
             (R[0, 2] + R[2, 0]) / (4 * x)]
    elif k == 2:
        y = 0.5 * np.sqrt(max(1.0 - R[0, 0] + R[1, 1] - R[2, 2], 1e-12))
        q = [(R[0, 2] - R[2, 0]) / (4 * y), (R[0, 1] + R[1, 0]) / (4 * y), y,
             (R[1, 2] + R[2, 1]) / (4 * y)]
    else:
        z = 0.5 * np.sqrt(max(1.0 - R[0, 0] - R[1, 1] + R[2, 2], 1e-12))
        q = [(R[1, 0] - R[0, 1]) / (4 * z), (R[0, 2] + R[2, 0]) / (4 * z),
             (R[1, 2] + R[2, 1]) / (4 * z), z]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def _tum_line(ts, R, t):
    Rwc = np.asarray(R).T
    twc = -Rwc @ np.asarray(t)
    q = rotmat_to_quat(Rwc)
    return (f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


class System:
    """Facade over the tracking front-end + local mapping back-end.

    Args:
      cam: geometry.camera.Camera.
      sensor: Sensor mode (MONOCULAR only, for now).
      config: TrackerConfig overrides.
      device: where the tensors live ("cuda" by default; "cpu" runs the
        plain PyTorch versions of the kernels).
    """

    def __init__(self, cam: cam_mod.Camera, sensor: Sensor = Sensor.MONOCULAR,
                 config: Optional[TrackerConfig] = None, device="cuda"):
        if sensor != Sensor.MONOCULAR:
            raise NotImplementedError(
                f"{sensor} is not ported yet: ROADMAP queue A, items 17 "
                f"(stereo and RGB-D) and 18 (mono-VI)")
        self.cam = cam
        self.sensor = sensor
        self.tracker = MonoTracker(cam, config, device=device)

    def track_monocular(self, img, timestamp: float):
        """Process one grayscale [H, W] frame (uint8 or float32 numpy).
        Returns (state_name, T_cw [4, 4]) — identity until initialized."""
        state, R, t = self.tracker.track(img, timestamp)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    def save_trajectory_tum(self, path: str):
        """TUM format (ts tx ty tz qx qy qz qw of the camera in the world)
        of the OK frames, each composed onto its reference keyframe's
        current pose."""
        with open(path, "w") as f:
            for rec in self.tracker.trajectory:
                if rec.state == "OK":
                    f.write(_tum_line(rec.ts,
                                      *self.tracker.recovered_pose(rec)))

    def save_keyframe_trajectory_tum(self, path: str):
        smap = self.tracker.map
        with open(path, "w") as f:
            for k in range(smap.n_kf):
                if smap.kf_valid[k]:
                    f.write(_tum_line(smap.kf_ts[k], smap.kf_R[k],
                                      smap.kf_t[k]))

    @property
    def trajectory(self):
        return self.tracker.trajectory

    @property
    def map(self):
        return self.tracker.map

    def reset(self):
        """Clear map and tracking state (reference System::Reset)."""
        self.tracker.reset(keep_trajectory=False)
