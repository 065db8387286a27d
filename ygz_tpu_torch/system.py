"""System facade: the public entry point of the PyTorch port.

Port of ``ygz_tpu/system.py`` for all four sensors: construction,
``track_monocular``, the batched ``track_monocular_batch``,
``track_stereo``, ``track_rgbd``, ``track_mono_vi``, the TUM, KITTI and
keyframe-NavState trajectory savers, ``trajectory``, ``map``, ``reset``,
``shutdown`` (drains the async mapping worker), map save/load (a loaded map
is entered through relocalization) and the localization-only mode.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from .backend.bow import BowIndex, Vocabulary
from .backend.loopclosing import LoopCloser
from .backend.mapstate import SlamMap
from .geometry import camera as cam_mod
from .frontend.tracker import (MonoTracker, RgbdTracker, State,
                               StereoTracker, TrackerConfig)
from .frontend.vi_tracker import MonoViTracker


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
      sensor: Sensor mode (STEREO needs Camera.bf = baseline * fx and a
        rectified, undistorted pair).
      config: TrackerConfig overrides.
      Tbc: MONO_VI only: [4, 4] camera pose in the body (IMU) frame
        (identity by default).
      device: where the tensors live ("cuda" by default; "cpu" runs the
        plain PyTorch versions of the kernels).
      **vi_kwargs: MONO_VI only: MonoViTracker's gravity_mag,
        vins_init_kfs, vins_init_time.
    """

    def __init__(self, cam: cam_mod.Camera, sensor: Sensor = Sensor.MONOCULAR,
                 config: Optional[TrackerConfig] = None, Tbc=None,
                 device="cuda", **vi_kwargs):
        self.cam = cam
        self.sensor = sensor
        if sensor == Sensor.MONO_VI:
            self.tracker = MonoViTracker(cam, config, Tbc=Tbc, device=device,
                                         **vi_kwargs)
            return
        trackers = {Sensor.MONOCULAR: MonoTracker, Sensor.RGBD: RgbdTracker,
                    Sensor.STEREO: StereoTracker}
        self.tracker = trackers[sensor](cam, config, device=device)

    @staticmethod
    def _result(state, R, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return state.name, T

    def track_monocular(self, img, timestamp: float):
        """Process one grayscale [H, W] frame (uint8 or float32 numpy).
        Returns (state_name, T_cw [4, 4]) — identity until initialized."""
        return self._result(*self.tracker.track(img, timestamp))

    def track_monocular_batch(self, imgs, timestamps):
        """Monocular tracking of consecutive frames in chunks of
        TrackerConfig.track_batch (MonoTracker.track_batch). Returns a list
        of (state_name, T_cw [4, 4]) per frame."""
        return [self._result(*r)
                for r in self.tracker.track_batch(imgs, timestamps)]

    def track_stereo(self, img_left, img_right, timestamp: float):
        """Stereo entry point (reference System::TrackStereo): a rectified,
        undistorted [H, W] pair; Camera.bf must be set. Returns what
        track_monocular returns."""
        return self._result(*self.tracker.track(img_left, timestamp,
                                                right=img_right))

    def track_rgbd(self, img, depth, timestamp: float):
        """RGB-D entry point (reference System::TrackRGBD): `depth` is a
        metric [H, W] depth map aligned with `img`. Returns what
        track_monocular returns."""
        return self._result(*self.tracker.track(img, timestamp, depth=depth))

    def track_mono_vi(self, img, imu, timestamp: float):
        """Mono-inertial entry point (reference System::TrackMonoVI): `imu`
        is an iterable of (t, gyro[3], acc[3]) samples since the previous
        frame. Returns what track_monocular returns (metric once VINS
        initialization has run)."""
        return self._result(*self.tracker.track(img, timestamp, imu=imu))

    def save_trajectory_tum(self, path: str):
        """TUM format (ts tx ty tz qx qy qz qw of the camera in the world)
        of the OK frames, each composed onto its reference keyframe's
        current pose."""
        with open(path, "w") as f:
            for rec in self.tracker.trajectory:
                if rec.state == "OK":
                    f.write(_tum_line(rec.ts,
                                      *self.tracker.recovered_pose(rec)))

    def save_trajectory_kitti(self, path: str):
        """KITTI format: one row-major 3x4 [R|t] of T_wc per frame."""
        with open(path, "w") as f:
            for rec in self.tracker.trajectory:
                R, t = self.tracker.recovered_pose(rec)
                Rwc = np.asarray(R).T
                twc = -Rwc @ np.asarray(t)
                vals = np.concatenate([Rwc, twc[:, None]], 1).reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    def save_keyframe_trajectory_tum(self, path: str):
        smap = self.tracker.map
        with open(path, "w") as f:
            for k in range(smap.n_kf):
                if smap.kf_valid[k]:
                    f.write(_tum_line(smap.kf_ts[k], smap.kf_R[k],
                                      smap.kf_t[k]))

    def save_keyframe_trajectory_navstate(self, path: str):
        """Mono-VI only: per-keyframe body NavState 'ts px py pz qx qy qz qw
        vx vy vz bgx bgy bgz bax bay baz' (reference
        System::SaveKeyFrameTrajectoryNavState)."""
        tr = self.tracker
        if not getattr(tr, "vio_ready", False):
            raise RuntimeError("NavState trajectory requires the MONO_VI "
                               "tracker after VINS initialization")
        smap = tr.map
        with open(path, "w") as f:
            for k in sorted(tr._kf_ns):
                if k >= smap.n_kf or not smap.kf_valid[k]:
                    continue
                P, V, R_wb = tr._kf_ns[k]
                q = rotmat_to_quat(R_wb)  # [w, x, y, z]
                vals = [smap.kf_ts[k], *P, q[1], q[2], q[3], q[0], *V,
                        *tr.bg, *tr.ba]
                f.write(" ".join(f"{v:.7f}" for v in vals) + "\n")

    @property
    def trajectory(self):
        return self.tracker.trajectory

    @property
    def map(self):
        return self.tracker.map

    def reset(self):
        """Clear map and tracking state (reference System::Reset)."""
        self.tracker.reset(keep_trajectory=False)

    def shutdown(self):
        """Drain the async mapping worker, if one runs, and raise its error
        (reference System::Shutdown joins LocalMapping)."""
        if self.tracker._map_worker is not None:
            self.tracker.wait_mapping_idle()

    # ------------------------------------------------------------ persistence
    def save_map(self, path: str):
        """Serialize the map + place-recognition state to one .npz, in the
        JAX package's layout (the reference never implemented SaveMap)."""
        tr = self.tracker
        extra = {}
        if tr.bow_index is not None:
            v = tr.bow_index.vocab
            extra = {"bow_words": v.words, "bow_groups": v.groups,
                     "bow_idf": v.idf,
                     "bow_meta": np.array([v.branching, v.depth], np.int64),
                     "bow_kf_wid": tr.bow_index.kf_wid,
                     "bow_kf_w": tr.bow_index.kf_w,
                     "bow_kf_feat_word": tr.bow_index.kf_feat_word,
                     "bow_kf_valid": tr.bow_index.kf_valid}
            if v.tree_centers is not None and len(v.tree_centers):
                extra.update(bow_tree_centers=v.tree_centers,
                             bow_tree_child=v.tree_child,
                             bow_tree_root=np.int64(v.tree_root))
        tr.map.save(path, extra=extra)

    def load_map(self, path: str, localization_only: bool = True):
        """Restore a saved map into the tracker. The session starts LOST and
        enters the map through BoW + PnP relocalization on its first frames;
        by default the map stays frozen (localization-only mode)."""
        tr = self.tracker
        loaded = SlamMap.load(path)
        if loaded.n_kf == 0 or not loaded.kf_valid[: loaded.n_kf].any():
            raise ValueError(f"{path}: map has no valid keyframes "
                             "(saved before initialization?)")
        tr.map = loaded
        # device copies of the old map's feature rows are keyed by keyframe
        # id and version, which the loaded map reuses
        tr.mapper._dev_feats.clear()
        z = np.load(path)
        if "bow_kf_vec" in z or "bow_kf_words" in z:
            raise ValueError(
                f"{path}: checkpoint predates the sparse-BoW format "
                "(found dense bow_kf_vec/bow_kf_words keys); re-save the "
                "map with this version to upgrade")
        if "bow_words" in z:
            tree = {}
            if "bow_tree_centers" in z:
                tree = dict(tree_centers=np.array(z["bow_tree_centers"]),
                            tree_child=np.array(z["bow_tree_child"]),
                            tree_root=int(z["bow_tree_root"]))
            vocab = Vocabulary(words=z["bow_words"], groups=z["bow_groups"],
                               idf=z["bow_idf"],
                               branching=int(z["bow_meta"][0]),
                               depth=int(z["bow_meta"][1]), **tree)
            tr.bow_index = BowIndex(vocab, max_kf=len(z["bow_kf_valid"]),
                                    device=tr.device)
            tr.bow_index.kf_wid = np.array(z["bow_kf_wid"])
            tr.bow_index.kf_w = np.array(z["bow_kf_w"])
            tr.bow_index.kf_feat_word = np.array(z["bow_kf_feat_word"])
            tr.bow_index.kf_valid = np.array(z["bow_kf_valid"])
            tr.loop_closer = LoopCloser(tr.bow_index, tr.cam,
                                        device=tr.device)
        tr.state = State.LOST  # re-enter via relocalization
        tr._last_kf = int(np.nonzero(tr.map.kf_valid[: tr.map.n_kf])[0][-1])
        tr._last_R = np.eye(3, dtype=np.float32)
        tr._last_t = np.zeros(3, np.float32)
        tr._rebuild_cache()
        tr.localization_only = localization_only

    def activate_localization_mode(self):
        """Track against the frozen map, stop mapping (reference
        System::ActivateLocalizationMode)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False
