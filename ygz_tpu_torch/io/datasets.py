"""Dataset harnesses: EuRoC, TUM-RGBD, KITTI odometry.

Port of ``ygz_tpu/io/datasets.py``: reusable iterators in place of the
reference's example mains' loaders (Examples/Monocular/mono_euroc_vins.cc:
image list + IMU csv interleaving; mono_tum.cc; mono_kitti.cc). Images load
as [H, W] float32 grayscale through ``native`` (libpng, or ``io/png.py``
where it did not build); depth maps through ``io/png.py``. No PIL, no
OpenCV.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np


def load_gray(path: str) -> np.ndarray:
    """[H, W] float32 gray: libpng where it built, io/png.py otherwise."""
    from .. import native

    return native.decode_gray(path)


@dataclass
class ImuSample:
    t: float
    gyro: np.ndarray  # [3] rad/s
    acc: np.ndarray   # [3] m/s^2


@dataclass
class FrameItem:
    t: float
    img_path: str
    depth_path: Optional[str] = None
    imu: List[ImuSample] = field(default_factory=list)

    def load(self) -> np.ndarray:
        return load_gray(self.img_path)

    def load_depth(self, factor: float = 5000.0) -> np.ndarray:
        """[H, W] float32 metric depth of a 16-bit PNG (raw / factor)."""
        from .png import read_png

        return read_png(self.depth_path).astype(np.float32) / factor


class EurocDataset:
    """EuRoC MAV format: <root>/mav0/{cam0,cam1,imu0,state_groundtruth...}.

    Frames carry the IMU samples since the previous frame (the interleaving
    semantics of mono_euroc_vins.cc:97-133: samples with t <= frame t).
    """

    def __init__(self, root: str, cam: str = "cam0", with_imu: bool = False):
        self.root = root
        mav = os.path.join(root, "mav0")
        if not os.path.isdir(mav):
            mav = root  # allow pointing directly at mav0
        self.cam_dir = os.path.join(mav, cam, "data")
        self.frames: List[FrameItem] = []
        cam_csv = os.path.join(mav, cam, "data.csv")
        rows = self._read_csv(cam_csv)
        for ts_ns, fname in rows:
            self.frames.append(FrameItem(
                t=float(ts_ns) * 1e-9,
                img_path=os.path.join(self.cam_dir, fname)))
        if with_imu:
            self._attach_imu(os.path.join(mav, "imu0", "data.csv"))
        self.gt = self._load_gt(os.path.join(
            mav, "state_groundtruth_estimate0", "data.csv"))

    @staticmethod
    def _read_csv(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                out.append((int(parts[0]), parts[1].strip()))
        return out

    def _attach_imu(self, path):
        samples = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = [float(x) for x in line.split(",")]
                samples.append(ImuSample(t=p[0] * 1e-9,
                                         gyro=np.array(p[1:4], np.float32),
                                         acc=np.array(p[4:7], np.float32)))
        si = 0
        for fr in self.frames:
            while si < len(samples) and samples[si].t <= fr.t:
                fr.imu.append(samples[si])
                si += 1

    @staticmethod
    def _load_gt(path):
        if not os.path.exists(path):
            return None
        ts, xyz = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                p = line.split(",")
                ts.append(float(p[0]) * 1e-9)
                xyz.append([float(p[1]), float(p[2]), float(p[3])])
        return np.array(ts), np.array(xyz)

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[FrameItem]:
        return iter(self.frames)


class TumRgbdDataset:
    """TUM RGB-D format: rgb.txt / depth.txt with `timestamp path` rows;
    rgb-depth association by nearest timestamp (scripts/associate.py
    semantics, max_difference 0.02 s)."""

    def __init__(self, root: str, with_depth: bool = True, max_dt: float = 0.02):
        self.root = root
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        self.frames: List[FrameItem] = []
        if with_depth and os.path.exists(os.path.join(root, "depth.txt")):
            depth = self._read_list(os.path.join(root, "depth.txt"))
            dts = np.array([t for t, _ in depth])
            used = set()
            for t, p in rgb:
                j = int(np.argmin(np.abs(dts - t)))
                if abs(dts[j] - t) <= max_dt and j not in used:
                    used.add(j)
                    self.frames.append(FrameItem(
                        t=t, img_path=os.path.join(root, p),
                        depth_path=os.path.join(root, depth[j][1])))
        else:
            for t, p in rgb:
                self.frames.append(FrameItem(t=t,
                                             img_path=os.path.join(root, p)))

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, p = line.split()[:2]
                out.append((float(t), p))
        return out

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        return iter(self.frames)


class KittiOdometryDataset:
    """KITTI odometry: <root>/sequences/<seq>/{image_0,times.txt}."""

    def __init__(self, root: str, seq: str = "00", cam: str = "image_0"):
        seq_dir = os.path.join(root, "sequences", seq)
        if not os.path.isdir(seq_dir):
            seq_dir = root
        with open(os.path.join(seq_dir, "times.txt")) as f:
            times = [float(x) for x in f.read().split()]
        img_dir = os.path.join(seq_dir, cam)
        self.frames = [FrameItem(t=t, img_path=os.path.join(
            img_dir, f"{i:06d}.png")) for i, t in enumerate(times)]

    def __len__(self):
        return len(self.frames)

    def __iter__(self):
        return iter(self.frames)
