"""Monocular KITTI odometry runner (reference Examples/Monocular/
mono_kitti.cc).

    python -m ygz_tpu_torch.examples.mono_kitti <root> [--seq 00]
"""
from ..geometry.camera import Camera
from ..io.datasets import KittiOdometryDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, make_viewer,
                     print_timings)

# KITTI odometry sequence 00, left gray camera (rectified)
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                 width=1241, height=376)


def main(argv=None):
    p = base_parser("Monocular KITTI")
    p.add_argument("--seq", default="00")
    args = p.parse_args(argv)
    ds = KittiOdometryDataset(args.dataset, seq=args.seq)
    sys_ = load_system(args, Sensor.MONOCULAR, Camera.make(**KITTI_CAM))
    timer = TrackTimer()
    viewer = make_viewer(args)
    for i, fr in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        img = timer.load(fr.load)
        with timer:
            sys_.track_monocular(img, fr.t)
        viewer.update(sys_.tracker, img)
    timer.report()
    print_timings(sys_, args)
    viewer.finish(sys_.tracker)
    sys_.save_trajectory_kitti(args.out)
    print(f"trajectory -> {args.out}")
    return sys_, timer


if __name__ == "__main__":
    main()
