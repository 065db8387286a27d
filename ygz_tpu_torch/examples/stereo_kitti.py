"""Stereo KITTI odometry runner (reference Examples/Stereo/stereo_kitti.cc).

    python -m ygz_tpu_torch.examples.stereo_kitti <root> [--seq 00]

KITTI grayscale pairs are rectified; the default intrinsics and baseline
are the sequence-00 calibration (fx 718.856, baseline 0.5372 m -> bf
386.1448).
"""
from ..geometry.camera import Camera
from ..io.datasets import KittiOdometryDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, make_viewer,
                     maybe_eval_ate, print_timings)
from .mono_kitti import KITTI_CAM


def main(argv=None):
    p = base_parser("Stereo KITTI")
    p.add_argument("--seq", default="00")
    p.add_argument("--bf", type=float, default=386.1448)
    args = p.parse_args(argv)
    left = KittiOdometryDataset(args.dataset, seq=args.seq, cam="image_0")
    right = KittiOdometryDataset(args.dataset, seq=args.seq, cam="image_1")
    sys_ = load_system(args, Sensor.STEREO,
                       Camera.make(**KITTI_CAM, bf=args.bf))
    timer = TrackTimer()
    viewer = make_viewer(args)
    for i in range(min(len(left), len(right))):
        if args.max_frames and i >= args.max_frames:
            break
        img = timer.load(left.frames[i].load)
        img_r = timer.load(right.frames[i].load)
        with timer:
            sys_.track_stereo(img, img_r, left.frames[i].t)
        viewer.update(sys_.tracker, img)
    timer.report()
    print_timings(sys_, args)
    viewer.finish(sys_.tracker)
    sys_.save_trajectory_kitti(args.out)
    print(f"trajectory -> {args.out}")
    maybe_eval_ate(sys_, left, args, with_scale=False)
    return sys_, timer


if __name__ == "__main__":
    main()
