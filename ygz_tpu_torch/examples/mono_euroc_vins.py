"""Mono-inertial EuRoC runner (reference Examples/Monocular/
mono_euroc_vins.cc: image + IMU csv interleaving).

    python -m ygz_tpu_torch.examples.mono_euroc_vins <root> [--settings FILE]
"""
from ..geometry.camera import Camera
from ..io.datasets import EurocDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, maybe_eval_ate,
                     print_timings)
from .mono_euroc import EUROC_CAM


def main(argv=None):
    p = base_parser("Mono-inertial EuRoC")
    p.add_argument("--save-navstate", default=None, metavar="FILE",
                   help="also save the per-keyframe NavState trajectory "
                        "(reference SaveKeyFrameTrajectoryNavState)")
    args = p.parse_args(argv)
    ds = EurocDataset(args.dataset, with_imu=True)
    sys_ = load_system(args, Sensor.MONO_VI, Camera.make(**EUROC_CAM))
    timer = TrackTimer()
    for i, fr in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        img = timer.load(fr.load)
        imu = [(s.t, s.gyro, s.acc) for s in fr.imu]
        with timer:
            sys_.track_mono_vi(img, imu, fr.t)
    timer.report()
    print_timings(sys_, args)
    print("VINS initialized:", sys_.tracker.vio_ready,
          "scale:", sys_.tracker.vins_scale)
    sys_.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}")
    if args.save_navstate and sys_.tracker.vio_ready:
        sys_.save_keyframe_trajectory_navstate(args.save_navstate)
        print(f"NavState keyframe trajectory -> {args.save_navstate}")
    maybe_eval_ate(sys_, ds, args, with_scale=False)
    return sys_, timer


if __name__ == "__main__":
    main()
