"""RGB-D TUM runner (reference Examples/RGB-D/rgbd_tum.cc).

    python -m ygz_tpu_torch.examples.rgbd_tum <root> [--depth-factor 5000]
"""
from ..geometry.camera import Camera
from ..io.datasets import TumRgbdDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, make_viewer,
                     maybe_eval_ate, print_timings)

# TUM fr1 (Examples/RGB-D/TUM1.yaml)
TUM_CAM = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
               width=640, height=480,
               dist=[0.262383, -0.953104, -0.005358, 0.002628, 1.163314])


def main(argv=None):
    p = base_parser("RGB-D TUM")
    p.add_argument("--depth-factor", type=float, default=5000.0)
    args = p.parse_args(argv)
    ds = TumRgbdDataset(args.dataset)
    sys_ = load_system(args, Sensor.RGBD, Camera.make(**TUM_CAM))
    timer = TrackTimer()
    viewer = make_viewer(args)
    for i, fr in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        img = timer.load(fr.load)
        depth = timer.load(fr.load_depth, args.depth_factor)
        with timer:
            sys_.track_rgbd(img, depth, fr.t)
        viewer.update(sys_.tracker, img)
    timer.report()
    print_timings(sys_, args)
    viewer.finish(sys_.tracker)
    sys_.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}")
    maybe_eval_ate(sys_, ds, args, with_scale=False)
    return sys_, timer


if __name__ == "__main__":
    main()
