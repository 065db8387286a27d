"""Stereo EuRoC runner (reference Examples/Stereo/stereo_euroc.cc).

    python -m ygz_tpu_torch.examples.stereo_euroc <root> [--bf BF]

Expects rectified pairs: rectify raw EuRoC data first, or provide
rectified cam0/cam1 directories.
"""
from ..geometry.camera import Camera
from ..io.datasets import EurocDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, maybe_eval_ate,
                     print_timings)


def main(argv=None):
    p = base_parser("Stereo EuRoC")
    p.add_argument("--bf", type=float, default=47.90639384423901,
                   help="baseline * fx (EuRoC default)")
    args = p.parse_args(argv)
    left = EurocDataset(args.dataset, cam="cam0")
    right = EurocDataset(args.dataset, cam="cam1")
    default_cam = Camera.make(435.2046959714599, 435.2046959714599,
                              367.4517211914062, 252.2008514404297,
                              752, 480, bf=args.bf)
    sys_ = load_system(args, Sensor.STEREO, default_cam)
    timer = TrackTimer()
    for i in range(min(len(left), len(right))):
        if args.max_frames and i >= args.max_frames:
            break
        img_l = timer.load(left.frames[i].load)
        img_r = timer.load(right.frames[i].load)
        with timer:
            sys_.track_stereo(img_l, img_r, left.frames[i].t)
    timer.report()
    print_timings(sys_, args)
    sys_.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}")
    maybe_eval_ate(sys_, left, args, with_scale=False)
    return sys_, timer


if __name__ == "__main__":
    main()
