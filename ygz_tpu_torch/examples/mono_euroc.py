"""Monocular EuRoC runner (reference Examples/Monocular/mono_euroc.cc).

    python -m ygz_tpu_torch.examples.mono_euroc <root> [--settings FILE]
"""
from ..geometry.camera import Camera
from ..io.datasets import EurocDataset
from ..system import Sensor
from .common import (TrackTimer, base_parser, load_system, make_viewer,
                     maybe_eval_ate, print_timings)

# EuRoC cam0 (Examples/Monocular/EuRoC.yaml)
EUROC_CAM = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752,
                 height=480, dist=[-0.28340811, 0.07395907, 0.00019359,
                                   1.76187114e-05])


def main(argv=None):
    args = base_parser("Monocular EuRoC").parse_args(argv)
    ds = EurocDataset(args.dataset)
    sys_ = load_system(args, Sensor.MONOCULAR, Camera.make(**EUROC_CAM))
    timer = TrackTimer()
    viewer = make_viewer(args)
    batch = args.batch if args.batch > 1 else 1
    buf_img, buf_ts = [], []
    for i, fr in enumerate(ds):
        if args.max_frames and i >= args.max_frames:
            break
        img = timer.load(fr.load)
        if batch > 1:
            # one chunk of frames per track_monocular_batch call
            buf_img.append(img)
            buf_ts.append(fr.t)
            if len(buf_img) == batch:
                with timer:
                    sys_.track_monocular_batch(buf_img, buf_ts)
                timer.times[-1] /= batch   # per-frame attribution
                timer.times += [timer.times[-1]] * (batch - 1)
                # --viz in batch mode: overlay the chunk's last frame (the
                # only one whose debug state survives the batch readback)
                viewer.update(sys_.tracker, buf_img[-1])
                buf_img, buf_ts = [], []
        else:
            with timer:
                sys_.track_monocular(img, fr.t)
            viewer.update(sys_.tracker, img)
    for im, t in zip(buf_img, buf_ts):
        with timer:
            sys_.track_monocular(im, t)
    timer.report()
    print_timings(sys_, args)
    viewer.finish(sys_.tracker)
    sys_.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}")
    maybe_eval_ate(sys_, ds, args, with_scale=True)
    return sys_, timer


if __name__ == "__main__":
    main()
