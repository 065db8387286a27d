"""Share of its bound that the fused FAST extraction front reaches in the
traced slice, in %: the least time of its calls over their device time.

Kernel name: ``fast_corners_kernel`` (csrc/fast_score.cu, one launch per
keyframe pyramid). The least time of a call is the bound of both
thresholds, the merge and the 3x3 NMS over the camera's n_levels pyramid,
counted by ``slam_bench.roofline.fast_corners_work``."""
from slam_bench.roofline import bound, fast_corners_work

KERNEL = "fast_corners_kernel"


def read(ctx):
    n, secs = ctx.trace.by_name(KERNEL) if ctx.trace else (0, 0.0)
    if not n or secs <= 0:
        return None
    least, _ = bound(*fast_corners_work(ctx.camera.height, ctx.camera.width,
                                        ctx.tracker_cfg.n_levels))
    return 100.0 * n * least / secs
