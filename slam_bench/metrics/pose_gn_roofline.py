"""Share of its bound that the pose Gauss-Newton kernel reaches in the
traced slice, in %: the least time of its calls over their device time.

Kernel name: ``pose_gn_kernel`` (csrc/pose_gn.cu). Only the frame step's
calls count: those replayed from its CUDA graph (launched by
``cudaGraphLaunch``), whose inputs are the tracker's cache of max_track
rows. The eager calls (a relocalization's PnP polish, the fallback) have
other row counts and are left out. The least time of a call is the bound
of 4 rounds of 10 steps over max_track monocular rows, counted by
``slam_bench.roofline.pose_gn_work`` from the algorithm's shapes."""
from slam_bench.roofline import bound, pose_gn_work

KERNEL = "pose_gn_kernel"


def read(ctx):
    n, secs = (ctx.trace.by_name(KERNEL, launch="cudaGraphLaunch")
               if ctx.trace else (0, 0.0))
    if not n or secs <= 0:
        return None
    least, _ = bound(*pose_gn_work(ctx.tracker_cfg.max_track))
    return 100.0 * n * least / secs
