"""Share of its bound that the sparse image alignment kernel reaches in the
traced slice, in %: the least time of its calls over their device time.

Kernel name: ``sparse_align_kernel`` (csrc/sparse_align.cu). Only the frame
step's calls count: those replayed from its CUDA graph (launched by
``cudaGraphLaunch``), over the tracker's cache of max_track points. The
least time of a call is the bound of the alignment at levels
n_levels - 1 .. 1, 10 steps each, counted by
``slam_bench.roofline.sparse_align_work``."""
from slam_bench.roofline import bound, sparse_align_work

KERNEL = "sparse_align_kernel"


def read(ctx):
    n, secs = (ctx.trace.by_name(KERNEL, launch="cudaGraphLaunch")
               if ctx.trace else (0, 0.0))
    if not n or secs <= 0:
        return None
    cfg = ctx.tracker_cfg
    least, _ = bound(*sparse_align_work(cfg.max_track, cfg.n_levels - 1))
    return 100.0 * n * least / secs
