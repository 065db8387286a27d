"""Share of its bound that the direct tracker's kernel reaches in the
traced slice, in %: the least time of a frame's two launches over their
device time.

Kernel name: ``direct_align_kernel`` (csrc/direct_align.cu). Only the frame
step's calls count: those replayed from its CUDA graph (launched by
``cudaGraphLaunch``), two per frame over the tracker's cache of max_track
points. The mapping worker's eager refinements (other row counts) are left
out. The least time of a frame is the bound of ``direct_align_work`` below,
counted from the algorithm's shapes (max_track points, 2 passes of 10
steps, each point's 9x9 window and its stored 20x20 patch; each input byte
read once, each output written once), never from the kernel: the plain
version does that work too, every step of every point. Where the program
has no such kernel (before it was written), nothing is read and the
metric is left out."""
from slam_bench.roofline import bound

KERNEL = "direct_align_kernel"

# operations of the direct tracker's arithmetic (an FMA counts 2), which
# chip_smoke.py phase 3c reads too: a point's setup (the projection 26,
# visibility 8, the reference depth 7, three finite-difference projections
# 156, the warp, its level and inverse 25, the 10x10 warped samples
# 100 x 36), a point's pass (projection and selection 40, the gradients and
# the 3x3 Hessian of 64 pixels 768, its inverse 29, the result 10) and step
# (the 9x9 gather's corner 14, the 3x3 product, update and test 22; per
# inner pixel the bilinear blend 10, the residual 2, J^T r 5)
SETUP_OPS, PASS_OPS, STEP_OPS, PIXEL_OPS = 3822, 847, 36, 17


def direct_align_work(n, passes=2, iters=10):
    """(bytes, operations) of one frame's direct tracking over n cached
    points: xyz, valid, the 20x20 stored patch, ref_uv, ref_level, ref_R,
    ref_t read once and a pose per pass; each point's 9x9 window once per
    pass (its steps move it little, so they read nearly the same pixels,
    as sparse_align_work counts a window once per level);
    uv, ok, visible, level, inv_sigma2 out."""
    n_bytes = (n * (12 + 1 + 4 * 400 + 8 + 4 + 36 + 12) + passes * 48
               + passes * n * 4 * 81 + n * (8 + 1 + 1 + 4 + 4))
    n_ops = n * SETUP_OPS + passes * n * (
        PASS_OPS + iters * (STEP_OPS + 64 * PIXEL_OPS))
    return n_bytes, n_ops


def read(ctx):
    n, secs = (ctx.trace.by_name(KERNEL, launch="cudaGraphLaunch")
               if ctx.trace else (0, 0.0))
    if not n or secs <= 0:
        return None
    least, _ = bound(*direct_align_work(ctx.tracker_cfg.max_track))
    return 100.0 * (n / 2) * least / secs
