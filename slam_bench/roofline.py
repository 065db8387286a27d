"""Peaks, bounds and the work of the port's hand-written kernels, frozen.

Copies of ``chip_smoke.py`` phase 3c (``bound()``, the per-call byte and
operation counts of ``pose_gn``, ``sparse_align`` and ``fast_corners``)
and of ``ygz_tpu_torch/utils/profiling.py``'s ``LAUNCH_CALLS``, at commit
9b79ab1. The work is counted from the algorithm's own shapes (points,
levels, steps), each input byte read once and each output byte written
once, never from a kernel, so a later kernel is held to the same work.
"""
from __future__ import annotations

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

# host calls that ask the card for work (torch.profiler's CUDA runtime
# records)
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
LAUNCH_CALLS = KERNEL_LAUNCHES + ("cudaMemcpy", "cudaMemset")

# operations per pixel of the FAST arithmetic (csrc/fast_score.cu): the arc
# test is 16 differences, the side test (4 min, 3 max, a compare), 16 sign
# flips and the sliding minimum (44 min + 15 max); a threshold is a
# subtract, a compare and an add; the merge a compare, an add and a select;
# the separable NMS 5 max, a compare and a select
ARC_OPS, TH_OPS, MERGE_OPS, NMS_OPS = 16 + 8 + 16 + 59, 3, 3, 7
# operations of the Gauss-Newton arithmetic (an FMA counts 2): a mono pose
# row per GN step (projection 26, residual 2, the 2x6 Jacobian 26, chi2
# and weights 13, the 2 x 27 products summed 120) and a stereo row's third
# row (residual 5, Jacobian 15, chi2 2, products 60); a mono row per gate
# pass (projection 26, residual 2, chi2 4, the gate 4) and its stereo part
# (residual 5, chi2 2); an alignment point per level's setup (the 7x7
# gather blended to 6x6 324, gradients 64, Jp 42) and per step (projection
# and visibility 34, the 5x5 gather 154, per pixel: residual and Huber
# weight 6, J 18, weighted J 6, the 27 products summed 54); one 6x6 solve,
# exponential and composition per step
POSE_ROW_OPS, POSE_STEREO_ROW_OPS, GN_STEP_OPS = 187, 82, 480
POSE_GATE_OPS, POSE_STEREO_GATE_OPS = 36, 7
ALIGN_SETUP_OPS, ALIGN_POINT_OPS, ALIGN_PIXEL_OPS = 430, 188, 84


def bound(n_bytes, n_ops):
    """(least seconds on the card, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pose_gn_work(n, rounds=4, iters=10, n_stereo=0):
    """(bytes, operations) of one pose GN call over n rows, n_stereo of
    them with a right-image coordinate: X, uv, inv_sigma2, valid, R0, t0
    in; R, t, inliers, n, chi2 out."""
    n_bytes = n * (12 + 8 + 4 + 1) + 48 + 48 + n + 8 + 4 * n
    n_ops = (rounds * iters * (n * POSE_ROW_OPS + n_stereo * POSE_STEREO_ROW_OPS
                               + GN_STEP_OPS)
             + rounds * (n * POSE_GATE_OPS + n_stereo * POSE_STEREO_GATE_OPS))
    return n_bytes, n_ops


def sparse_align_work(n, levels=3, iters=10):
    """(bytes, operations) of one sparse alignment over n points: uv0, X,
    valid, R, t in; each point's 7x7 reference and 5x5 current window at
    each level read once; R, t, n_meas, mean_res out."""
    n_bytes = n * (8 + 12 + 1) + 48 + 4 * n * levels * (49 + 25) + 48 + 12
    n_ops = (levels * (n * ALIGN_SETUP_OPS + iters * (
        n * (ALIGN_POINT_OPS + 16 * ALIGN_PIXEL_OPS) + GN_STEP_OPS))
        + n * (ALIGN_POINT_OPS + 32))
    return n_bytes, n_ops


def pyramid_shapes(h, w, n_levels, scale=2.0):
    """Level shapes of the port's halving pyramid (floor at each level)."""
    shapes = [(h, w)]
    for _ in range(n_levels - 1):
        ph, pw = shapes[-1]
        shapes.append((int(ph / scale), int(pw / scale)))
    return shapes


def interior(h, w):
    """Pixels off the 3-px frame, the ones that run the arc test."""
    return max(h - 6, 0) * max(w - 6, 0)


def fast_corners_work(h, w, n_levels):
    """(bytes, operations) of one extraction front over an h x w frame's
    pyramid: both thresholds, the merge and the 3x3 NMS; each level's
    float32 pixels read once and its corner map written once (the pad of
    the port's stacked buffer is layout, not work)."""
    shapes = pyramid_shapes(h, w, n_levels)
    pixels = sum(a * b for a, b in shapes)
    n_ops = (sum(interior(a, b) for a, b in shapes)
             * (ARC_OPS + 2 * TH_OPS + MERGE_OPS) + pixels * NMS_OPS)
    return 4 * 2 * pixels, n_ops
