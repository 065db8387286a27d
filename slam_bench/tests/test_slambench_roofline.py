"""The frozen work counts against hand counts at tiny shapes."""
from slam_bench import roofline


def test_bound_takes_the_larger_of_bytes_and_operations():
    t, by = roofline.bound(3.35e12, 1.0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = roofline.bound(1.0, 67e12)
    assert by == "operations" and abs(t - 1.0) < 1e-12


def test_pose_gn_work_by_hand():
    # one mono row, one round of one step: 25 B in, 1 B of inlier flag and
    # 4 B of chi2 out, 48 + 48 of poses, 8 of counters; 187 operations for
    # the row, 480 for the solve, 36 for the gate
    assert roofline.pose_gn_work(1, rounds=1, iters=1) == (
        25 + 48 + 48 + 1 + 8 + 4, 187 + 480 + 36)
    # a stereo row adds its third row's 82 and its gate's 7
    assert roofline.pose_gn_work(1, 1, 1, n_stereo=1)[1] == 187 + 82 + 480 \
        + 36 + 7
    # the frame step's call: 4 rounds of 10 steps over 512 rows
    assert roofline.pose_gn_work(512)[1] == 40 * (512 * 187 + 480) + 4 * (
        512 * 36)


def test_sparse_align_work_by_hand():
    # one point, one level, one step: 21 B of point, the 7x7 and 5x5
    # windows, 48 + 48 + 12 of poses and results; 430 of set-up, 188 + 16 *
    # 84 for the step's point, 480 for the solve, 188 + 32 for the final
    # residual
    assert roofline.sparse_align_work(1, levels=1, iters=1) == (
        21 + 48 + 4 * 74 + 48 + 12, 430 + 188 + 16 * 84 + 480 + 188 + 32)


def test_fast_corners_work_by_hand():
    # a 12 x 10 frame, one level: 6 x 4 interior pixels run the arc test
    # and both thresholds and the merge; all 120 run the NMS; 120 pixels
    # read and 120 written, 4 B each
    n_bytes, n_ops = roofline.fast_corners_work(12, 10, 1)
    assert n_bytes == 4 * (120 + 120)
    assert n_ops == 24 * (99 + 6 + 3) + 120 * 7
    # two levels: the second is 6 x 5 with no interior; its 30 pixels are
    # read and written, not the pad of the port's stacked 18 x 10 buffer
    n_bytes, n_ops = roofline.fast_corners_work(12, 10, 2)
    assert n_bytes == 4 * 2 * (120 + 30)
    assert n_ops == 24 * 108 + 150 * 7
    # the EuRoC pyramid: 360,960 + 90,240 + 22,560 + 5,640 level pixels
    assert roofline.fast_corners_work(480, 752, 4)[0] == 8 * 479_400


def test_the_euroc_pyramid_matches_the_port_shapes():
    assert roofline.pyramid_shapes(480, 752, 4) == [
        (480, 752), (240, 376), (120, 188), (60, 94)]


def test_the_main_path_counts_match_the_smoke():
    """chip_smoke.py phase 3c's printed counts at the main path's N = 512."""
    assert roofline.pose_gn_work(512) == (15_464, 3_922_688)
    assert roofline.sparse_align_work(512, 3) == (465_516, 24_319_040)


def test_the_gn_readers_count_only_the_frame_steps_replays():
    """An eager pose GN (a PnP polish) in the slice is left out of the
    share; the replayed calls are counted at the cache's rows."""
    from types import SimpleNamespace

    from slam_bench.harness import metric_reader
    from slam_bench.trace import Trace

    us = 1000
    tr = Trace(window_s=1.0, frames=1, kernels=[
        ("pose_gn_kernel", 0, 200 * us, "cudaGraphLaunch"),
        ("pose_gn_kernel", 300 * us, 200 * us, "cudaGraphLaunch"),
        ("pose_gn_kernel", 600 * us, 50 * us, "cuLaunchKernel"),
        ("sparse_align_kernel", 700 * us, 400 * us, "cudaGraphLaunch")],
        span=(0, 10**9))
    ctx = SimpleNamespace(trace=tr, tracker_cfg=SimpleNamespace(
        max_track=512, n_levels=4))
    least, _ = roofline.bound(*roofline.pose_gn_work(512))
    got = metric_reader("pose_gn_roofline")(ctx)
    assert abs(got - 100.0 * 2 * least / 400e-6) < 1e-9
    least, _ = roofline.bound(*roofline.sparse_align_work(512, 3))
    got = metric_reader("sparse_align_roofline")(ctx)
    assert abs(got - 100.0 * least / 400e-6) < 1e-9
    # no replayed call in the slice: the metric is left out, never 0
    tr.kernels = [k[:3] + ("cuLaunchKernel",) for k in tr.kernels]
    assert metric_reader("pose_gn_roofline")(ctx) is None
