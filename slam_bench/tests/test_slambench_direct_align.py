"""The direct tracker's roofline reader: its frozen work against a hand
count, and the records it reads."""
from types import SimpleNamespace

from slam_bench import roofline
from slam_bench.harness import metric_reader
from slam_bench.trace import Trace


def _work():
    import importlib.util

    path = roofline.__file__.replace("roofline.py",
                                     "metrics/direct_align_roofline.py")
    spec = importlib.util.spec_from_file_location("direct_align_m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.direct_align_work


def test_direct_align_work_by_hand():
    # one point, one pass of one step: 1,673 B of point, a 48-B pose, one
    # 9x9 window, 18 B out; the setup's 3,822, the pass's 847 and the
    # step's 36 + 64 x 17
    work = _work()
    assert work(1, passes=1, iters=1) == (1673 + 48 + 324 + 18,
                                          3822 + 847 + 36 + 64 * 17)
    # the frame step's two passes of 10 steps over 512 points: a window
    # is read once per pass, whatever the steps
    assert work(512) == (1_197_664, 14_333_952)
    assert work(512, iters=1)[0] == work(512)[0]


def test_the_reader_counts_two_replayed_launches_a_frame():
    us = 1000
    tr = Trace(window_s=1.0, frames=1, kernels=[
        ("direct_align_kernel", 0, 20 * us, "cudaGraphLaunch"),
        ("direct_align_kernel", 30 * us, 10 * us, "cudaGraphLaunch"),
        ("direct_align_kernel", 60 * us, 50 * us, "cuLaunchKernel")],
        span=(0, 10**9))
    ctx = SimpleNamespace(trace=tr, tracker_cfg=SimpleNamespace(
        max_track=512, n_levels=4))
    least, by = roofline.bound(*_work()(512))
    assert by == "bytes"
    got = metric_reader("direct_align_roofline")(ctx)
    assert abs(got - 100.0 * least / 30e-6) < 1e-9
    # a program without the kernel: nothing to read, no number
    ctx.trace = Trace(window_s=1.0, frames=1, kernels=[], span=(0, 10**9))
    assert metric_reader("direct_align_roofline")(ctx) is None
