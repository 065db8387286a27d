"""Per-stage wall-clock profiling.

Every tracker carries a StageTimer, so the per-frame budget (pyramid, frame
step, keyframe, mapping tail and its sub-stages) can be read at runtime;
``chip_smoke.py`` prints its report. For device time use torch.profiler or
CUDA events around a run; this is the cheap always-on layer.
``launch_calls`` counts what one call asks of the card; ``device_events``
returns the device records of its kernels and copies.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimer:
    """Accumulates wall-clock per named stage (perf_counter pairs). Host
    time only: device work inside a stage is attributed to it when the
    stage ends on a blocking readback, which is how the tracker consumes
    device results."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def mean_ms(self):
        return {k: 1e3 * self.total[k] / max(self.count[k], 1)
                for k in sorted(self.total)}

    def report(self) -> str:
        rows = [f"  {k:<22s} {v:8.2f} ms x{self.count[k]}"
                for k, v in self.mean_ms().items()]
        return "per-stage mean wall time:\n" + "\n".join(rows)


KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
LAUNCH_CALLS = KERNEL_LAUNCHES + ("cudaMemcpy", "cudaMemset")


def launch_calls(fn) -> int:
    """Host launch and copy calls (cudaLaunchKernel, cudaMemcpy, ...) that
    one call of fn makes on the card, by torch.profiler's CUDA activity.
    The raw event list is counted: key_averages() takes about a second
    per 10^4 events, and an eager solver makes ~10^5."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.name().startswith(LAUNCH_CALLS))
    if n == 0:
        raise RuntimeError("torch.profiler recorded no launch call")
    return n


def device_events(fn, reps=1, pad=512):
    """The card's kernel and copy records of `reps` calls of fn, by
    torch.profiler's CUDA activity (the raw event list).

    Once a process has run for some tens of seconds, torch.profiler drops
    the records of the first few kernels of every session, more as the
    process ages (on an H100 with torch 2.11, in an otherwise idle process
    too; waiting after the start does not help). So
    the session first launches `pad` one-element kernels, whose records
    (by correlation id) are left out. Returns (records, kernel launches
    after the pad with no record): a session of ~5 * 10^4 kernels late in
    a process still lost ~1% of them. Graph replays are not counted there
    (a replay has come back with no record at all). Raises if no record
    is left."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            x.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    calls = sorted((e.start_ns(), e.correlation_id(), e.name())
                   for e in events if e.name().startswith(LAUNCH_CALLS))
    padded = {c for _, c, _ in calls[:pad]}
    kernels = {c for _, c, name in calls[pad:]
               if name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
    dev = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA
           and e.correlation_id() not in padded]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device time")
    return dev, len(kernels - {e.correlation_id() for e in dev})
