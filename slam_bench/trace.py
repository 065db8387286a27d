"""One traced slice of a run: torch.profiler's raw event list reduced to
device busy time, kernels by name, launch calls and the idle gaps.

The raw list (``kineto_results.events()``) is read, not ``key_averages()``,
which takes about a second per 10^4 events; an eager mono-inertial frame
makes ~2.5 * 10^4 launches. torch.profiler drops the records of the first
few kernels of a session late in a process, so the session first launches
`PAD` one-element kernels, and the slice is delimited by a
``record_function`` range: only records inside it count. Each device
record keeps the host call that launched it (matched by the CUDA
correlation id): a kernel replayed from a CUDA graph was launched by
``cudaGraphLaunch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .roofline import LAUNCH_CALLS

PAD = 512
SLICE = "slam_bench.traced_slice"


@dataclass
class Trace:
    window_s: float                 # the slice's wall length
    frames: int                     # frames fed in the slice
    # (name, start_ns, dur_ns, launching host call or None)
    kernels: list = field(default_factory=list)
    launch_calls: int = 0
    cpu: list = field(default_factory=list)       # (name, start_ns, end_ns)
    span: tuple = (0, 0)            # the slice's (start_ns, end_ns)

    def busy_intervals(self):
        """Merged [start, end) ns intervals with a kernel or copy running."""
        lo, hi = self.span
        iv = sorted((max(s, lo), min(s + d, hi))
                    for _, s, d, _ in self.kernels if s + d > lo and s < hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return 1e-9 * sum(e - s for s, e in self.busy_intervals())

    def by_name(self, key, launch=""):
        """(count, seconds) of the device records whose name contains key
        and whose launching host call starts with `launch`."""
        hits = [d for name, _, d, by in self.kernels
                if key in name and (by or "").startswith(launch)]
        return len(hits), 1e-9 * sum(hits)

    def top_ops(self, n=10):
        tot = {}
        for name, _, d, _ in self.kernels:
            tot[name] = tot.get(name, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name, 1e-9 * d] for name, d in top]

    def idle_gaps(self, n=10):
        """The n longest stretches of the slice with nothing on the card,
        each named by the host operation that covers most of it (the
        shortest among those covering at least 90% as much)."""
        lo, hi = self.span
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            end = start + length
            cover = [(min(e, end) - max(s, start), e - s, name)
                     for name, s, e in self.cpu if s < end and e > start]
            label = "host outside any operation"
            if cover:
                best = max(c[0] for c in cover)
                label = min((c for c in cover if c[0] >= 0.9 * best),
                            key=lambda c: c[1])[2]
            out.append([label, 1e-9 * length])
        return out


def traced(fn):
    """Run fn() (which returns the frames it fed) under torch.profiler on
    the card; returns the Trace of its slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            x.add_(1.0)
        torch.cuda.synchronize()
        with record_function(SLICE):
            frames = fn()
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    span = next(((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in events
                 if e.name() == SLICE and e.device_type() != cuda), None)
    if span is None:
        raise RuntimeError("torch.profiler recorded no slice range")
    lo, hi = span
    launched_by = {e.correlation_id(): e.name() for e in events
                   if e.device_type() != cuda
                   and e.name().startswith(LAUNCH_CALLS)}
    kernels, cpu, launches = [], [], 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.name() == SLICE:
            continue      # the range's own host and device annotations
        if e.device_type() == cuda:
            if s + d > lo and s < hi:
                kernels.append((e.name(), s, d,
                                launched_by.get(e.correlation_id())))
        elif lo <= s < hi:
            name = e.name()
            if name.startswith(LAUNCH_CALLS):
                launches += 1
            cpu.append((name, s, s + d))
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time in the "
                           "traced slice")
    return Trace(window_s=1e-9 * (hi - lo), frames=frames, kernels=kernels,
                 launch_calls=launches, cpu=cpu, span=span)
