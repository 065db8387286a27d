"""Share of the time frames are being tracked with no kernel or copy on the
card, in %: over the union of the recorder's "track" spans (the tracking
thread's MonoTracker.track, ygz_tpu_torch.utils.profiling.spans) inside the
traced slice, the part that no device record covers. Unlike
device.idle_pct, it leaves out the camera's wait between frames. None from
a program without the recorder."""


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length of the intersection of two merged interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        tot += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def read(ctx):
    tr = ctx.trace
    if not tr:
        return None
    try:
        from ygz_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    lo, hi = tr.span
    frames = _merged((max(s.start_ns, lo), min(s.end_ns, hi))
                     for s in spans(lo, hi) if s.name == "track")
    total = sum(e - s for s, e in frames)
    if total <= 0:
        return None
    return 100.0 * (1.0 - _overlap(frames, tr.busy_intervals()) / total)
