"""Ms from the card finishing a frame's replay to the tracking thread
returning from its readback, median over the traced slice's frames: the end
of the recorder's "frame_step.readback" span less the end of the last
device record launched by cudaGraphLaunch that ends between the same
frame's "frame_step.dispatch" start and that end
(ygz_tpu_torch.utils.profiling.spans, on the clock of the device records).
The copy of the output to the host and the wait for the interpreter fall in
it. A frame whose replay left no record is skipped. None from a program
without the recorder."""
import bisect
import statistics


def read(ctx):
    tr = ctx.trace
    if not tr:
        return None
    try:
        from ygz_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    got = spans(*tr.span)
    dispatch = {s.frame: s.start_ns for s in got
                if s.name == "frame_step.dispatch"}
    ends = sorted(s + d for _, s, d, by in tr.kernels
                  if (by or "").startswith("cudaGraphLaunch"))
    lags = []
    for s in got:
        if s.name != "frame_step.readback" or s.frame not in dispatch:
            continue
        i = bisect.bisect_right(ends, s.end_ns) - 1
        if i >= 0 and ends[i] >= dispatch[s.frame]:
            lags.append(s.end_ns - ends[i])
    return 1e-6 * statistics.median(lags) if lags else None
