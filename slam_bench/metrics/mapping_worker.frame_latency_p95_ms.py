"""The 95th percentile of the window's frame latencies (from the time each
frame was due to its pose returned), in ms. The frames in this tail are
those that met the mapping worker's keyframe tails on the interpreter lock;
its runs spread too widely to bound (PERF.md)."""
import numpy as np


def read(ctx):
    lat = ctx.latencies_ms
    return float(np.percentile(lat, 95)) if lat else None
