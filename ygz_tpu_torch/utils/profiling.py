"""Per-stage wall-clock profiling.

Every tracker carries a StageTimer, so the per-frame budget (pyramid, frame
step, keyframe, mapping tail and its sub-stages) can be read at runtime;
``chip_smoke.py`` prints its report. For device time use torch.profiler or
CUDA events around a run; this is the cheap always-on layer.
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
