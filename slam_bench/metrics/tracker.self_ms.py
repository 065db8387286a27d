"""Host ms per frame that the tracking thread spends in MonoTracker.track
outside the frame step: the snapshot and any cache refill, the output's
bookkeeping, the keyframe decision and hand-off, the trajectory log
(StageTimer span "track" less span "frame_step", over the window's
"track" count). Serves tracker.self_ms.live."""


def read(ctx):
    total, count = ctx.stages.get("track", (0.0, 0))
    if not count:
        return None
    return 1e3 * (total - ctx.stages.get("frame_step", (0.0, 0))[0]) / count
