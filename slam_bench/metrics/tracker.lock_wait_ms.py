"""Host ms per frame that the tracking thread waits to take the map lock
(StageTimer span "track.lock_wait", summed over the window, over the
window's frames): the frames that meet a mapping tail holding the lock.
None from a program without the span "track", which records no waits."""


def read(ctx):
    if not ctx.frames or not ctx.stages.get("track", (0.0, 0))[1]:
        return None
    return 1e3 * ctx.stages.get("track.lock_wait", (0.0, 0))[0] / ctx.frames
