"""Share of the window the async mapping worker spent in keyframe tails
(StageTimer span "mapping_tail", summed over the window, over the window's
wall time), in %."""


def read(ctx):
    total, count = ctx.stages.get("mapping_tail", (0.0, 0))
    return 100.0 * total / ctx.window_s if count else None
