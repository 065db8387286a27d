"""Host ms per frame of the frame step (the tracker's StageTimer span
"frame_step": the graph replays' dispatch and readback) over the window.
Serves frame_step_ms.live."""


def read(ctx):
    total, count = ctx.stages.get("frame_step", (0.0, 0))
    return 1e3 * total / count if count else None
