"""Host ms per frame of the frame step's blocking readback (StageTimer span
"frame_step.readback": the wait for the replay on the card and to get back
onto the interpreter) over the window. Serves frame_step.readback_ms.live."""


def read(ctx):
    total, count = ctx.stages.get("frame_step.readback", (0.0, 0))
    return 1e3 * total / count if count else None
