"""Ms a keyframe's job waits in the mapping worker's queue, from its hand-off
to its start (StageTimer span "mapping.queue_wait"), mean over the window's
jobs. Serves mapping_worker.queue_wait_ms.live."""


def read(ctx):
    total, count = ctx.stages.get("mapping.queue_wait", (0.0, 0))
    return 1e3 * total / count if count else None
