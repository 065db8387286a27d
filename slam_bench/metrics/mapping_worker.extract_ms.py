"""Ms per keyframe of the deferred feature extraction on the mapping worker
(FAST and ORB; StageTimer span "mapping.extract", which "mapping_tail"
leaves out), mean over the window's jobs. Serves
mapping_worker.extract_ms.live."""


def read(ctx):
    total, count = ctx.stages.get("mapping.extract", (0.0, 0))
    return 1e3 * total / count if count else None
