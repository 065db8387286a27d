"""Host launch and copy calls (roofline.LAUNCH_CALLS: kernel and graph
launches, memcpy, memset) in the traced slice, per frame fed."""


def read(ctx):
    tr = ctx.trace
    return tr.launch_calls / tr.frames if tr and tr.frames else None
