"""Share of the traced slice with no kernel or copy on the card, in %.
Serves device.idle_pct.live."""


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr else None
