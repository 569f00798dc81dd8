"""device.idle_pct: the share of the traced window in which no kernel, copy
or memset ran on the card, from the profiler's device timeline."""

SPANS = {}


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
