"""device.idle_pct.batch: share of the window in which no kernel, copy
or memset ran on the card (the profiler's trace), in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return ctx.trace.idle_pct
