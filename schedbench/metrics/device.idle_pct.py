"""Device: the share of the traced interval in which no operation ran on
the card, in percent, from the profiler's timeline."""


def read(ctx):
    t = ctx.traced
    if t is None or t.trace is None or t.trace.window_s <= 0:
        return None
    return (1.0 - t.trace.busy_s / t.trace.window_s) * 100.0
