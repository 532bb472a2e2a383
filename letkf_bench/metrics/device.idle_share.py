"""Share of the traced steps' seconds in which the device ran no kernel,
copy or fill (the profiler's record)."""


def read(ctx):
    t = ctx.trace
    return (100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s and t.busy_s
            else None)
