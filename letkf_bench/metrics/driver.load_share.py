"""Share of the traced steps' seconds that the driver spent reading point
sets' fields and copying them to the device: the sum of its own
``GroupMetrics.load_s`` (a host clock around each read and copy)."""


def read(ctx):
    load = ctx.counters.get("driver.load_s")
    seconds = sum(s for s, _ in ctx.steps)
    return None if load is None or not seconds else 100.0 * load / seconds
