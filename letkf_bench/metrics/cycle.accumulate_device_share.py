"""Share of the device's busy time spent on kernels that
``ops.cycle.accumulate_chunk`` launched: the normal terms of a chunk (cull,
gathers, distances, the cap's threshold, the weighted matmul), against
everything the device ran in the traced steps."""

SPAN = "cycle.accumulate_chunk"


def install(ctx):
    from cwbnwp_letkf_torch.ops import cycle

    from letkf_bench.trace import wrapped

    return [(cycle, "accumulate_chunk", wrapped(cycle.accumulate_chunk, SPAN))]


def read(ctx):
    t = ctx.trace
    inside = t.span_device_s.get(SPAN, 0.0)
    return 100.0 * inside / t.busy_s if inside and t.busy_s else None
