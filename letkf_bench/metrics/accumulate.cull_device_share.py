"""Share of the device's busy time spent on kernels launched inside the
program's own span ``accumulate.cull`` (``ops.cycle._bucketed_cycle_terms``,
bucketed platforms only: the block distances, the top-k of candidate blocks
and the gathers of their coordinates, tables and counts), against
everything the device ran in the traced steps.  The program opens the span
while a profiler records; a program without it reads nothing."""

SPAN = "accumulate.cull"


def read(ctx):
    t = ctx.trace
    inside = t.span_device_s.get(SPAN, 0.0)
    return 100.0 * inside / t.busy_s if inside and t.busy_s else None
