"""Share of the device's busy time spent on kernels launched inside the
program's own span ``accumulate.cap`` (``ops.dense.terms_from_r2``: the row
mask, the cap's multisection threshold and the selection), against
everything the device ran in the traced steps.  The program opens the span
while a profiler records; a program without it reads nothing."""

SPAN = "accumulate.cap"


def read(ctx):
    t = ctx.trace
    inside = t.span_device_s.get(SPAN, 0.0)
    return 100.0 * inside / t.busy_s if inside and t.busy_s else None
