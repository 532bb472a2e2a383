"""Share of the points whose cap search ran (a platform with more records
than its ``max_lz_pts``) at which the cap binds, more than ``max_lz_pts``
records lying within the localization radius: the program's counters
``accumulate.cap_bound`` over ``accumulate.cap_points``
(``ops.dense.terms_from_r2``), over the traced steps."""

from letkf_bench import counters


def install(ctx):
    counters.reset()
    return []


def read(ctx):
    c = counters.read()
    points = c.get("accumulate.cap_points") if c else None
    return 100.0 * c["accumulate.cap_bound"] / points if points else None
