"""Share of the pairs (point, record) that the accumulation's
``[C, R] @ [R, k(k+1)]`` product multiplies which carry a nonzero weight:
the program's counters ``accumulate.pairs_selected`` over
``accumulate.pairs`` (``ops.dense.terms_from_r2``), over the traced steps."""

from letkf_bench import counters


def install(ctx):
    counters.reset()
    return []


def read(ctx):
    c = counters.read()
    pairs = c.get("accumulate.pairs") if c else None
    return 100.0 * c["accumulate.pairs_selected"] / pairs if pairs else None
