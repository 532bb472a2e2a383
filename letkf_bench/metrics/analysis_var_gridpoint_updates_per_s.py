"""Var-point updates of the window's whole steps over their seconds (host
clock, each step ending in a device synchronize)."""


def read(ctx):
    seconds = sum(s for s, _ in ctx.steps)
    return sum(n for _, n in ctx.steps) / seconds if seconds else None
