"""The program's own counters (``cwbnwp_letkf_torch.tracing``), for the
per-layer readers that take them: cleared before the traced steps and read
after them.  A program without them reads nothing (``None``)."""


def _tracing():
    try:
        from cwbnwp_letkf_torch import tracing
    except ImportError:
        return None
    return tracing


def reset() -> None:
    """Clear the program's counters, where it has them."""
    tracing = _tracing()
    if tracing is not None:
        tracing.reset_counters()


def watch_syncs(flag: bool) -> None:
    """Have the program count its syncs with the card (``host.syncs``), or
    stop, where it can."""
    tracing = _tracing()
    if tracing is not None:
        tracing.watch_syncs(flag)


def read():
    """The program's counters since :func:`reset` (``tracing.counters()``),
    or ``None``."""
    tracing = _tracing()
    return None if tracing is None else tracing.counters()
