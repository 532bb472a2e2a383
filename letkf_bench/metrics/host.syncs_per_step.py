"""Host synchronisations with the card a step: the program's counter
``host.syncs`` (every sync CUDA's sync-debug mode flags, and the program's
explicit ones, while a program span or label is open) over the traced
steps.  The program counts them only when asked (each sync then passes
through Python's warnings), so this reader asks for the traced steps and
stops it after them.  Prints the syncs by innermost span or label and
CUDA's sync-debug mode before and after the traced steps, which the program
must leave as it found it."""

import torch

from letkf_bench import counters


def _mode():
    return (torch.cuda.get_sync_debug_mode() if torch.cuda.is_available()
            else None)


def install(ctx):
    counters.reset()
    counters.watch_syncs(True)
    ctx.data["sync_debug_mode"] = _mode()
    return []


def read(ctx):
    counters.watch_syncs(False)
    c = counters.read()
    if c is None or not ctx.steps:
        return None
    by_span = sorted(c["host.syncs_by_span"].items(), key=lambda x: -x[1])
    print(f"host.syncs: {c['host.syncs']} in {len(ctx.steps)} steps; by "
          f"span {dict(by_span)}; sync-debug mode before the traced steps "
          f"{ctx.data.get('sync_debug_mode')}, after {_mode()}", flush=True)
    return c["host.syncs"] / len(ctx.steps)
