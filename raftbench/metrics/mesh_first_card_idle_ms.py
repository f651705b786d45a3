"""mesh_first_card_idle_ms: the 90th percentile over the universes of
the traced run's block with the program's tracer of the time cards 1 to
3 (every card but the first) ran no operation, averaged over them, while
the host was inside `kmesh cut`, `kmesh gather` or `kmesh finish`: the
other cards waiting on the first card's cut of the State, gather of the
wires and decode of the whole fleet. Nothing to read on one card."""

from raftbench import profile
from raftbench.metrics_util import percentile

SPANS = ("kmesh cut", "kmesh gather", "kmesh finish")


def read(run):
    tl = run.program_timeline
    if tl is None or len(tl.devices) < 2:
        return None
    us = profile.idle_in_spans(tl, SPANS, devices=tl.devices[1:], top=False)
    return percentile(us, 90) / 1e3 if us else None
