"""init_idle_ms: the 90th percentile over the universes of the traced
run's block with the program's tracer of the time no operation ran on
the card while the host was inside a top-level `state.init`,
`run.metrics_init` or `recorder.flight_init` span: the universe's start,
one small launch after another on an idle card."""

from raftbench import profile
from raftbench.metrics_util import percentile

SPANS = ("state.init", "run.metrics_init", "recorder.flight_init")


def read(run):
    tl = run.program_timeline
    if tl is None:
        return None
    us = profile.idle_in_spans(tl, SPANS)
    return percentile(us, 90) / 1e3 if us else None
