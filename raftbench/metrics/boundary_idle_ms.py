"""boundary_idle_ms: the 90th percentile over the universes of the
traced run's block with the program's tracer of the time no operation
ran on the card while the host was inside the top-level `prun` span
(`kmesh prun` when sharded): the wire's encode before the launch, the
launch, the decode after it."""

from raftbench import profile
from raftbench.metrics_util import percentile

SPANS = ("prun", "kmesh prun")


def read(run):
    tl = run.program_timeline
    if tl is None:
        return None
    us = profile.idle_in_spans(tl, SPANS)
    return percentile(us, 90) / 1e3 if us else None
