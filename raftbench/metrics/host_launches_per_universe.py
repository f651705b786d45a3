"""host_launches_per_universe: the median over the universes of the
traced run's block with the program's tracer of the host's launch calls
(`cudaLaunchKernel*`, `cuLaunchKernel*`, `cudaMemcpyAsync`,
`cudaMemsetAsync`) inside the top-level spans that `init_idle_ms` and
`boundary_idle_ms` read: what the card waits on at a universe's ends."""

import statistics

from raftbench import profile
from raftbench.metrics_util import module


def read(run):
    tl = run.program_timeline
    if tl is None:
        return None
    spans = module("init_idle_ms").SPANS + module("boundary_idle_ms").SPANS
    n = profile.launches_in_spans(tl, spans)
    return statistics.median(n) if n and any(n) else None
