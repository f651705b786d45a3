"""shard_spread_ms: the median over the profiled universes of the gap
between the first and the last card to finish its shard's kernel work,
from the profiler's per-card timeline. Nothing to read on one card."""

import statistics

from raftbench import profile


def read(run):
    tl = run.timeline
    if tl is None or len(tl.devices) < 2:
        return None
    spreads = []
    for a, b in tl.universes:
        ends = []
        for d in tl.devices:
            k = profile.port_kernel_union(tl, a, b, d)
            if k:
                ends.append(k[-1][1])
        if len(ends) >= 2:
            spreads.append((max(ends) - min(ends)) / 1e3)
    return statistics.median(spreads) if spreads else None
