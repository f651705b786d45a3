"""kernel_ms_per_universe: the device time during which one of the
port's kernels (any `__global__` of the program's CUDA sources) ran in a
universe, from the profiler's trace; the median over the profiled
universes."""

import statistics

from raftbench import profile


def per_universe(tl) -> list:
    """The port-kernel device ms of each profiled universe."""
    return [profile.length(profile.port_kernel_union(tl, a, b)) / 1e3
            for a, b in tl.universes]


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    ms = per_universe(tl)
    if not any(ms):
        return None
    return statistics.median(ms)
