"""outside_kernel_p90_ms: the 90th percentile over the profiled universes
of the universe's wall (its `raftbench.universe` span) less the device
time its port kernels ran: `state.init`, the wire boundary (kinit,
kfinish), allocation and the fetch."""

from raftbench.metrics_util import module, percentile


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    kernel = module("kernel_ms_per_universe").per_universe(tl)
    if not any(kernel):
        return None
    outside = [(b - a) / 1e3 - k for (a, b), k in zip(tl.universes, kernel)]
    return percentile(outside, 90)
