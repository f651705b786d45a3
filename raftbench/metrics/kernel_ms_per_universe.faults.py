"""kernel_ms_per_universe.faults: `kernel_ms_per_universe` of the
one-card cells under faults, read against `group_ticks_per_s`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("kernel_ms_per_universe", run)
