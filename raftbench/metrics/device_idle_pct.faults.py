"""device_idle_pct.faults: `device_idle_pct` of the one-card cells under
faults, read against `group_ticks_per_s`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("device_idle_pct", run)
