"""device_idle_pct.mesh: `device_idle_pct` of a cell sharded over cards
(the mean over its cards), read against `group_ticks_per_s.mesh`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("device_idle_pct", run)
