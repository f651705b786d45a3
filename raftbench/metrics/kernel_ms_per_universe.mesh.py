"""kernel_ms_per_universe.mesh: `kernel_ms_per_universe` of a cell
sharded over cards (a port kernel running on any card), read against
`group_ticks_per_s.mesh`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("kernel_ms_per_universe", run)
