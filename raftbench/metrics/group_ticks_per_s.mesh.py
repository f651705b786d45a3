"""group_ticks_per_s.mesh: `group_ticks_per_s` of a cell sharded over
cards, with a bound of its own (its runs spread wider than one card's)."""

from raftbench.metrics_util import metric


def read(run):
    return metric("group_ticks_per_s", run)
