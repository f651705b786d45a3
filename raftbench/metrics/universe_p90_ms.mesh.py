"""universe_p90_ms.mesh: `universe_p90_ms` of a cell sharded over cards,
with a bound of its own (its runs spread wider than one card's)."""

from raftbench.metrics_util import metric


def read(run):
    return metric("universe_p90_ms", run)
