"""boundary_idle_ms.faults: `boundary_idle_ms` of the one-card cells
under faults (the idle card inside `prun`, whose wire carries the
PreVote and TimeoutNow slots in `etcd5.ops-jepsen`), read against
`universe_p90_ms`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("boundary_idle_ms", run)
