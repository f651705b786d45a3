"""universe_p90_ms: the 90th percentile of the wall of every universe in
the window, from `state.init` to its Metrics and flight ring on the host
(host clock)."""

from raftbench.metrics_util import percentile


def read(run):
    if not run.walls_ms:
        return None
    return percentile(run.walls_ms, 90)
