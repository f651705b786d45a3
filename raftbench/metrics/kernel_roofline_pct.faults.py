"""kernel_roofline_pct.faults: `kernel_roofline_pct` of the one-card
cells under faults (for `etcd5.ops-jepsen` the all-features build's
share of its roofline), read against `group_ticks_per_s`."""

from raftbench.metrics_util import metric


def read(run):
    return metric("kernel_roofline_pct", run)
