"""kernel_roofline_pct: the least time one H100 could take for one
universe's work on a card (`raftbench/roofline.py`: the State, Metrics and
ring read and written once at their semantic widths, the hash operations
the universe needs), over `kernel_ms_per_universe`."""

from raftbench.metrics_util import metric


def read(run):
    kernel_ms = metric("kernel_ms_per_universe", run)
    if kernel_ms is None or run.roofline is None:
        return None
    return 100.0 * run.roofline["seconds"] * 1e3 / kernel_ms
