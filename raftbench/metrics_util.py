"""What the metric readers share: loading a reader by name (so a metric
built on another, a roofline on a kernel time, reads it one way only)
and the percentile every tail here is taken with."""

from __future__ import annotations

import importlib.util
import statistics

from raftbench import spec


def percentile(values, q: int) -> float:
    """The q-th percentile (inclusive method of `statistics.quantiles`)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def module(name: str):
    """`metrics/<name>.py`, loaded."""
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "raftbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric(name: str, run):
    """Metric `name` of `run`, or None."""
    return module(name).read(run)
