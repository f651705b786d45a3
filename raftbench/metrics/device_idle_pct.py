"""device_idle_pct: the share of the window (the profiled universes'
spans) in which no operation ran on a card, from the profiler's trace;
the mean over the run's cards."""

from raftbench import profile


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    window = profile.universe_time(tl)
    if window <= 0:
        return None
    busy = [profile.length(profile.busy(tl, d)) for d in tl.devices]
    return 100.0 * (1.0 - sum(busy) / len(busy) / window)
