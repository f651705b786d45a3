"""group_ticks_per_s: groups x ticks of every universe completed in the
window, over the window: the universes' walls added up (the harness's
sample gather between two universes is left out)."""


def read(run):
    if run.window_s <= 0 or not run.walls_ms:
        return None
    return run.group_ticks / run.window_s
