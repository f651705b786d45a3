"""Divergence triage: bisect two engine trajectories to the first
divergent tick and name the first divergent leaf, and the lockstep
differential against the CPU oracle.

An engine is a deterministic function of (state, n_ticks, t0), so
triage re-executes cheaply: compare at chunk boundaries until the first
unequal one, then re-run both engines tick by tick from the last
boundary where they were still byte-identical, and report the first
tick whose post-states differ with the first divergent leaf path
(utils.trees.trees_equal_why).
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.utils.trees import trees_equal_why


def bisect_divergence(engine_a, engine_b, st0, n_ticks: int, t0: int = 0,
                      chunk: int = 16):
    """First divergent (tick, leaf) between two engine trajectories.

    `engine_x(st, n, t)` runs n ticks from absolute tick t and returns
    the evolved state (e.g. ``lambda st, n, t: run(cfg, st, n, t)[0]``,
    or `kernel.prun` the same way). Both engines start from `st0` at
    `t0` and must not write into their input. Returns None when every
    chunk boundary over [t0, t0 + n_ticks) is byte-identical, else::

        {"tick": first tick t whose post-tick states differ,
         "leaf_report": first divergent leaf path, dtype/shape and
                        first differing element (trees_equal_why),
         "boundary": the (start, end) chunk the bisection narrowed}

    Cost: one pass at `chunk` granularity plus at most `chunk`
    single-tick re-executions of each engine."""
    sa = sb = st0
    t, end = t0, t0 + n_ticks
    while t < end:
        n = min(chunk, end - t)
        na = engine_a(sa, n, t)
        nb = engine_b(sb, n, t)
        ok, _ = trees_equal_why(na, nb)
        if ok:
            sa, sb, t = na, nb, t + n
            continue
        for dt in range(n):
            sa = engine_a(sa, 1, t + dt)
            sb = engine_b(sb, 1, t + dt)
            ok, why = trees_equal_why(sa, sb)
            if not ok:
                return {"tick": t + dt, "leaf_report": why,
                        "boundary": (t, t + n)}
        raise AssertionError(
            "chunk diverged but its tick-by-tick re-execution did not — "
            "an engine is not a deterministic function of (state, t0)")
    return None


# ------------------------------------------------- oracle lockstep leg


def oracle_trace(cfg, n_groups: int, n_ticks: int):
    """[T, G, K] int64 numpy trace of the CPU oracle (one `Cluster` per
    group, ticked in lockstep, `snapshot()` per tick) over
    `sim.run.trace`'s fields plus the aliveness bit. Returns
    (field -> array, the clusters)."""
    from raft_tpu_torch.core.cluster import Cluster
    from raft_tpu_torch.sim.run import TRACE_FIELDS

    fields = TRACE_FIELDS + ("alive",)
    clusters = [Cluster(cfg, group=g) for g in range(n_groups)]
    out = {f: np.zeros((n_ticks, n_groups, cfg.k), np.int64)
           for f in fields}
    for t in range(n_ticks):
        for g, c in enumerate(clusters):
            c.tick()
            for k, view in enumerate(c.snapshot()):
                for f in fields:
                    out[f][t, g, k] = getattr(view, f)
    return out, clusters


def oracle_divergence(cfg, n_groups: int, n_ticks: int,
                      oracle_groups: int | None = None, device="cuda"):
    """First divergence between the CPU oracle and the plain batched
    tick on `device` over the per-node trace, or None when lockstep
    holds. The batched side runs all `n_groups`; the oracle the first
    `oracle_groups` (groups are independent and keyed by their global
    id, so the slice is exact). Returns {tick, group, node, field, cpu,
    batched} on divergence."""
    from raft_tpu_torch.sim import state
    from raft_tpu_torch.sim.run import trace

    g_oracle = n_groups if oracle_groups is None \
        else min(oracle_groups, n_groups)
    cpu, _ = oracle_trace(cfg, g_oracle, n_ticks)
    _, tr = trace(cfg, state.init(cfg, n_groups, device=device), n_ticks)
    for f, a in cpu.items():
        b = tr[f][:, :g_oracle].to("cpu").numpy().astype(np.int64)
        if not np.array_equal(a, b):
            t, g, k = (int(x) for x in np.argwhere(a != b)[0])
            return {"tick": t, "group": g, "node": k, "field": f,
                    "cpu": int(a[t, g, k]), "batched": int(b[t, g, k])}
    return None
