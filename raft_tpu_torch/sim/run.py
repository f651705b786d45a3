"""Multi-tick runner and metrics for the plain PyTorch tick (the JAX
package's `sim/run.py`, with its `lax.scan` as a Python loop).

Metrics:
- `committed[G]`: running max over ticks of the per-group max commit
  index — entries durably committed by the group ("consensus rounds").
- election latency: per group, the length of each leaderless streak
  (consecutive ticks with no alive leader), recorded when a leader
  (re)appears, in a bounded histogram `[0..H)` whose bucket H-1 absorbs
  longer streaks; `max_latency` keeps the exact longest streak so
  censoring is detectable (`latency_censored`).
- `safety[G]`: running AND of the per-tick safety predicate
  (`check.tick_safety`).
- client lanes (scheduled clients on): `client_acked[G]` and
  `client_retries[G]` recomputed each tick from the client state, the
  `[H]` ack-latency histogram of the ops acked each tick and the
  longest ack latency `client_max_lat`.

`trace` runs the same loop and stacks the per-tick observables the CPU
oracle's snapshots carry, for the oracle differential
(`obs.triage.oracle_divergence`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.config import CONFIG_FLAG, RaftConfig
from raft_tpu_torch.core.node import LEADER
from raft_tpu_torch.obs import trace
from raft_tpu_torch.sim import check
from raft_tpu_torch.sim.state import I32, State, widen_state
from raft_tpu_torch.sim.step import tick

HIST_SIZE = 512


class Metrics(NamedTuple):
    committed: torch.Tensor    # i32[G] — running max of per-group max commit
    leaderless: torch.Tensor   # i32[G] — current leaderless streak, in ticks
    elections: torch.Tensor    # i32 — completed leader-acquisition events
    hist: torch.Tensor         # i32[H] — election-latency histogram
    max_latency: torch.Tensor  # i32 — exact longest completed streak
    safety: torch.Tensor       # i32[G] — per-tick safety AND (1 = never bad)
    # Client SLO lanes: present only with scheduled clients on.
    client_acked: torch.Tensor | None = None    # i32[G] — ops acked
    client_retries: torch.Tensor | None = None  # i32[G] — re-submissions
    client_hist: torch.Tensor | None = None     # i32[H] — ack latencies
    client_max_lat: torch.Tensor | None = None  # i32 — longest acked op


@trace.spanned("run.metrics_init")
def metrics_init(n_groups: int, hist_size: int = HIST_SIZE,
                 clients: bool = False, device="cuda") -> Metrics:
    """Zero metrics; `clients=True` for a scheduled-client universe."""
    device = torch.device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=device)

    cl = {}
    if clients:
        cl = dict(client_acked=z(n_groups), client_retries=z(n_groups),
                  client_hist=z(hist_size), client_max_lat=z())
    return Metrics(committed=z(n_groups), leaderless=z(n_groups),
                   elections=z(), hist=z(hist_size), max_latency=z(),
                   safety=torch.ones(n_groups, dtype=I32, device=device),
                   **cl)


def metrics_update(m: Metrics, st: State, log_cap: int) -> Metrics:
    """Fold one post-tick state into the metrics."""
    nodes = st.nodes
    committed = torch.maximum(m.committed, nodes.commit.amax(dim=1))
    has_leader = ((nodes.role == LEADER) & st.alive_prev).any(dim=1)
    done = has_leader & (m.leaderless > 0)
    bucket = torch.clamp(m.leaderless, max=m.hist.shape[0] - 1).long()
    hist = m.hist.clone()
    hist.index_add_(0, bucket, done.to(I32))
    zero = torch.zeros_like(m.leaderless)
    cl = {}
    if st.clients is not None:
        if m.client_acked is None:
            raise ValueError("state carries client traffic but the metrics "
                             "have no client lanes: metrics_init(g, "
                             "clients=True)")
        c = st.clients
        # Acked/retry totals are recomputed from monotone counters (so a
        # chunk boundary cannot double-count); the histogram folds this
        # tick's ack events (`last_lat` >= 0).
        ev = c.last_lat >= 0
        cb = torch.clamp(c.last_lat, 0, m.client_hist.shape[0] - 1)
        chist = m.client_hist.clone()
        chist.index_add_(0, cb.flatten().long(), ev.flatten().to(I32))
        cl = dict(
            client_acked=c.done.sum(dim=1, dtype=I32),
            client_retries=c.retries.sum(dim=1, dtype=I32),
            client_hist=chist,
            client_max_lat=torch.maximum(
                m.client_max_lat,
                torch.where(ev, c.last_lat, 0).amax().to(I32)))
    return m._replace(
        committed=committed,
        leaderless=torch.where(has_leader, zero, m.leaderless + 1),
        elections=m.elections + done.to(I32).sum(dtype=I32),
        hist=hist,
        max_latency=torch.maximum(
            m.max_latency, torch.where(done, m.leaderless, zero).amax()),
        safety=torch.where(check.tick_safety(st, log_cap), m.safety,
                           torch.zeros_like(m.safety)),
        **cl,
    )


def run(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0,
        metrics: Metrics | None = None):
    """Run `n_ticks` global ticks starting at absolute tick `t0`, on the
    device the state lies on. Returns (state, metrics); call again with
    the returned pair and `t0 + n_ticks` to continue the same universe.

    Under the narrow dials the state stays narrow between ticks and the
    metrics fold on its widened view. `cfg.donate_scan` is accepted and
    changes nothing: it is the JAX package's donated scan carry (one
    resident copy of the state instead of an input and an output), and
    this loop already holds one carry, dropping each tick's input as
    soon as the next state exists."""
    if metrics is None:
        metrics = metrics_init(st.alive_prev.shape[0],
                               clients=st.clients is not None,
                               device=st.alive_prev.device)
    for t in range(int(t0), int(t0) + int(n_ticks)):
        st = tick(cfg, st, t)
        metrics = metrics_update(metrics, widen_state(cfg, st), cfg.log_cap)
    return st, metrics


TRACE_FIELDS = ("term", "role", "voted_for", "leader_id", "last_index",
                "commit", "applied", "digest", "snap_index", "snap_term",
                "snap_voters", "reads_done")


def trace(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0):
    """Run `n_ticks` and return (state, trace): a dict of the per-tick
    observables `core.Cluster.snapshot` exposes, `TRACE_FIELDS` and
    `alive`, each stacked `[T, G, K]` on the state's device and read on
    the widened state (the oracle's dtypes whatever the narrow dials)."""
    fields = TRACE_FIELDS + ("alive",)
    rows = {f: [] for f in fields}
    for t in range(int(t0), int(t0) + int(n_ticks)):
        st = tick(cfg, st, t)
        sw = widen_state(cfg, st)
        for f in TRACE_FIELDS:
            rows[f].append(getattr(sw.nodes, f))
        rows["alive"].append(sw.alive_prev)
    return st, {f: torch.stack(v) for f, v in rows.items()}


def total_rounds(metrics: Metrics) -> int:
    """Total consensus rounds = entries durably committed across groups,
    summed in int64."""
    return int(metrics.committed.to(torch.int64).sum())


def total_client_ops(metrics: Metrics) -> int:
    """Client-visible ops acked exactly once, across groups (int64)."""
    return int(metrics.client_acked.to(torch.int64).sum())


def total_client_retries(metrics: Metrics) -> int:
    """Re-submissions across groups (int64): each a potential duplicate
    log entry the exactly-once fold skips."""
    return int(metrics.client_retries.to(torch.int64).sum())


def membership_changed(cfg: RaftConfig, st: State) -> torch.Tensor:
    """bool[G]: the groups whose voter set changed, a snapshot's voters
    other than all k or a membership-change entry (`CONFIG_FLAG`) in some
    node's log window."""
    n = widen_state(cfg, st).nodes
    return ((n.snap_voters != cfg.full_mask).any(dim=1)
            | ((n.log_payload & CONFIG_FLAG) != 0).flatten(1).any(dim=1))


def feature_counts(cfg: RaftConfig, st: State) -> dict:
    """What the protocol features did in a universe, read on the host
    from its State: `reads_done_total` (completed linearizable reads,
    the sum of the per-node `reads_done` counters, as `kernel.kreads`),
    `membership_changed_groups` (`membership_changed`) and `top_term`.
    Leader transfers leave no trace in State (a TimeoutNow is a mailbox
    slot for one tick, the election it starts an election like any
    other), so they are not counted. Reads back to the host: call it off
    the timed path."""
    n = widen_state(cfg, st).nodes
    return {"reads_done_total": int(n.reads_done.to(torch.int64).sum()),
            "membership_changed_groups":
                int(membership_changed(cfg, st).sum()),
            "top_term": int(n.term.max()) if n.term.numel() else 0}


def latency_quantile(hist, q: float) -> int:
    """q-quantile (in ticks) of the election-latency histogram."""
    h = _np(hist)
    total = h.sum()
    if total == 0:
        return 0
    return int(np.searchsorted(np.cumsum(h), q * total, side="left"))


def unsafe_groups(metrics: Metrics) -> int:
    """Count of groups whose per-tick safety bit dropped at any point."""
    return int((_np(metrics.safety) == 0).sum())


def latency_censored(hist, q: float) -> bool:
    """True iff the q-quantile landed in the absorbing top bucket — the
    reported quantile is then a floor, not a measurement."""
    h = _np(hist)
    return bool(h.sum() > 0 and latency_quantile(hist, q) >= h.shape[0] - 1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
