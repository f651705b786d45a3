"""Flight recorder: a fixed-size ring of per-tick per-group aggregates,
the JAX package's `obs/recorder.py` on torch tensors.

The ring keeps the last `RING` ticks of six signals per group: the
absolute tick, the alive-leader count, the election-completion bit, the
max commit index, the message volume and that tick's safety bit. Slot
`t % RING` of each `[RING, G]` ring is overwritten every tick; the
fused-chunk kernel writes the same values into its wire rows
(sim/kernel.py `kinit(..., flight=)`, `kflight`). Groups are reduced
host-side at dump time.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.node import LEADER
from raft_tpu_torch.sim import check
from raft_tpu_torch.sim.run import Metrics, metrics_init, metrics_update
from raft_tpu_torch.sim.state import I32, State, widen_state
from raft_tpu_torch.sim.step import tick

RING = 64   # ticks of history; slot t % RING holds tick t

FLIGHT_LEAVES = ("tick", "leaders", "elections", "commit", "msgs", "safety")

# Mailbox occupancy fields, in the order the message volume sums them;
# slots a universe does not carry are skipped.
PRESENCE_FIELDS = ("rv_req_present", "rv_resp_present", "ae_req_present",
                   "ae_resp_present", "is_req_present", "is_resp_present",
                   "pv_req_present", "pv_resp_present", "tn_present")


class Flight(NamedTuple):
    """Per-group ring buffers, i32[RING, G] each. Slot s holds the most
    recent tick t with t % RING == s."""

    tick: torch.Tensor       # absolute tick recorded in the slot; -1 = never
    leaders: torch.Tensor    # alive leaders in the group that tick
    elections: torch.Tensor  # 1 iff the group completed an election
    commit: torch.Tensor     # max commit index over the group's nodes
    msgs: torch.Tensor       # messages in flight out of that tick
    safety: torch.Tensor     # that tick's safety bit (1 = invariants held)


def flight_init(n_groups: int, ring: int = RING, device="cuda") -> Flight:
    device = torch.device(device)

    def z():
        return torch.zeros((ring, n_groups), dtype=I32, device=device)

    return Flight(tick=torch.full((ring, n_groups), -1, dtype=I32,
                                  device=device),
                  leaders=z(), elections=z(), commit=z(), msgs=z(),
                  safety=z())


def message_volume(st: State):
    """i32[G]: occupied mailbox slots after the tick (this tick's sends,
    after dead-sender erasure)."""
    total = None
    for f in PRESENCE_FIELDS:
        p = getattr(st.mailbox, f)
        if p is None:
            continue
        v = p.to(I32).sum(dim=(1, 2), dtype=I32)
        total = v if total is None else total + v
    return total


def flight_update(cfg: RaftConfig, f: Flight, st: State, m_prev: Metrics,
                  t: int) -> Flight:
    """Record tick `t`'s aggregates into slot t % RING. `m_prev` is the
    metrics before this tick's fold (the election bit is derived from
    the previous leaderless streak, as `metrics_update` derives it)."""
    nodes = st.nodes
    ring = f.tick.shape[0]
    on = (torch.arange(ring, device=f.tick.device) == t % ring)[:, None]
    leaders = ((nodes.role == LEADER) & st.alive_prev).to(I32).sum(
        dim=1, dtype=I32)
    done = ((leaders > 0) & (m_prev.leaderless > 0)).to(I32)
    commit = nodes.commit.amax(dim=1)
    safe = check.tick_safety(st, cfg.log_cap).to(I32)

    def w(r, val):
        return torch.where(on, val[None, :], r)

    return Flight(tick=torch.where(on, t, f.tick), leaders=w(f.leaders,
                                                              leaders),
                  elections=w(f.elections, done), commit=w(f.commit, commit),
                  msgs=w(f.msgs, message_volume(st)), safety=w(f.safety, safe))


def run_recorded(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0,
                 metrics: Metrics | None = None,
                 flight: Flight | None = None):
    """`sim.run.run` with the flight recorder riding the loop: returns
    (state, metrics, flight). State and metrics are those of run.run;
    chunked drivers pass the returned metrics and flight back in."""
    g, dev = st.alive_prev.shape[0], st.alive_prev.device
    if metrics is None:
        metrics = metrics_init(g, clients=st.clients is not None, device=dev)
    if flight is None:
        flight = flight_init(g, device=dev)
    for t in range(int(t0), int(t0) + int(n_ticks)):
        st = tick(cfg, st, t)
        wide = widen_state(cfg, st)
        flight = flight_update(cfg, flight, wide, metrics, t)
        metrics = metrics_update(metrics, wide, cfg.log_cap)
    return st, metrics, flight


def flight_rows(f: Flight, g: int | None = None) -> list[dict]:
    """The rings reduced over groups, one dict per recorded tick, oldest
    first. `g` keeps the first g groups."""
    leaves = {k: v.detach().cpu().numpy() for k, v in zip(Flight._fields, f)}
    if g is not None:
        leaves = {k: v[:, :g] for k, v in leaves.items()}
    ticks = leaves["tick"].max(axis=1)   # the same value in every group
    rows = []
    for s in np.argsort(ticks, kind="stable"):
        if ticks[s] < 0:
            continue   # slot never written
        rows.append({
            "tick": int(ticks[s]),
            "leaders": int(leaves["leaders"][s].astype(np.int64).sum()),
            "elections": int(leaves["elections"][s].astype(np.int64).sum()),
            "commit_total": int(leaves["commit"][s].astype(np.int64).sum()),
            "msgs": int(leaves["msgs"][s].astype(np.int64).sum()),
            "unsafe_groups": int((leaves["safety"][s] == 0).sum()),
        })
    return rows


def dump_flight(f: Flight, g: int | None = None, label: str = "flight",
                log=None) -> list[dict]:
    """Print the ring, one line per recorded tick (to stderr unless `log`
    is given); returns the rows."""
    if log is None:
        def log(s):
            print(s, file=sys.stderr, flush=True)
    rows = flight_rows(f, g)
    log(f"[{label}] flight recorder: {len(rows)} tick(s) recorded")
    for r in rows:
        log(f"[{label}]   tick {r['tick']:>6}: leaders={r['leaders']} "
            f"elections={r['elections']} commit_total={r['commit_total']} "
            f"msgs={r['msgs']} unsafe_groups={r['unsafe_groups']}")
    return rows
