"""Deterministic open-loop client workload, on torch tensors: the JAX
package's `clients/workload.py` (its pure-Python oracle mirror,
`HostClients`, is not ported).

Per (group, sid) slot:
- arrival: a new op arrives with probability `cfg.client_rate` each
  tick, hashed from (seed, TAG_CLIENT_ARRIVAL, g, sid, t), and joins the
  slot's backlog (open loop: arrivals never wait for acks);
- submission: an idle client with backlog starts its next op
  (seq = `done`) and raises a one-tick `submit` pulse; every node that
  believes itself leader appends it in the next tick's phase C;
- ack: once any node's applied dedup table holds seq >= done; latency =
  t_ack - t_start;
- retry: no ack within `cfg.client_retry_backoff` ticks of the last
  submission re-submits the same (sid, seq, val) payload, which the
  exactly-once fold applies once;
- admission (cfg.client_queue_cap > 0): an arrival that would push the
  backlog past the cap is shed, never issued a seq.

Arrivals stop at 1,024 lifetime ops per slot (the 10-bit seq field).
`client_update` / `submit_payloads` are elementwise over broadcastable
coordinate grids, so they serve any layout.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import config as _c
from raft_tpu_torch.clients.state import ClientState
from raft_tpu_torch.utils import trng

I32 = torch.int32
W = torch.where


def workload_params(cfg) -> dict:
    """The client-workload provenance a client-SLO number is reported
    with."""
    return {"rate": cfg.client_rate, "slots": cfg.client_slots,
            "retry_backoff": cfg.client_retry_backoff,
            "retry_policy": "fixed-interval-resubmit",
            "queue_cap": cfg.client_queue_cap,
            "seed": cfg.seed}


def table_max(session_seq, node_axis: int):
    """The group's durable-commit witness: the max applied seq per sid
    over its nodes (`node_axis` is the K axis: 1 for `[G, K, S]`)."""
    return session_seq.amax(dim=node_axis)


def client_update(cfg, cs: ClientState, tmax, g, sid, t) -> ClientState:
    """One client transition on the post-tick state: ack, arrival,
    admission, retry, start. Elementwise over the grids `g` / `sid` and
    the per-slot table witness `tmax`; `t` is the absolute tick."""
    acked = (cs.inflight != 0) & (tmax >= cs.done)
    last_lat = W(acked, t - cs.t_start, -1).to(I32)
    done = cs.done + acked.to(I32)
    inflight = W(acked, 0, cs.inflight)
    room = (done + cs.backlog + inflight) <= _c.SESSION_SEQ_MASK
    arrive = trng.client_arrives(cfg.seed, g, sid, t, cfg.clients_u32) & room
    shed = cs.shed
    if cfg.client_queue_cap > 0:
        admit = cs.backlog < cfg.client_queue_cap
        shed = shed + (arrive & ~admit).to(I32)
        arrive = arrive & admit
    backlog = cs.backlog + arrive.to(I32)
    # Retry before start: only an op that stayed in flight re-submits.
    retry = (inflight != 0) & ((t - cs.t_sub) >= cfg.client_retry_backoff)
    start = (inflight == 0) & (backlog > 0)
    go = start | retry
    return ClientState(
        done=done,
        backlog=backlog - start.to(I32),
        inflight=W(start, 1, inflight),
        t_start=W(start, t, cs.t_start).to(I32),
        t_sub=W(go, t, cs.t_sub).to(I32),
        submit=go.to(I32),
        retries=cs.retries + retry.to(I32),
        last_lat=last_lat,
        shed=shed,
    )


def submit_payloads(cfg, cs: ClientState, g, sid):
    """(submit, payload): the pulses phase C consumes and the 30-bit
    session payloads they carry (seq = the slot's `done`, the value
    hashed from the op identity so a retry is byte-identical)."""
    val = trng.client_val(cfg.seed, g, sid, cs.done)
    payload = (_c.SESSION_FLAG | (sid << _c.SESSION_SID_SHIFT)
               | (cs.done << _c.SESSION_SEQ_SHIFT) | val)
    return cs.submit, payload.to(I32)


def exactly_once_report(cfg, st, metrics=None):
    """(ok, detail): exactly-once accounting over a final state, the
    endpoint complement of the per-tick `client_safety` clause. Per
    group: nodes with the same applied prefix hold identical dedup
    tables; no table holds a seq above the slot's issued frontier
    (`done`); the most-applied node holds the group's max table;
    `client_acked` equals the sum of `done` (when `metrics` carries the
    client lanes); the shed ledger exists exactly when the cap is on, no
    backlog exceeds the cap and no shed count is negative."""
    nodes, cl = st.nodes, st.clients
    if cl is None or nodes.session_seq is None:
        return False, "state carries no client subsystem"
    table = _np(nodes.session_seq)                 # [G, K, S]
    applied = _np(nodes.applied)                   # [G, K]
    done = _np(cl.done)                            # [G, S]
    g, k, s = table.shape
    problems = []
    for a in range(k):
        for b in range(a + 1, k):
            bad = (applied[:, a] == applied[:, b]) \
                & (table[:, a] != table[:, b]).any(axis=-1)
            if bad.any():
                problems.append(
                    f"nodes {a}/{b}: {int(bad.sum())} group(s) with equal "
                    f"applied prefix but divergent dedup tables")
    over = table > done[:, None, :]
    if over.any():
        problems.append(f"{int(over.any(axis=(1, 2)).sum())} group(s) hold "
                        f"a table seq above the issued frontier")
    top = np.take_along_axis(
        table, applied.argmax(axis=1)[:, None, None], axis=1)[:, 0, :]
    lag = top < table.max(axis=1)
    if lag.any():
        problems.append(f"{int(lag.any(axis=1).sum())} group(s): a node "
                        f"with a shorter applied prefix holds a HIGHER "
                        f"dedup seq than the most-applied node")
    if metrics is not None and metrics.client_acked is not None:
        if not np.array_equal(_np(metrics.client_acked), done.sum(axis=1)):
            problems.append("client_acked metric != sum of per-slot done")
    cap = cfg.client_queue_cap
    if (cl.shed is None) != (cap == 0):
        problems.append(
            f"ClientState.shed {'absent' if cl.shed is None else 'present'} "
            f"but cfg.client_queue_cap == {cap} — the shed ledger must "
            f"exist exactly when admission control is on")
    n_shed = 0
    if cap > 0 and cl.shed is not None:
        shed = _np(cl.shed)
        n_shed = int(shed.sum())
        if (shed < 0).any():
            problems.append("negative shed count — the reject ledger "
                            "only ever increments")
        over_cap = _np(cl.backlog) > cap
        if over_cap.any():
            problems.append(
                f"{int(over_cap.any(axis=1).sum())} group(s) hold a "
                f"backlog above client_queue_cap={cap} — an arrival "
                f"bypassed the admission gate")
    return (not problems,
            "; ".join(problems) if problems else
            f"exactly-once ok over {g} group(s) x {s} slot(s): "
            f"{int(done.sum())} acked op(s)"
            + (f", {n_shed} shed" if cap > 0 else "")
            + ", tables consistent")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
