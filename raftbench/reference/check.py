"""[Frozen copy of `raft_tpu_torch/sim/check.py` for the benchmark's reference,
its imports pointed at `raftbench.reference`.]

Safety predicates over a batched `State`, each `bool[G]`: the named
clauses, `predicate_report` (the clause registry) and `tick_safety`,
their AND, folded into `Metrics.safety` every tick (sim/run.py
`metrics_update`; the CUDA kernel folds the same predicate in-kernel).
The predicate bodies live in verify/invariants.py.
"""

from __future__ import annotations

from raftbench.reference.state import State
from raftbench.reference import invariants as inv


def election_safety(st: State):
    """No two current leaders share a term (crashed leaders still hold
    their term)."""
    return inv.election_safety(st.nodes.role, st.nodes.term)


def digest_agreement(st: State):
    """Nodes that applied the same prefix hold the same digest."""
    return inv.digest_agreement(st.nodes.applied, st.nodes.digest)


def window_bounds(st: State, log_cap: int):
    """applied == commit, snap <= commit <= last, window within L."""
    n = st.nodes
    return inv.window_bounds(n.applied, n.commit, n.snap_index,
                             n.last_index, log_cap)


def leader_completeness(st: State, log_cap: int):
    """A current leader's log covers every node's committed prefix of a
    term at most its own."""
    n = st.nodes
    return inv.leader_completeness(n.role, n.term, n.commit, n.last_index,
                                   n.snap_index, n.log_payload, log_cap)


def client_safety(st: State):
    """The exactly-once invariant over the dedup tables and the clients'
    issued frontiers (scheduled clients on)."""
    return inv.client_safety(st.nodes.applied, st.nodes.session_seq,
                             st.clients.done)


def predicate_report(st: State, log_cap: int) -> dict:
    """name -> bool[G]: `tick_safety`'s clauses separately, in a stable
    key order (the nemesis search names which invariant a state breaks
    by these keys). `all_invariants`, and so `tick_safety`, is its
    AND."""
    out = {"election_safety": election_safety(st),
           "digest_agreement": digest_agreement(st),
           "window_bounds": window_bounds(st, log_cap)}
    if st.clients is not None:
        out["client_safety"] = client_safety(st)
    out["leader_completeness"] = leader_completeness(st, log_cap)
    return out


def all_invariants(st: State, log_cap: int):
    ok = None
    for v in predicate_report(st, log_cap).values():
        ok = v if ok is None else ok & v
    return ok


def tick_safety(st: State, log_cap: int):
    """bool[G]: the per-tick safety predicate ANDed into `Metrics.safety`
    by both engines: every clause of `predicate_report`."""
    return all_invariants(st, log_cap)
