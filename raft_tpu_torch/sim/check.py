"""The per-tick safety predicate over a batched `State`, folded into
`Metrics.safety` every tick (sim/run.py `metrics_update`; the CUDA
kernel folds the same predicate in-kernel). The predicate bodies live
in verify/invariants.py.
"""

from __future__ import annotations

from raft_tpu_torch.sim.state import State
from raft_tpu_torch.verify import invariants as inv


def client_safety(st: State):
    """bool[G]: the exactly-once invariant over the dedup tables and the
    clients' issued frontiers (scheduled clients on)."""
    return inv.client_safety(st.nodes.applied, st.nodes.session_seq,
                             st.clients.done)


def tick_safety(st: State, log_cap: int):
    """bool[G]: election safety, digest agreement, window bounds, the
    exactly-once invariant (scheduled clients on) and leader
    completeness, ANDed."""
    n = st.nodes
    ok = (inv.election_safety(n.role, n.term)
          & inv.digest_agreement(n.applied, n.digest)
          & inv.window_bounds(n.applied, n.commit, n.snap_index,
                              n.last_index, log_cap))
    if st.clients is not None:
        ok = ok & client_safety(st)
    return ok & inv.leader_completeness(n.role, n.term, n.commit,
                                        n.last_index, n.snap_index,
                                        n.log_payload, log_cap)
