"""Planted safety violations, for holding a safety fold (the plain
`sim/check.py` or the CUDA kernel's in-kernel one) to the predicates of
verify/invariants.py on states where they fail.

`plant_violations` edits a mid-run state so that each of five groups
(seven with scheduled clients on) breaks exactly one predicate, and
empties those groups' mailboxes so no message repairs the damage in the
next tick. Run one tick on the result and the safety lane must read 0 in
exactly the planted groups.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.config import CONFIG_FLAG, RaftConfig
from raft_tpu_torch.core.node import LEADER
from raft_tpu_torch.sim.state import State, present_fields

# The predicate each planted group breaks, in group order.
KINDS = ("election_safety", "digest_agreement", "window_bounds",
         "commit_past_leader", "divergent_payload")
# The two clauses of the exactly-once invariant, planted with clients on.
CLIENT_KINDS = ("client_phantom", "client_divergent")


def kinds(cfg: RaftConfig) -> tuple:
    """The kinds `plant_violations` plants in a universe."""
    return KINDS + (CLIENT_KINDS if cfg.clients_u32 else ())


def plant_violations(cfg: RaftConfig, st: State):
    """(State, {kind: group}): one group of `st` broken for each of
    `kinds(cfg)`, the first in group order that can take it: one leader
    `a`, every node alive last tick, and a follower `b = (a + 1) % k`
    whose committed prefix overlaps the leader's ring window (and shares
    its applied index with a third node, for the digest)."""
    n = {f: v.clone() for f, v in st.nodes._asdict().items()
         if v is not None}
    k, cap = cfg.k, cfg.log_cap
    leaders = n["role"] == LEADER
    candidates = ((leaders.sum(dim=1) == 1) & st.alive_prev.all(dim=1))
    candidates = candidates.nonzero().flatten().tolist()
    planted = {}
    for kind in kinds(cfg):
        for g in candidates:
            if g not in planted.values() and _plant(kind, n, g, k, cap,
                                                    st.clients):
                planted[kind] = g
                break
        else:
            raise ValueError(f"no group of the state can take {kind}")
    groups = torch.tensor(list(planted.values()), device=st.group_id.device)
    mb = st.mailbox._asdict()
    for f in present_fields(cfg):
        mb[f] = mb[f].clone()
        mb[f][groups] = False
    return st._replace(nodes=st.nodes._replace(**n),
                       mailbox=st.mailbox._replace(**mb)), planted


def _plant(kind: str, n: dict, g: int, k: int, cap: int, cl) -> bool:
    """Break `kind` in group `g` of the node leaves `n` in place; False
    (and `n` untouched) where the group cannot take it."""
    if kind in CLIENT_KINDS:
        return _plant_client(kind, n, g, k, cl)
    a = int((n["role"][g] == LEADER).int().argmax())
    b = (a + 1) % k
    i = min(int(n["commit"][g, b]), int(n["last_index"][g, a]))
    if i <= max(int(n["snap_index"][g, a]), int(n["snap_index"][g, b])):
        return False   # b's committed prefix misses the leader's window
    if kind == "election_safety":
        if not _voter_throughout(n, g, b):
            return False   # a removed leader would step down this tick
        n["role"][g, b] = LEADER
        n["term"][g, b] = n["term"][g, a]
    elif kind == "digest_agreement":
        if not any(c != b and n["applied"][g, c] == n["applied"][g, b]
                   for c in range(k)):
            return False
        n["digest"][g, b] ^= 1
    elif kind == "window_bounds":
        if _applied_by_other(n, g, b, int(n["applied"][g, b]) + 1):
            return False   # the digest and table clauses would trip too
        n["applied"][g, b] += 1   # applied past commit
    elif kind == "commit_past_leader":
        # b holds, commits and applies three entries the leader lacks
        # (the leader appends at most one in the next tick).
        new_last = int(n["last_index"][g, a]) + 3
        if new_last - int(n["snap_index"][g, b]) > cap \
                or _applied_by_other(n, g, b, new_last):
            return False
        for j in range(int(n["last_index"][g, b]) + 1, new_last + 1):
            n["log_term"][g, b, (j - 1) % cap] = n["term"][g, a]
            n["log_payload"][g, b, (j - 1) % cap] = j
        for f in ("last_index", "commit", "applied"):
            n[f][g, b] = new_last
    else:   # divergent payload at the newest index both hold
        n["log_payload"][g, b, (i - 1) % cap] ^= 1
    return True


def _applied_by_other(n: dict, g: int, b: int, applied: int) -> bool:
    """Some node of group g other than b has applied through `applied`."""
    return any(int(n["applied"][g, c]) == applied
               for c in range(n["applied"].shape[1]) if c != b)


def _voter_throughout(n: dict, g: int, b: int) -> bool:
    """Node b of group g is a voter in its snapshot config and in every
    membership entry its ring holds, live or stale."""
    cfg_entries = n["log_payload"][g, b]
    cfg_entries = cfg_entries[(cfg_entries & CONFIG_FLAG) != 0]
    return bool((int(n["snap_voters"][g, b]) >> b) & 1) and \
        bool(((cfg_entries >> b) & 1).all())


def _plant_client(kind: str, n: dict, g: int, k: int, cl) -> bool:
    """One clause of the exactly-once invariant, broken so that the next
    tick cannot repair it. Phantom: every node's sid-0 entry 7 above the
    issued frontier, so the tables stay equal and `done` (+1 at most per
    tick) stays below them. Divergent: at a slot with no op in flight and
    none pulsed, one of two nodes with equal applied prefixes takes the
    frontier `done` as its entry, which no log entry carries yet (and the
    other node's entry is below it)."""
    table = n["session_seq"]
    if kind == "client_phantom":
        table[g, :, 0] = cl.done[g, 0] + 7
        return True
    idle = ((cl.inflight[g] == 0) & (cl.submit[g] == 0)).nonzero()
    pairs = [(x, y) for x in range(k) for y in range(x + 1, k)
             if n["applied"][g, x] == n["applied"][g, y]]
    if not len(idle) or not pairs:
        return False
    table[g, pairs[0][1], int(idle[0])] = cl.done[g, int(idle[0])]
    return True
