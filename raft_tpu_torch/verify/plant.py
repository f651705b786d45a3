"""Planted safety violations, for holding a safety fold (the plain
`sim/check.py` or the CUDA kernel's in-kernel one) to the predicates of
verify/invariants.py on states where they fail.

`plant_violations` edits a mid-run state so that each of five groups
breaks exactly one predicate, and empties those groups' mailboxes so no
message repairs the damage in the next tick. Run one tick on the result
and the safety lane must read 0 in exactly the planted groups.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.config import CONFIG_FLAG, RaftConfig
from raft_tpu_torch.core.node import LEADER
from raft_tpu_torch.sim.state import State, present_fields

# The predicate each planted group breaks, in group order.
KINDS = ("election_safety", "digest_agreement", "window_bounds",
         "commit_past_leader", "divergent_payload")


def plant_violations(cfg: RaftConfig, st: State):
    """(State, {kind: group}): one group of `st` broken for each of
    `KINDS`, the first in group order that can take it: one leader `a`,
    every node alive last tick, and a follower `b = (a + 1) % k` whose
    committed prefix overlaps the leader's ring window (and shares its
    applied index with a third node, for the digest)."""
    n = {f: v.clone() for f, v in st.nodes._asdict().items()
         if v is not None}
    k, cap = cfg.k, cfg.log_cap
    leaders = n["role"] == LEADER
    candidates = ((leaders.sum(dim=1) == 1) & st.alive_prev.all(dim=1))
    candidates = candidates.nonzero().flatten().tolist()
    planted = {}
    for kind in KINDS:
        for g in candidates:
            if g not in planted.values() and _plant(kind, n, g, k, cap):
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


def _plant(kind: str, n: dict, g: int, k: int, cap: int) -> bool:
    """Break `kind` in group `g` of the node leaves `n` in place; False
    (and `n` untouched) where the group cannot take it."""
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
        n["applied"][g, b] += 1   # applied past commit
    elif kind == "commit_past_leader":
        # b holds, commits and applies three entries the leader lacks
        # (the leader appends at most one in the next tick).
        new_last = int(n["last_index"][g, a]) + 3
        if new_last - int(n["snap_index"][g, b]) > cap:
            return False
        for j in range(int(n["last_index"][g, b]) + 1, new_last + 1):
            n["log_term"][g, b, (j - 1) % cap] = n["term"][g, a]
            n["log_payload"][g, b, (j - 1) % cap] = j
        for f in ("last_index", "commit", "applied"):
            n[f][g, b] = new_last
    else:   # divergent payload at the newest index both hold
        n["log_payload"][g, b, (i - 1) % cap] ^= 1
    return True


def _voter_throughout(n: dict, g: int, b: int) -> bool:
    """Node b of group g is a voter in its snapshot config and in every
    membership entry its ring holds, live or stale."""
    cfg_entries = n["log_payload"][g, b]
    cfg_entries = cfg_entries[(cfg_entries & CONFIG_FLAG) != 0]
    return bool((int(n["snap_voters"][g, b]) >> b) & 1) and \
        bool(((cfg_entries >> b) & 1).all())
