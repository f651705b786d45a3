"""[Frozen copy of `raft_tpu_torch/verify/invariants.py` for the benchmark's reference,
its imports pointed at `raftbench.reference`.]

Raft's safety properties as predicates over torch tensors, term for
term the JAX package's `verify/invariants.py`: those the per-tick
safety fold checks (sim/check.py `tick_safety`), and the checker-side
`log_matching` and `commit_durability`.

Axis convention: the node axis is LAST for scalar leaves (`[..., K]`),
second-to-last for ring leaves (`[..., K, L]`). Predicates return
`bool[...]`, one bit per group.
"""

from __future__ import annotations

import torch

from raftbench.reference.node import LEADER


def _signed(a):
    """`a` as a signed >= 32-bit lane: the window arithmetic below must
    not wrap. Bools and signed lanes of 32 bits or more pass through."""
    if a.dtype == torch.bool or a.dtype in (torch.int32, torch.int64):
        return a
    return a.to(torch.int64)


def slot_abs_index(snap_index, log_cap: int):
    """`[..., L]` absolute index each ring slot holds under the window
    (snap, snap + L]: snap + 1 + ((s - snap) mod L)."""
    snap_index = _signed(snap_index)
    s = torch.arange(log_cap, dtype=snap_index.dtype,
                     device=snap_index.device)
    off = s - snap_index[..., None] % log_cap
    return snap_index[..., None] + 1 + torch.where(off >= 0, off,
                                                   off + log_cap)


def election_safety(role, term):
    """No two current leaders share a term."""
    k = role.shape[-1]
    ok = torch.ones(role.shape[:-1], dtype=torch.bool, device=role.device)
    for a in range(k):
        for b in range(a + 1, k):
            clash = ((role[..., a] == LEADER) & (role[..., b] == LEADER)
                     & (term[..., a] == term[..., b]))
            ok = ok & ~clash
    return ok


def digest_agreement(applied, digest):
    """Nodes that applied the same prefix hold the same digest."""
    k = applied.shape[-1]
    ok = torch.ones(applied.shape[:-1], dtype=torch.bool,
                    device=applied.device)
    for a in range(k):
        for b in range(a + 1, k):
            clash = ((applied[..., a] == applied[..., b])
                     & (digest[..., a] != digest[..., b]))
            ok = ok & ~clash
    return ok


def window_bounds(applied, commit, snap_index, last_index, log_cap: int):
    """applied == commit, snap <= commit <= last, window within L."""
    applied, commit, snap_index, last_index = (
        _signed(a) for a in (applied, commit, snap_index, last_index))
    ok = ((applied == commit)
          & (snap_index <= commit) & (commit <= last_index)
          & (last_index - snap_index <= log_cap))
    return ok.all(dim=-1)


def log_matching(last_index, snap_index, log_term, log_payload,
                 log_cap: int):
    """Log Matching, point-in-time: if two logs hold an entry with the
    same index and term, the entries carry the same payload. Slot s
    holds the same absolute index on two nodes exactly when their slot
    indices agree, so the pairwise compare is elementwise. Checker-side:
    not in the per-tick fold."""
    last_index = _signed(last_index)
    k = last_index.shape[-1]
    ok = torch.ones(last_index.shape[:-1], dtype=torch.bool,
                    device=last_index.device)
    absidx = slot_abs_index(snap_index, log_cap)      # [..., K, L]
    for a in range(k):
        for b in range(a + 1, k):
            live = ((absidx[..., a, :] == absidx[..., b, :])
                    & (absidx[..., a, :] <= last_index[..., a, None])
                    & (absidx[..., b, :] <= last_index[..., b, None]))
            m = live & (log_term[..., a, :] == log_term[..., b, :])
            agree = torch.where(
                m, log_payload[..., a, :] == log_payload[..., b, :],
                True).all(dim=-1)
            ok = ok & agree
    return ok


def leader_completeness(role, term, commit, last_index, snap_index,
                        log_payload, log_cap: int):
    """For each ordered pair (a, b) with role_a == LEADER and
    term_a >= term_b: commit_b <= last_index_a, and on every ring lane
    where both slots map to the same absolute index within b's committed
    prefix and a's log, the payloads agree."""
    term = _signed(term)   # a u16 term has no ordered compare on the CPU
    commit = _signed(commit)
    last_index = _signed(last_index)
    k = role.shape[-1]
    ok = torch.ones(role.shape[:-1], dtype=torch.bool, device=role.device)
    absidx = slot_abs_index(snap_index, log_cap)      # [..., K, L]
    for a in range(k):
        for b in range(k):
            if a == b:
                continue
            cond = (role[..., a] == LEADER) & (term[..., a] >= term[..., b])
            holds = commit[..., b] <= last_index[..., a]
            lim = torch.minimum(commit[..., b], last_index[..., a])
            m = ((absidx[..., a, :] == absidx[..., b, :])
                 & (absidx[..., a, :] <= lim[..., None]))
            agree = torch.where(
                m, log_payload[..., a, :] == log_payload[..., b, :],
                True).all(dim=-1)
            ok = ok & (~cond | (holds & agree))
    return ok


def commit_durability(commit, last_index, snap_index, log_payload,
                      log_cap: int):
    """Every index in a node's committed prefix that is still in its
    window is held by a majority of the k nodes: node a holds index i
    when i <= snap_index_a, or i sits live in a's window on the same
    ring lane with the same payload. This is what acking an entry that
    storage rejected breaks. Checker-side: not in the per-tick fold
    (under membership change a commit quorum is a majority of the live
    voter set, which the k-majority over-approximates)."""
    commit = _signed(commit)
    last_index = _signed(last_index)
    k = commit.shape[-1]
    majority = k // 2 + 1
    absidx = slot_abs_index(snap_index, log_cap)      # [..., K, L]
    snap = _signed(snap_index)
    ok = torch.ones(commit.shape[:-1], dtype=torch.bool,
                    device=commit.device)
    for b in range(k):
        idx_b = absidx[..., b, :]                         # [..., L]
        live = idx_b <= commit[..., b, None]   # committed, in b's window
        cnt = torch.zeros(idx_b.shape, dtype=torch.int32,
                          device=idx_b.device)
        for a in range(k):
            held = ((idx_b <= snap[..., a, None])
                    | ((absidx[..., a, :] == idx_b)
                       & (idx_b <= last_index[..., a, None])
                       & (log_payload[..., a, :]
                          == log_payload[..., b, :])))
            cnt = cnt + held.to(torch.int32)
        ok = ok & torch.where(live, cnt >= majority, True).all(dim=-1)
    return ok


def client_safety(applied, session_seq, done):
    """The exactly-once invariant: nodes with the same applied prefix
    hold identical (sid -> seq) dedup tables, and no table entry exceeds
    the slot's issued frontier. `session_seq` is `[..., K, S]`, `done`
    `[..., S]`."""
    k = session_seq.shape[-2]
    ok = (session_seq <= done[..., None, :]).all(dim=-1).all(dim=-1)
    for a in range(k):
        for b in range(a + 1, k):
            clash = ((applied[..., a] == applied[..., b])
                     & (session_seq[..., a, :]
                        != session_seq[..., b, :]).any(dim=-1))
            ok = ok & ~clash
    return ok
