"""Cluster harness: builds one Raft group, drives ticks, checks invariants.

Also the trace source of the oracle-vs-batched differential: `snapshot()`
captures exactly the per-node fields the batched state carries.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch import config as _c
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.node import Node, LEADER
from raft_tpu_torch.core.transport import Transport
from raft_tpu_torch.utils import rng


@dataclasses.dataclass
class NodeView:
    """Per-node observable state after phase A of a tick."""
    term: int
    role: int
    voted_for: int
    leader_id: int
    last_index: int
    commit: int
    applied: int
    digest: int
    snap_index: int
    snap_term: int
    snap_voters: int
    reads_done: int
    alive: bool


class SafetyViolation(AssertionError):
    pass


class Cluster:
    def __init__(self, cfg: RaftConfig, group: int = 0,
                 check_invariants: bool = True):
        self.cfg = cfg
        self.g = group
        self.check = check_invariants
        self.transport = Transport(cfg, group)
        self.nodes = [Node(cfg, group, i, self.transport, self._on_apply)
                      for i in range(cfg.k)]
        self.tick_count = 0
        self.alive_prev = [True] * cfg.k
        # Test hook: (tick) -> List[bool] overriding the hash-based crash
        # schedule. Instance attribute (like Transport.link_filter) so one
        # test's schedule can never leak into another cluster.
        self.alive_fn = None
        # Safety bookkeeping.
        self._leaders_by_term: Dict[int, int] = {}
        # index -> payload. Identity of a committed entry is (index, payload):
        # the term of an entry may legitimately be rewritten by a leader
        # takeover re-proposal (DESIGN.md §2a) without changing the entry.
        self._committed: Dict[int, int] = {}
        # Shadow of the state machine's session-allocation rule (first
        # REGISTER to claim an sid owns it), maintained from the same
        # first-application events as the commit-identity map — lets
        # `open_session` tell a successful registration from a no-op
        # collision without peeking at server state mid-protocol.
        self._session_owner: Dict[int, int] = {}
        self.total_applies = 0
        # Scheduled open-loop client traffic (DESIGN.md §10): the
        # host-side mirror of the batched client transition — pulses
        # feed phase C, the post-tick dedup-table witness feeds back.
        if cfg.clients_u32:
            from raft_tpu_torch.clients.workload import HostClients
            self.clients = HostClients(cfg, group)
        else:
            self.clients = None

    # ---------------------------------------------------------------- faults

    def alive(self, tick: int) -> List[bool]:
        if self.alive_fn is not None:
            return list(self.alive_fn(tick))
        cfg = self.cfg
        out = [rng.node_alive(cfg.seed, self.g, i, tick,
                              cfg.crash_u32, cfg.crash_epoch)
               for i in range(cfg.k)]
        nem_crash = cfg.nem_crash   # one program filter per call
        if nem_crash:
            # Nemesis crash-storm clauses AND into the base schedule
            # (DESIGN.md §14) — the batched tick applies the same mask.
            out = [a and rng.nem_alive(cfg.seed, nem_crash, self.g,
                                       i, tick)
                   for i, a in enumerate(out)]
        return out

    # ------------------------------------------------------------ invariants

    def _on_apply(self, node_id: int, index: int, term: int, payload: int):
        self.total_applies += 1
        if not self.check:
            return
        prev = self._committed.get(index)
        if prev is None:
            self._committed[index] = payload
            if self.cfg.sessions:
                if payload == _c.SESSION_REGISTER:
                    self._session_owner.setdefault(
                        index % _c.SESSION_SID_MASK, index)
        elif prev != payload:
            raise SafetyViolation(
                f"group {self.g}: node {node_id} applied payload {payload} at "
                f"index {index}, but {prev} was already applied there")

    def _check_election_safety(self):
        # Scans ALL nodes, crashed included: a crashed leader still "holds"
        # its term — no other leader may ever exist for it.
        for n in self.nodes:
            if n.role == LEADER:
                prev = self._leaders_by_term.get(n.term)
                if prev is None:
                    self._leaders_by_term[n.term] = n.id
                elif prev != n.id:
                    raise SafetyViolation(
                        f"group {self.g}: two leaders in term {n.term}: "
                        f"{prev} and {n.id}")

    # ------------------------------------------------------------------ tick

    def tick(self):
        t = self.tick_count
        alive_now = self.alive(t)
        for n in self.nodes:
            n.now = t   # client-API clock (ReadIndex ack timestamps)
        for i, n in enumerate(self.nodes):
            if alive_now[i] and not self.alive_prev[i]:
                n.restart()
        inboxes = self.transport.deliver(t, alive_now)
        # Pulses raised by the previous tick's client transition — read
        # BEFORE the phases (the batched path snapshots them the same
        # way: submit_payloads on the start-of-tick state).
        client_cmds = (self.clients.pending_cmds()
                       if self.clients is not None else None)
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_d(inboxes[i])
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_t()
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_c(client_cmds)
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_a()
        # Crashed nodes sent nothing; anything they had queued pre-crash was
        # already in flight and still delivers.
        if self.clients is not None:
            # Post-tick client transition: the durable-commit witness is
            # the max applied seq per sid over ALL nodes (a crashed
            # node's frozen table still witnesses committed applies),
            # exactly the batched table_max.
            self.clients.observe(
                [max(n.sessions.get(s, -1) for n in self.nodes)
                 for s in range(self.cfg.client_slots)], t)
        if self.check:
            self._check_election_safety()
        self.alive_prev = alive_now
        self.tick_count += 1

    def run(self, ticks: int):
        for _ in range(ticks):
            self.tick()

    # ------------------------------------------------------------ client API

    def propose(self, payload: int):
        """Route a client write to the current leader. Returns a
        (index, payload) ticket or None (no leader / window full —
        retry). Committed iff `is_committed(ticket)` ever holds; a
        ticket can also be lost (leader deposed before replication), in
        which case it never commits and the client re-proposes."""
        lead = self.leader()
        if lead is None:
            return None
        idx = self.nodes[lead].propose(payload)
        if idx is None:
            return None
        return (idx, payload)

    def is_committed(self, ticket) -> bool:
        """True iff the proposed (index, payload) has been applied by
        some node — the commit-identity map is the authority."""
        idx, payload = ticket
        return self._committed.get(idx) == payload

    def open_session(self, max_ticks: int = 200):
        """Register a client session (dissertation §6.3): propose the
        REGISTER entry, tick until it commits, and return the
        index-derived session id (or None if nothing commits within the
        budget). cfg.sessions only.

        A ticket is LOST when its leader is deposed before replication
        and a later leader commits a different payload at that index —
        detected below via the commit-identity map, which resets the
        ticket so the loop re-proposes immediately instead of burning
        the remaining tick budget waiting on an index that can never
        hold a REGISTER again."""
        ticket = None
        for _ in range(max_ticks):
            if ticket is None:
                lead = self.leader()
                if lead is not None:
                    idx = self.nodes[lead].propose_register()
                    if idx is not None:
                        ticket = (idx, _c.SESSION_REGISTER)
            if ticket is not None and self.is_committed(ticket):
                sid = ticket[0] % _c.SESSION_SID_MASK
                if self._session_owner.get(sid) == ticket[0]:
                    return sid
                ticket = None            # collision no-op: re-register
            elif (ticket is not None
                  and self._committed.get(ticket[0]) is not None):
                ticket = None            # lost ticket: index taken by
            self.tick()                  # another payload — re-propose
        return None

    def propose_seq(self, sid: int, seq: int, val: int):
        """Route an exactly-once session write to the current leader.
        Returns the (index, payload) ticket or None (retry — safely:
        duplicates fold once)."""
        lead = self.leader()
        if lead is None:
            return None
        idx = self.nodes[lead].propose_seq(sid, seq, val)
        if idx is None:
            return None
        return (idx, self.nodes[lead].payload_at(idx))

    def propose_reconfig(self, new_mask: int):
        """Route a single-server membership change to the current leader.
        Returns the (index, payload) ticket or None."""
        lead = self.leader()
        if lead is None:
            return None
        idx = self.nodes[lead].propose_config(new_mask)
        if idx is None:
            return None
        return (idx, self.nodes[lead].payload_at(idx))

    def read_begin(self):
        """Begin a linearizable read on the current leader. Returns
        (leader_id, rid) or None if no leader."""
        lead = self.leader()
        if lead is None:
            return None
        rid = self.nodes[lead].read_begin()
        if rid is None:
            return None
        return (lead, rid)

    def read_poll(self, handle):
        """Poll a read begun with `read_begin`: Node.READ_ABORTED,
        Node.READ_PENDING, or (read_index, served_index, digest)."""
        lead, rid = handle
        n = self.nodes[lead]
        if not self.alive_prev[lead]:
            return Node.READ_ABORTED
        return n.read_poll(rid)

    def read(self, max_ticks: int = 200):
        """Convenience: begin a read (retrying while leaderless) and tick
        until it completes. Returns (read_index, served_index, digest)
        or None if no read completed within `max_ticks`."""
        handle = None
        for _ in range(max_ticks):
            if handle is None:
                handle = self.read_begin()
            if handle is not None:
                r = self.read_poll(handle)
                if r == Node.READ_ABORTED:
                    handle = None
                elif r != Node.READ_PENDING:
                    return r
            self.tick()
        return None

    def expected_digest(self, through_index: int) -> int:
        """Replay the commit-identity map's hash chain through
        `through_index` — the value any node's digest must hold after
        applying exactly that prefix (read-your-writes checker). With
        cfg.sessions, the replay applies the same exactly-once filter
        as `Node._session_effective` (tests/test_sessions.py carries an
        independent re-implementation as the oracle-of-this-oracle)."""
        d = 0
        sessions: Dict[int, int] = {}
        for i in range(1, through_index + 1):
            p = self._committed[i]
            if (self.cfg.sessions and p & _c.SESSION_FLAG
                    and not p & _c.CONFIG_FLAG):
                sid = (p >> _c.SESSION_SID_SHIFT) & _c.SESSION_SID_MASK
                if sid == _c.SESSION_SID_MASK:
                    new_sid = i % _c.SESSION_SID_MASK
                    if new_sid in sessions:
                        continue
                    sessions[new_sid] = -1
                else:
                    seq = (p >> _c.SESSION_SEQ_SHIFT) & _c.SESSION_SEQ_MASK
                    if sid not in sessions or seq <= sessions[sid]:
                        continue
                    sessions[sid] = seq
            d = rng.digest_update(d, i, p)
        return d

    # ------------------------------------------------------------- observers

    def leader(self) -> Optional[int]:
        """Current unique alive leader of the highest term, if any."""
        best = None
        for i, n in enumerate(self.nodes):
            if n.role == LEADER and self.alive_prev[i]:
                if best is None or n.term > self.nodes[best].term:
                    best = i
        return best

    def snapshot(self) -> List[NodeView]:
        return [NodeView(term=n.term, role=n.role, voted_for=n.voted_for,
                         leader_id=n.leader_id, last_index=n.last_index,
                         commit=n.commit, applied=n.applied, digest=n.digest,
                         snap_index=n.snap_index, snap_term=n.snap_term,
                         snap_voters=n.snap_voters, reads_done=n.reads_done,
                         alive=self.alive_prev[i])
                for i, n in enumerate(self.nodes)]
