"""A single Raft replica — the CPU reference implementation.

Implements the tick contract of DESIGN.md §2 exactly: phase D (process
inbox in canonical order), phase T (timers/roles), phase C (client
appends), phase A (commit advance / apply / compact). The batched tick
(sim/step.py) and the fused-chunk kernel mirror every branch in here;
this is the JAX package's oracle, copied so the port can be held to it
without importing that package.

Log model (DESIGN.md §3): `self.log` holds entries for absolute indices
(snap_index, last_index], window-bounded by `log_cap`; the prefix up to
snap_index lives only as (snap_index, snap_term, snap_digest).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from raft_tpu_torch import config
from raft_tpu_torch.config import CONFIG_FLAG, RaftConfig
from raft_tpu_torch.core import rpc
from raft_tpu_torch.utils import rng

FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE = 0, 1, 2, 3
NO_VOTE = -1


def majority_of(voters: int) -> int:
    """Majority size of a voter bitmask."""
    return voters.bit_count() // 2 + 1


class Node:
    def __init__(self, cfg: RaftConfig, group: int, node_id: int, transport,
                 on_apply: Optional[Callable[[int, int, int, int], None]] = None):
        self.cfg = cfg
        self.g = group
        self.id = node_id
        self.transport = transport
        self.on_apply = on_apply  # (node_id, index, term, payload)

        # Durable state (survives crash/restart).
        self.term = 0
        self.voted_for = NO_VOTE
        self.log: List[tuple] = []   # [(term, payload)] for (snap_index, last_index]
        self.snap_index = 0
        self.snap_term = 0
        self.snap_digest = 0
        self.snap_voters = cfg.full_mask  # voter mask as of the snapshot prefix
        # Session table as of the snapshot prefix (cfg.sessions only):
        # sid -> last applied client seq. Durable with the snapshot.
        # Scheduled client traffic (cfg.client_rate > 0, DESIGN.md §10)
        # pre-registers slots 0..client_slots-1 with no applied
        # commands — bit-matching the batched path's session_seq init.
        self.snap_sessions: dict = (
            {s: -1 for s in range(cfg.client_slots)}
            if cfg.clients_u32 else {})
        self.rng_draws = 0           # monotone deadline-draw counter

        # Volatile state (reset on restart).
        self.role = FOLLOWER
        self.leader_id = NO_VOTE
        self.commit = 0
        self.applied = 0
        self.digest = 0
        # Live session table (exactly-once, dissertation §6.3): pure
        # state-machine state — rebuilt from snap_sessions + re-apply
        # on restart, exactly like `digest`.
        self.sessions: dict = dict(self.snap_sessions)
        self.votes = [False] * cfg.k
        self.next_index = [1] * cfg.k
        self.match_index = [0] * cfg.k
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.deadline = 0
        # Ticks since last authoritative leader contact (valid AE/IS) —
        # the PreVote lease clock (dissertation §9.6): pre-votes are
        # granted only when this reaches election_min. Distinct from
        # election_elapsed, which resets on vote grants and pre-ballots;
        # resetting the lease there too would let dueling pre-candidates
        # deny each other forever.
        self.leader_elapsed = 0
        # Client-facing state (volatile, leader-only): `now` is the
        # current tick (set by the harness before phases), `ack_time[p]`
        # the last tick a current-term AppendEntries response arrived
        # from peer p (any such response proves p's deference at the
        # time it was sent), `pending_reads` the ReadIndex protocol
        # state: rid -> (read_index, registration tick).
        self.now = 0
        self.ack_time = [-1] * cfg.k
        self.pending_reads: dict = {}
        self._next_read_id = 0
        # Scheduled-read state (DESIGN.md §2c): at most one in flight,
        # as (read_index, registration tick); `reads_done` counts
        # completions and is part of the differential trace surface.
        self.sched_read = None
        self.reads_done = 0
        # Storage-pressure override (r20, DESIGN.md §19): the bounded
        # model checker forces THIS node's disk full for the current
        # tick by setting these before the phases — an adversarial
        # over-approximation of the hashed nemesis schedule, same
        # soundness argument as mcheck's adversarial crashes. The
        # harness never sets them; production pressure comes from
        # cfg.nem_disk / cfg.nem_compact.
        self.disk_override = False
        self.compact_override = False
        self._reset_election_timer()

    # ------------------------------------------------------------- log helpers

    @property
    def last_index(self) -> int:
        return self.snap_index + len(self.log)

    def term_at(self, idx: int) -> int:
        if idx == self.snap_index:
            return self.snap_term
        assert self.snap_index < idx <= self.last_index, (idx, self.snap_index)
        return self.log[idx - self.snap_index - 1][0]

    def payload_at(self, idx: int) -> int:
        assert self.snap_index < idx <= self.last_index
        return self.log[idx - self.snap_index - 1][1]

    def last_log_term(self) -> int:
        return self.term_at(self.last_index)

    # ----------------------------------------------------- membership config

    def current_config(self):
        """(voters_mask, cfg_index): the latest membership-change entry in
        the log — committed or not, per the dissertation's §4.1 rule — or
        the snapshot's config if the window holds none. Derived, never
        stored: truncation of a config entry reverts the config with no
        bookkeeping."""
        for j in range(len(self.log) - 1, -1, -1):
            _, payload = self.log[j]
            if payload & CONFIG_FLAG:
                return payload & self.cfg.full_mask, self.snap_index + 1 + j
        return self.snap_voters, self.snap_index

    def committed_config(self) -> int:
        """Voter mask implied by the committed prefix (<= commit) — what
        compaction folds into `snap_voters`, and the authority for the
        'removed leader steps down' rule."""
        hi = min(self.commit, self.last_index) - self.snap_index
        for j in range(hi - 1, -1, -1):
            _, payload = self.log[j]
            if payload & CONFIG_FLAG:
                return payload & self.cfg.full_mask
        return self.snap_voters

    def is_voter(self, node_id: Optional[int] = None) -> bool:
        i = self.id if node_id is None else node_id
        voters, _ = self.current_config()
        return bool((voters >> i) & 1)

    def _window_has_room(self, n: int = 1) -> bool:
        return self.last_index + n - self.snap_index <= self.cfg.log_cap

    def _disk_full(self) -> bool:
        """Persistence budget exhausted at the current tick (r20,
        DESIGN.md §19): every local append fails — an entry that is
        not durable must never be acked, so the AE entry walk stops
        here and the follower's partial-prefix reply (match=hi) is the
        NACK that makes the leader retransmit. In-place term rewrites
        and snapshot installs are NOT appends and stay live."""
        if self.disk_override:
            return True
        nem_disk = self.cfg.nem_disk
        return bool(nem_disk and rng.nem_disk_full(
            self.cfg.seed, nem_disk, self.g, self.id, self.now,
            self.cfg.k))

    def _compact_blocked(self) -> bool:
        """Compaction pressure at the current tick (r20, DESIGN.md
        §19): phase A's snapshot step is delayed, the log_cap ring
        genuinely fills, and `_append`'s window check becomes the
        runtime backpressure path that throttles replication."""
        if self.compact_override:
            return True
        nem_compact = self.cfg.nem_compact
        return bool(nem_compact and rng.nem_compact_block(
            self.cfg.seed, nem_compact, self.g, self.id, self.now))

    def _append(self, term: int, payload: int) -> bool:
        if not self._window_has_room(1):
            return False
        if self._disk_full():
            return False
        self.log.append((term, payload))
        return True

    # ------------------------------------------------------------ transitions

    def _reset_election_timer(self):
        self.election_elapsed = 0
        deadline = rng.election_deadline(
            self.cfg.seed, self.g, self.id, self.rng_draws,
            self.cfg.election_min, self.cfg.election_range)
        nem_skew = self.cfg.nem_skew
        if nem_skew:
            # Nemesis clock-skew clauses (DESIGN.md §14): the draw made
            # at tick `now` is skewed while a span covers it, clamped
            # at 1 — the batched `_reset_timer` mirrors this exactly.
            deadline = max(1, deadline + rng.nem_deadline_extra(
                self.cfg.seed, nem_skew, self.g, self.id, self.now))
        self.deadline = deadline
        self.rng_draws += 1

    def _step_down(self, new_term: int):
        """Observed a higher term: adopt it, become follower. No timer reset."""
        self.term = new_term
        self.role = FOLLOWER
        self.voted_for = NO_VOTE
        self.leader_id = NO_VOTE
        self.votes = [False] * self.cfg.k
        self._drop_client_state()

    def _drop_client_state(self):
        """Leadership (or the term it was held under) is gone: pending
        reads abort, deference evidence is stale."""
        self.ack_time = [-1] * self.cfg.k
        self.pending_reads = {}
        self.sched_read = None

    def _become_leader(self):
        self.role = LEADER
        self.leader_id = self.id
        self.next_index = [self.last_index + 1] * self.cfg.k
        self.match_index = [0] * self.cfg.k
        self._drop_client_state()
        # Fire the initial heartbeat in phase T of this same tick.
        self.heartbeat_elapsed = self.cfg.heartbeat_every
        # Paxos-style takeover (DESIGN.md §2a): re-propose the TOP entry —
        # and only the top — under the new term, in place. Like the common
        # "append a no-op" idiom this creates a current-term entry whose
        # replication commits the whole inherited suffix (§5.4.2), but it
        # cannot grow the log, so takeover stays live when the bounded
        # window is full of uncommitted prior-term entries. Restricting the
        # rewrite to last_index is what keeps elections safe: current-term
        # entries then exist only at-or-above every committed index, so a
        # log whose last term is T' provably extends the T'-leader's log
        # and hence holds every committed entry (the round-1 variant that
        # re-termed the whole suffix created new-term entries BELOW the
        # committed frontier and broke Leader Completeness — see §2a).
        if self.last_index > self.commit:
            pos = self.last_index - self.snap_index - 1
            self.log[pos] = (self.term, self.log[pos][1])

    def _vote_quorum(self) -> bool:
        """Votes granted by members of the CURRENT config reach its
        majority (a vote from a non-voter — e.g. a peer the latest config
        entry removed — is received but never counted)."""
        voters, _ = self.current_config()
        granted = sum(1 for p in range(self.cfg.k)
                      if self.votes[p] and (voters >> p) & 1)
        return granted >= majority_of(voters)

    def _start_election(self):
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.id
        self.leader_id = NO_VOTE
        self.votes = [i == self.id for i in range(self.cfg.k)]
        self._reset_election_timer()
        if self._vote_quorum():   # single-voter config: instant leader
            self._become_leader()
            return
        for p in range(self.cfg.k):
            if p != self.id:
                self.transport.send(rpc.RequestVoteReq(
                    rpc.RV_REQ, self.id, p, term=self.term,
                    last_log_index=self.last_index,
                    last_log_term=self.last_log_term()))

    def _start_prevote(self):
        """Timeout with cfg.prevote: run a non-binding pre-ballot at
        term+1 instead of bumping the term (dissertation §9.6). Term and
        voted_for are untouched; a pre-vote quorum triggers the real
        election."""
        self.role = PRECANDIDATE
        self.leader_id = NO_VOTE
        self.votes = [i == self.id for i in range(self.cfg.k)]
        self._reset_election_timer()
        if self._vote_quorum():   # single-voter config: skip the pre-ballot
            self._start_election()
            return
        for p in range(self.cfg.k):
            if p != self.id:
                self.transport.send(rpc.PreVoteReq(
                    rpc.PV_REQ, self.id, p, term=self.term + 1,
                    last_log_index=self.last_index,
                    last_log_term=self.last_log_term()))

    def restart(self):
        """Dead→alive edge: durable state survives, volatile state resets."""
        self.role = FOLLOWER
        self.leader_id = NO_VOTE
        self.commit = self.snap_index
        self.applied = self.snap_index
        self.digest = self.snap_digest
        self.sessions = dict(self.snap_sessions)
        self.votes = [False] * self.cfg.k
        self.next_index = [1] * self.cfg.k
        self.match_index = [0] * self.cfg.k
        self.heartbeat_elapsed = 0
        self.leader_elapsed = 0   # fresh lease clock: deny pre-votes until
        #                           election_min ticks of observed silence
        self.reads_done = 0       # volatile counter
        self._drop_client_state()
        self._reset_election_timer()

    # ---------------------------------------------------------------- phase D

    def phase_d(self, inbox: List[rpc.Msg]):
        for m in rpc.sort_inbox(inbox):
            if m.type == rpc.RV_REQ:
                self._on_rv_req(m)
            elif m.type == rpc.RV_RESP:
                self._on_rv_resp(m)
            elif m.type == rpc.AE_REQ:
                self._on_ae_req(m)
            elif m.type == rpc.AE_RESP:
                self._on_ae_resp(m)
            elif m.type == rpc.IS_REQ:
                self._on_is_req(m)
            elif m.type == rpc.IS_RESP:
                self._on_is_resp(m)
            elif m.type == rpc.PV_REQ:
                self._on_pv_req(m)
            elif m.type == rpc.PV_RESP:
                self._on_pv_resp(m)
            elif m.type == rpc.TN_REQ:
                self._on_tn_req(m)

    def _on_rv_req(self, m: rpc.RequestVoteReq):
        if m.term > self.term:
            self._step_down(m.term)
        log_ok = (m.last_log_term > self.last_log_term()
                  or (m.last_log_term == self.last_log_term()
                      and m.last_log_index >= self.last_index))
        grant = (m.term == self.term
                 and self.voted_for in (NO_VOTE, m.src)
                 and log_ok)
        if grant:
            self.voted_for = m.src
            self._reset_election_timer()
        self.transport.send(rpc.RequestVoteResp(
            rpc.RV_RESP, self.id, m.src, term=self.term, granted=grant))

    def _on_rv_resp(self, m: rpc.RequestVoteResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if self.role != CANDIDATE or m.term != self.term or not m.granted:
            return
        self.votes[m.src] = True
        if self._vote_quorum():
            self._become_leader()

    def _accept_leader(self, m):
        """Common prelude of AE/IS from the current-term leader."""
        self.role = FOLLOWER
        self.leader_id = m.src
        self.votes = [False] * self.cfg.k
        self.leader_elapsed = 0   # authoritative leader contact: lease renews
        self._reset_election_timer()

    def _on_ae_req(self, m: rpc.AppendEntriesReq):
        if m.term > self.term:
            self._step_down(m.term)
        if m.term < self.term:
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=0))
            return
        self._accept_leader(m)

        prev = m.prev_index
        if prev > self.last_index:
            # Past our end: tell the leader where our log actually ends.
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        if prev >= self.snap_index and self.term_at(prev) != m.prev_term:
            # Conflict fast-backup: first index of the conflicting term.
            ct = self.term_at(prev)
            ci = prev
            while ci - 1 > self.snap_index and self.term_at(ci - 1) == ct:
                ci -= 1
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=ci))
            return

        # Entries with index <= snap_index are committed here, hence match by
        # the Log Matching property — skip them.
        j0 = max(0, self.snap_index - prev)
        hi = prev + j0
        for j in range(j0, len(m.entries)):
            idx = prev + 1 + j
            et, ep = m.entries[j]
            if idx <= self.last_index:
                if self.term_at(idx) == et:
                    hi = idx
                    continue
                if self.payload_at(idx) == ep:
                    # Same entry re-proposed under a newer term (leader
                    # takeover, DESIGN.md §2a): overwrite the term in place
                    # and keep the tail. Needs no window room — this is what
                    # keeps takeover live when the window is full.
                    self.log[idx - self.snap_index - 1] = (et, ep)
                    hi = idx
                    continue
                # Divergent suffix: truncate it (never reaches committed
                # entries: a committed entry's payload is what the leader
                # itself holds at that index, so a differing payload proves
                # the entry was never committed).
                assert idx > self.commit, "refusing to truncate committed entries"
                del self.log[idx - self.snap_index - 1:]
            if not self._append(et, ep):
                break  # window full — flow control; leader will resend
            hi = idx
        if m.leader_commit > self.commit:
            # Only up to `hi`: beyond it our suffix is not known to match.
            self.commit = max(self.commit, min(m.leader_commit, hi))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True, match=hi))

    def _on_ae_resp(self, m: rpc.AppendEntriesResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if self.role != LEADER or m.term != self.term:
            return
        # Any current-term response (success or not) proves the sender
        # deferred to this leader when it replied — ReadIndex evidence.
        self.ack_time[m.src] = self.now
        if m.success:
            self.match_index[m.src] = max(self.match_index[m.src], m.match)
            self.next_index[m.src] = self.match_index[m.src] + 1
        else:
            self.next_index[m.src] = max(1, min(self.next_index[m.src] - 1, m.match))

    def _on_is_req(self, m: rpc.InstallSnapshotReq):
        if m.term > self.term:
            self._step_down(m.term)
        if m.term < self.term:
            self.transport.send(rpc.InstallSnapshotResp(
                rpc.IS_RESP, self.id, m.src, term=self.term, match=0))
            return
        self._accept_leader(m)
        if m.snap_index <= self.commit:
            # Already have everything the snapshot covers.
            self.transport.send(rpc.InstallSnapshotResp(
                rpc.IS_RESP, self.id, m.src, term=self.term, match=self.commit))
            return
        if (m.snap_index <= self.last_index
                and self.term_at(max(m.snap_index, self.snap_index)) == m.snap_term
                and m.snap_index >= self.snap_index):
            # Snapshot point exists in our log with the same term: keep the
            # suffix after it (Raft §7), drop the prefix.
            self.log = self.log[m.snap_index - self.snap_index:]
        else:
            self.log = []
        self.snap_index = m.snap_index
        self.snap_term = m.snap_term
        self.snap_digest = m.snap_digest
        self.snap_voters = m.snap_voters
        self.snap_sessions = dict(m.snap_sessions or ())
        self.commit = m.snap_index
        self.applied = m.snap_index
        self.digest = m.snap_digest
        self.sessions = dict(self.snap_sessions)
        self.transport.send(rpc.InstallSnapshotResp(
            rpc.IS_RESP, self.id, m.src, term=self.term, match=m.snap_index))

    def _on_is_resp(self, m: rpc.InstallSnapshotResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if self.role != LEADER or m.term != self.term:
            return
        self.ack_time[m.src] = self.now
        self.match_index[m.src] = max(self.match_index[m.src], m.match)
        self.next_index[m.src] = self.match_index[m.src] + 1

    def _on_pv_req(self, m: rpc.PreVoteReq):
        """Pre-vote grant rule (dissertation §9.6): the proposed term is
        ahead of ours, the candidate's log is up-to-date, we are not the
        leader, and we have not heard from one within election_min ticks
        (the lease check — what stops a healthy regime's followers from
        helping a rejoined partitioned node depose the leader). A
        pre-vote is non-binding: no term adoption, no voted_for record,
        no timer reset — any number may be granted per term."""
        log_ok = (m.last_log_term > self.last_log_term()
                  or (m.last_log_term == self.last_log_term()
                      and m.last_log_index >= self.last_index))
        grant = (m.term > self.term
                 and log_ok
                 and self.role != LEADER
                 and self.leader_elapsed >= self.cfg.election_min)
        self.transport.send(rpc.PreVoteResp(
            rpc.PV_RESP, self.id, m.src, term=self.term,
            req_term=m.term, granted=grant))

    def _on_pv_resp(self, m: rpc.PreVoteResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if (self.role != PRECANDIDATE or m.req_term != self.term + 1
                or not m.granted):
            return
        self.votes[m.src] = True
        if self._vote_quorum():
            self._start_election()   # quorum would vote for us: go real

    def _on_tn_req(self, m: rpc.TimeoutNow):
        """Leadership transfer (dissertation §3.10): campaign NOW —
        deliberately bypassing PreVote (the sender is the current
        leader handing off; a pre-ballot would be refused under the
        lease check everyone still holds for that leader).

        Honored only as FOLLOWER or PRECANDIDATE: a CANDIDATE already
        started an election — possibly THIS tick (a pre-ballot quorum in
        phase D, processed before TN in the canonical order) — and a
        second `_start_election` would emit two RequestVotes per
        destination in one tick, violating the one-message-per-
        (type, src, dst) contract the dense batched mailbox relies on."""
        if m.term > self.term:
            self._step_down(m.term)
        if (m.term < self.term or self.role in (LEADER, CANDIDATE)
                or not self.is_voter()):
            return
        self._start_election()

    # ------------------------------------------------------------- client API

    def _session_effective(self, index: int, payload: int) -> bool:
        """Exactly-once filter (dissertation §6.3), applied at digest-fold
        time so every node makes the identical decision from the same
        committed prefix. Returns False iff the entry is a session
        command whose effect must be skipped: a duplicate (sid, seq)
        retry, a command on an unregistered session, or a REGISTER whose
        index-derived sid is already taken. With cfg.sessions off (every
        scheduled universe), every entry is effective — bit-identical to
        the pre-session digest stream."""
        if not self.cfg.sessions:
            return True
        if payload & config.CONFIG_FLAG or not payload & config.SESSION_FLAG:
            return True
        sid = (payload >> config.SESSION_SID_SHIFT) & config.SESSION_SID_MASK
        if sid == config.SESSION_SID_MASK:          # REGISTER
            new_sid = index % config.SESSION_SID_MASK
            if new_sid in self.sessions:
                return False
            self.sessions[new_sid] = -1
            return True
        seq = (payload >> config.SESSION_SEQ_SHIFT) & config.SESSION_SEQ_MASK
        if sid not in self.sessions or seq <= self.sessions[sid]:
            return False
        self.sessions[sid] = seq
        return True

    def propose(self, payload: int):
        """Client write: append `payload` under the current term.

        Returns the assigned absolute index, or None if this node is not
        the leader or the log window is full (flow control — retry after
        compaction frees space). The entry is durably committed once some
        node applies (index, payload); the ticket for that check is the
        (index, payload) pair — terms are ballot numbers and may be
        rewritten in place by a takeover re-proposal (DESIGN.md §2a).
        """
        if self.role != LEADER:
            return None
        if self.cfg.sessions:
            # Bits 29-30 are protocol-reserved when sessions are on: a
            # raw payload carrying them would be (mis)read by the state
            # machine as a session/config command. Session commands go
            # through `propose_seq`.
            if payload & (CONFIG_FLAG | config.SESSION_FLAG):
                raise ValueError("payload uses reserved session/config bits; "
                                 "use propose_seq/propose_config")
        if not self._append(self.term, payload):
            return None
        return self.last_index

    def propose_register(self):
        """Propose a session REGISTER entry (cfg.sessions). On apply,
        the state machine allocates sid = index % SESSION_SID_MASK (a
        taken sid makes the registration a deterministic no-op — the
        client retries). Returns the index or None."""
        if self.role != LEADER or not self.cfg.sessions:
            return None
        if not self._append(self.term, config.SESSION_REGISTER):
            return None
        return self.last_index

    def propose_seq(self, sid: int, seq: int, val: int):
        """Client write with exactly-once semantics (cfg.sessions): the
        state machine applies (sid, seq) at most once, so a client that
        RETRIES after an ambiguous failure (leader deposed with the
        ticket unresolved) cannot double-apply. Returns the index or
        None (not leader / window full). `sid` comes from a committed
        REGISTER entry (Cluster.open_session)."""
        if self.role != LEADER or not self.cfg.sessions:
            return None
        if not self._append(self.term, config.session_payload(sid, seq, val)):
            return None
        return self.last_index

    def admit_and_propose(self, sid: int, seq: int, val: int, shed: bool):
        """Admission seam of the bounded client queue (r20, DESIGN.md
        §19). A shed arrival gets a DEFINITIVE reject: the op never
        enters the log, its seq is never consumed, and the client must
        not retry it — so an admission layer that says "rejected" yet
        still proposes is a safety bug, not a liveness one. The mutant
        harness overrides exactly this method (shed_then_apply); the
        applied-seq frontier then outruns the issued frontier and
        invariants.client_safety kills it."""
        if shed:
            return None
        return self.propose_seq(sid, seq, val)

    def read_begin(self):
        """Begin a linearizable ReadIndex read (Raft dissertation §6.4).

        Records the current commit index and the registration tick;
        returns a read id, or None if not leader. The read completes
        once (a) a majority of peers have sent this leader a current-term
        response at a tick >= registration + 2 — in the lockstep tick
        model a response received at tick t was emitted at t-1 reacting
        to authority this leader held at t-2, so t >= reg + 2 proves the
        peer still deferred to this leader strictly after the read was
        registered (no newer leader could have been elected before reg
        without this majority having refused us) — and (b) the state
        machine has applied through the recorded read index.

        A freshly elected leader must not serve reads yet: its commit
        index can lag entries committed by prior leaders (dissertation
        §6.4 step 1). Serving is safe once (a) the entry at `commit`
        carries the current term — the takeover re-proposal (DESIGN.md
        §2a) guarantees a current-term entry at the takeover
        `last_index`, which is >= every previously committed index, so
        committing it pulls `commit` past all prior commits — or (b)
        `commit == last_index`, in which case Leader Completeness bounds
        every committed entry by `last_index` directly. Until then:
        return None, client retries.
        """
        if self.role != LEADER:
            return None
        if not (self.commit == self.last_index
                or self.term_at(self.commit) == self.term):
            return None
        rid = self._next_read_id
        self._next_read_id += 1
        self.pending_reads[rid] = (self.commit, self.now)
        return rid

    READ_PENDING = "pending"
    READ_ABORTED = "aborted"

    def _read_quorum_met(self, reg_tick: int) -> bool:
        """ReadIndex leadership confirmation: acks from CURRENT-config
        voters at ticks >= reg + 2 reach the voter majority (the leader
        counts itself iff it is a voter). Acks from non-voter learners
        prove nothing — they are in no election quorum (round-4 VERDICT
        confirmed violation). Shared by the interactive `read_poll` and
        the scheduled-read completion in `phase_a`."""
        voters, _ = self.current_config()
        acks = sum(1 for p in range(self.cfg.k)
                   if p != self.id and (voters >> p) & 1
                   and self.ack_time[p] >= reg_tick + 2)
        return acks + ((voters >> self.id) & 1) >= majority_of(voters)

    def read_poll(self, rid: int):
        """Poll a pending read: READ_ABORTED (leadership lost — retry on
        the new leader), READ_PENDING, or (read_index, served_index,
        digest) once the quorum round-trip confirmed leadership and the
        state machine caught up. The digest is the machine state after
        applying exactly `served_index` entries (served_index >=
        read_index), which includes every write committed before the
        read began — serving a later applied state is still
        linearizable because that state is current at completion."""
        if rid not in self.pending_reads:
            return self.READ_ABORTED
        read_index, reg_tick = self.pending_reads[rid]
        if not self._read_quorum_met(reg_tick):
            return self.READ_PENDING
        if self.applied < read_index:
            return self.READ_PENDING
        del self.pending_reads[rid]
        return (read_index, self.applied, self.digest)

    # ---------------------------------------------------------------- phase T

    def phase_t(self):
        if self.role == LEADER:
            self.leader_elapsed = 0   # a leader is its own lease authority
            self.heartbeat_elapsed += 1
            if self.heartbeat_elapsed >= self.cfg.heartbeat_every:
                self.heartbeat_elapsed = 0
                self._broadcast_append()
            self._maybe_transfer()
        else:
            self.leader_elapsed += 1
            self.election_elapsed += 1
            # Non-voters (servers the latest config removed) never start
            # elections — they keep replicating as learners and keep
            # granting votes, but cannot disrupt the voters' regime.
            if self.election_elapsed >= self.deadline and self.is_voter():
                if self.cfg.prevote:
                    self._start_prevote()
                else:
                    self._start_election()

    def _send_timeout_now(self, target: int):
        """Transfer gate: the target must be a CURRENT-config voter, not
        self, hold every committed entry, and be the most-caught-up
        peer (the dissertation's §3.10 "catch the target up first"
        precondition, adapted to continuous appends — strict equality
        with last_index can never hold while in-flight entries lead the
        acks, so the gate asks for the best log a follower can have)."""
        if target == self.id or not self.is_voter(target):
            return None
        mt = self.match_index[target]
        if mt < self.commit or mt != max(self.match_index):
            return None
        self.transport.send(rpc.TimeoutNow(
            rpc.TN_REQ, self.id, target, term=self.term))
        return True

    def transfer_leadership(self, target: int):
        """Client API: hand leadership to `target` (dissertation §3.10).
        Returns True if TimeoutNow was sent, None if not leader or the
        gate refused (non-voter, self, or not caught up)."""
        if self.role != LEADER:
            return None
        return self._send_timeout_now(target)

    def _maybe_transfer(self):
        """The deterministic transfer schedule (DESIGN.md §2d): at the
        first tick of each transfer epoch, w.p. transfer_prob, hand
        leadership to a hash-chosen peer — if the gate clears."""
        cfg = self.cfg
        if cfg.transfer_u32 == 0 or self.now % cfg.transfer_epoch != 0:
            return
        epoch = self.now // cfg.transfer_epoch
        if not rng.transfer_fires(cfg.seed, self.g, epoch, cfg.transfer_u32):
            return
        self._send_timeout_now(
            rng.transfer_target(cfg.seed, self.g, epoch, cfg.k))

    def _broadcast_append(self):
        for p in range(self.cfg.k):
            if p == self.id:
                continue
            if self.next_index[p] <= self.snap_index:
                self.transport.send(rpc.InstallSnapshotReq(
                    rpc.IS_REQ, self.id, p, term=self.term,
                    snap_index=self.snap_index, snap_term=self.snap_term,
                    snap_digest=self.snap_digest,
                    snap_voters=self.snap_voters,
                    snap_sessions=(tuple(sorted(self.snap_sessions.items()))
                                   if self.cfg.sessions else None)))
            else:
                prev = self.next_index[p] - 1
                n = min(self.cfg.max_entries_per_msg, self.last_index - prev)
                lo = prev - self.snap_index
                entries = tuple(self.log[lo:lo + n])
                self.transport.send(rpc.AppendEntriesReq(
                    rpc.AE_REQ, self.id, p, term=self.term,
                    prev_index=prev, prev_term=self.term_at(prev),
                    entries=entries, leader_commit=self.commit))

    # ---------------------------------------------------------------- phase C

    def _reconfig_gate(self, new_mask: int):
        """Single-server change preconditions (dissertation §4.1 + the
        2015 single-server bugfix): the previous config entry must be
        committed, and this leader must have committed an entry of its
        own term. Returns the (voters, cfg_index) pair if clear."""
        voters, cfg_index = self.current_config()
        if cfg_index > self.commit:
            return None
        if self.term_at(self.commit) != self.term:
            return None
        if (new_mask ^ voters).bit_count() != 1:
            return None   # not a single-server delta
        if new_mask.bit_count() == 0:
            return None   # an empty voter set can never commit or elect
        return voters, cfg_index

    def _maybe_propose_reconfig(self):
        """The deterministic membership-change schedule (DESIGN.md §2b):
        at the first tick of each reconfig epoch, w.p. reconfig_prob,
        toggle one hash-chosen node — if the gate clears and the result
        keeps at least min_voters voters."""
        cfg = self.cfg
        if cfg.reconfig_u32 == 0 or self.now % cfg.reconfig_epoch != 0:
            return
        epoch = self.now // cfg.reconfig_epoch
        if not rng.reconfig_fires(cfg.seed, self.g, epoch, cfg.reconfig_u32):
            return
        target = rng.reconfig_target(cfg.seed, self.g, epoch, cfg.k)
        voters, _ = self.current_config()
        new_mask = voters ^ (1 << target)
        if new_mask.bit_count() < cfg.effective_min_voters:
            return
        if self._reconfig_gate(new_mask) is None:
            return
        self._append(self.term, CONFIG_FLAG | new_mask)

    def propose_config(self, new_mask: int):
        """Client API: propose a single-server membership change. Returns
        the assigned index or None (not leader / gate closed / window
        full). `new_mask` must differ from the current config by exactly
        one member."""
        if self.role != LEADER:
            return None
        if self._reconfig_gate(new_mask) is None:
            return None
        if not self._append(self.term, CONFIG_FLAG | new_mask):
            return None
        return self.last_index

    def _maybe_schedule_read(self):
        """DESIGN.md §2c: at the first tick of each read epoch a leader
        with no read in flight registers a ReadIndex read at the START
        of phase C (so the read point is the pre-append commit index),
        subject to `read_begin`'s serving gate."""
        cfg = self.cfg
        if cfg.read_every == 0 or self.now % cfg.read_every != 0:
            return
        if self.sched_read is not None:
            return
        if not (self.commit == self.last_index
                or self.term_at(self.commit) == self.term):
            return
        self.sched_read = (self.commit, self.now)

    def phase_c(self, client_cmds=None):
        """`client_cmds`: the scheduled open-loop clients' pulsed
        session payloads for this tick (DESIGN.md §10), in slot order —
        every node that believes itself leader appends them (duplicate
        appends by transient dual leaders are exactly what the
        exactly-once fold dedups), stopping at window-full like the
        batched path's stopped latch."""
        if self.role != LEADER:
            return
        self._maybe_schedule_read()
        self._maybe_propose_reconfig()
        if client_cmds:
            for payload in client_cmds:
                if not self._append(self.term, payload):
                    break
        for _ in range(self.cfg.cmds_per_tick):
            payload = rng.client_payload(
                self.cfg.seed, self.g, self.term, self.last_index + 1)
            if not self._append(self.term, payload):
                break

    # ---------------------------------------------------------------- phase A

    def phase_a(self):
        if self.role == LEADER:
            voters, _ = self.current_config()
            # Replication tally over CURRENT voters only; the leader
            # counts itself (at last_index) iff it is still a voter.
            vals = sorted(
                (self.last_index if p == self.id else self.match_index[p]
                 for p in range(self.cfg.k) if (voters >> p) & 1),
                reverse=True)
            if vals:
                n = vals[majority_of(voters) - 1]
                # §5.4.2: only entries of the current term commit by counting.
                if n > self.commit and self.term_at(n) == self.term:
                    self.commit = n
            # A removed leader steps down once its removal is committed
            # (latest config entry committed and it is not in it).
            voters, cfg_index = self.current_config()
            if cfg_index <= self.commit and not (voters >> self.id) & 1:
                self.role = FOLLOWER
                self.leader_id = NO_VOTE
                self.votes = [False] * self.cfg.k
                self._drop_client_state()
        while self.applied < self.commit:
            self.applied += 1
            t, p = self.log[self.applied - self.snap_index - 1]
            if self._session_effective(self.applied, p):
                self.digest = rng.digest_update(self.digest, self.applied, p)
            if self.on_apply is not None:
                self.on_apply(self.id, self.applied, t, p)
        if (self.commit - self.snap_index >= self.cfg.compact_every
                and not self._compact_blocked()):
            self.snap_voters = self.committed_config()
            self.snap_sessions = dict(self.sessions)
            self.snap_term = self.term_at(self.commit)
            self.log = self.log[self.commit - self.snap_index:]
            self.snap_index = self.commit
            self.snap_digest = self.digest
        # Scheduled-read completion (DESIGN.md §2c), end of phase A: the
        # same voters-aware quorum as `read_poll` — a step-down or
        # demotion earlier this tick already cleared `sched_read`.
        if self.sched_read is not None:
            read_index, reg = self.sched_read
            if self._read_quorum_met(reg) and self.applied >= read_index:
                self.reads_done += 1
                self.sched_read = None
