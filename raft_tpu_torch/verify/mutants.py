"""Seeded semantic mutants of the port's oracle step: the JAX package's
`verify/mutants.py` catalog, with the same names, mirrors,
expectations, bounds and waypoint prefixes, each a subclass of the
port's `core.node.Node`.

Each mutant is a `Node` subclass overriding ONE handler with a
copied-but-bugged body — a change a refactor could plausibly introduce,
at protocol level (not a typo a linter would catch). The bounded model
checker must KILL every one: find a schedule within its `bounds`
where a shared predicate (or a history ghost) goes false, and emit it
as a replayable artifact. `tests/test_torch_verify.py` runs the full
kill matrix against the JAX package's checker; `mcheck.smoke` uses
`minority_quorum` as its canary.

Every mutant names its `mirror` — the sim/step.py site computing the
same clause for the batched engines — because the differential tests
pin step.py and the fused-chunk kernel to THIS oracle: a bug class
killed here is a bug class the differential would catch if introduced
there instead.

Killing bounds are per-mutant (smallest universe that exposes the
bug): most die at k=2 within a few ticks; quorum-arithmetic bugs that
need a 2-of-3 split die at k=3; the dedup mutant needs the sessions
universe. `expect` names the predicate expected in the counterexample
(checked loosely — any violation kills, the name documents WHY the
mutant is unsafe).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from raft_tpu_torch import config
from raft_tpu_torch.core import rpc
from raft_tpu_torch.utils import rng
from raft_tpu_torch.core.node import (CANDIDATE, LEADER, NO_VOTE, Node,
                                      majority_of)
from raft_tpu_torch.verify.mcheck import Bounds


@dataclasses.dataclass(frozen=True)
class Mutant:
    name: str
    node_cls: type
    mirror: str          # the sim/step.py site computing the same clause
    expect: str          # predicate the counterexample should trip
    bounds: Bounds       # smallest universe known to kill it
    doc: str
    # Waypoint drive (mcheck.check's `prefix`): fixed scheduler choices
    # reaching the deep protocol region where the bug is expressible;
    # the BFS fans out exhaustively from there. () = blind search.
    prefix: tuple = ()


def _sched(k: int, *ticks: str) -> tuple:
    """Compact scheduler-trace literal for catalog prefixes. One string
    per tick, space-separated tokens: `xN` node N down, `pN` pulse N's
    election timer, `bSD` block link S->D, `dN` node N disk-full,
    `nN`/`uN`/`sN` propose new/dup/shed on N (sessions universes; shed
    needs Bounds.admission). '' is the quiet tick. These are the shrunk
    counterexample schedules the hunts/hand analysis found, frozen so
    the kill matrix replays them in milliseconds."""
    out = []
    for spec in ticks:
        c = {"alive": [True] * k, "blocked": (), "pulse": (),
             "disk": (), "propose": None}
        for tok in spec.split():
            if tok[0] == "x":
                c["alive"][int(tok[1])] = False
            elif tok[0] == "p":
                c["pulse"] += (int(tok[1]),)
            elif tok[0] == "b":
                c["blocked"] += ((int(tok[1]), int(tok[2])),)
            elif tok[0] == "d":
                c["disk"] += (int(tok[1]),)
            elif tok[0] == "n":
                c["propose"] = (int(tok[1]), "new")
            elif tok[0] == "u":
                c["propose"] = (int(tok[1]), "dup")
            elif tok[0] == "s":
                c["propose"] = (int(tok[1]), "shed")
            else:
                raise ValueError(f"bad sched token {tok!r}")
        c["alive"] = tuple(c["alive"])
        out.append(c)
    return tuple(out)


# -------------------------------------------------- vote-path mutants


class AcceptStaleAppend(Node):
    """_on_ae_req drops the m.term < self.term stale-leader reject: a
    deposed leader's AppendEntries still installs entries and advances
    commit on followers that have moved to a newer term — two leaders
    replicate concurrently into the same logs. (The RV-side analog —
    granting a stale-term vote — is NOT observable in this universe:
    in-flight mail lives exactly one tick, so a stale RequestVote can
    only arrive via same-inbox term-raise reordering, and every such
    path is blocked by the voted_for dedup; the AE-side slip is the
    stale-term-check bug a bounded schedule can actually reach.)"""
    def _on_ae_req(self, m: rpc.AppendEntriesReq):
        if m.term > self.term:
            self._step_down(m.term)
        # BUG: `if m.term < self.term: reject` dropped.
        self._accept_leader(m)
        prev = m.prev_index
        if prev > self.last_index:
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        if prev >= self.snap_index and self.term_at(prev) != m.prev_term:
            ct = self.term_at(prev)
            ci = prev
            while ci - 1 > self.snap_index and self.term_at(ci - 1) == ct:
                ci -= 1
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=ci))
            return
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
                    self.log[idx - self.snap_index - 1] = (et, ep)
                    hi = idx
                    continue
                if idx <= self.commit:
                    break   # surface as divergence, not a harness crash
                del self.log[idx - self.snap_index - 1:]
            if not self._append(et, ep):
                break
            hi = idx
        if m.leader_commit > self.commit:
            self.commit = max(self.commit, min(m.leader_commit, hi))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True,
            match=hi))


class SkipVoteDedup(Node):
    """_on_rv_req skips the voted_for dedup: one follower grants two
    candidates in the same term — double vote."""
    def _on_rv_req(self, m: rpc.RequestVoteReq):
        if m.term > self.term:
            self._step_down(m.term)
        log_ok = (m.last_log_term > self.last_log_term()
                  or (m.last_log_term == self.last_log_term()
                      and m.last_log_index >= self.last_index))
        grant = m.term == self.term and log_ok   # BUG: no voted_for check
        if grant:
            self.voted_for = m.src
            self._reset_election_timer()
        self.transport.send(rpc.RequestVoteResp(
            rpc.RV_RESP, self.id, m.src, term=self.term, granted=grant))


class IndexOnlyLogOk(Node):
    """_on_rv_req compares log recency by index alone, ignoring the
    last log TERM: a long stale-term log outranks a short current-term
    one, electing a leader missing committed entries."""
    def _on_rv_req(self, m: rpc.RequestVoteReq):
        if m.term > self.term:
            self._step_down(m.term)
        log_ok = m.last_log_index >= self.last_index   # BUG: term ignored
        grant = (m.term == self.term
                 and self.voted_for in (NO_VOTE, m.src)
                 and log_ok)
        if grant:
            self.voted_for = m.src
            self._reset_election_timer()
        self.transport.send(rpc.RequestVoteResp(
            rpc.RV_RESP, self.id, m.src, term=self.term, granted=grant))


class CountStaleVoteResp(Node):
    """_on_rv_resp drops the m.term == self.term guard: grants from a
    previous failed candidacy count toward the current one."""
    def _on_rv_resp(self, m: rpc.RequestVoteResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if self.role != CANDIDATE or not m.granted:   # BUG: no term check
            return
        self.votes[m.src] = True
        if self._vote_quorum():
            self._become_leader()


class MinorityQuorum(Node):
    """_vote_quorum off-by-one (bit_count // 2, no +1): k // 2 votes
    win an election — two disjoint 'majorities' can coexist."""
    def _vote_quorum(self) -> bool:
        voters, _ = self.current_config()
        granted = sum(1 for p in range(self.cfg.k)
                      if self.votes[p] and (voters >> p) & 1)
        return granted >= majority_of(voters) - 1   # BUG: minority wins


class VolatileTerm(Node):
    """restart() resets the durable term to 0: a crash-recovered voter
    re-campaigns AT a term it already voted in (the fresh election
    bumps its zeroed term back to an old value with voted_for = self),
    so a second leader wins a term that already has one. (The sibling
    slip — dropping only voted_for — is NOT observable in this
    universe: in-flight mail lives exactly one tick, so no same-term
    vote request can arrive after a crash-revive; a fresh candidacy
    always bumps the term. Dropping the term is the restart-durability
    bug a bounded schedule can actually reach.)"""
    def restart(self):
        super().restart()
        self.term = 0   # BUG: durable term reset


# --------------------------------------------------- commit-path mutants


class CommitOffByOne(Node):
    """phase_a reads the replication tally one rank too low
    (majority_of - 2): an index replicated on a minority commits."""
    def phase_a(self):
        if self.role == LEADER:
            voters, _ = self.current_config()
            vals = sorted(
                (self.last_index if p == self.id else self.match_index[p]
                 for p in range(self.cfg.k) if (voters >> p) & 1),
                reverse=True)
            if vals:
                n = vals[max(0, majority_of(voters) - 2)]   # BUG: rank - 1
                if n > self.commit and self.term_at(n) == self.term:
                    self.commit = n
        self._phase_a_tail()

    def _phase_a_tail(self):
        """phase_a after the commit tally, verbatim (reads/reconfig are
        statically off in every mcheck universe, so the removed-leader
        step-down and sched_read completion are dead code here)."""
        while self.applied < self.commit:
            self.applied += 1
            t, p = self.log[self.applied - self.snap_index - 1]
            if self._session_effective(self.applied, p):
                self.digest = rng.digest_update(self.digest, self.applied, p)
            if self.on_apply is not None:
                self.on_apply(self.id, self.applied, t, p)
        if self.commit - self.snap_index >= self.cfg.compact_every:
            self.snap_voters = self.committed_config()
            self.snap_sessions = dict(self.sessions)
            self.snap_term = self.term_at(self.commit)
            self.log = self.log[self.commit - self.snap_index:]
            self.snap_index = self.commit
            self.snap_digest = self.digest


class CommitStaleTerm(CommitOffByOne):
    """phase_a drops the §5.4.2 current-term guard: a prior-term entry
    commits by counting — the Figure 8 scenario."""
    def phase_a(self):
        if self.role == LEADER:
            voters, _ = self.current_config()
            vals = sorted(
                (self.last_index if p == self.id else self.match_index[p]
                 for p in range(self.cfg.k) if (voters >> p) & 1),
                reverse=True)
            if vals:
                n = vals[majority_of(voters) - 1]
                if n > self.commit:   # BUG: term_at(n) == self.term dropped
                    self.commit = n
        self._phase_a_tail()


class AckBeyondSent(Node):
    """_on_ae_resp credits a success ack one entry past what the
    follower actually matched — the classic fencepost between
    match_index (last replicated) and next_index (first to send): the
    commit tally counts an entry the follower does not hold, so the
    leader commits under-replicated entries. (The textbook neighbor —
    counting acks from a STALE term — is not observable in this
    universe: mail lives exactly one tick, a leader's term cannot
    change while it stays leader within that tick, and any AE_RESP is
    a reply to this leader's own current-term AE, so m.term <
    self.term can never reach a standing leader; the fencepost is the
    tally bug a bounded schedule can actually reach.)"""
    def _on_ae_resp(self, m: rpc.AppendEntriesResp):
        if m.term > self.term:
            self._step_down(m.term)
            return
        if self.role != LEADER or m.term != self.term:
            return
        self.ack_time[m.src] = self.now
        if m.success:
            # BUG: m.match + 1 — one past the acked prefix.
            self.match_index[m.src] = max(self.match_index[m.src],
                                          m.match + 1)
            self.next_index[m.src] = self.match_index[m.src] + 1
        else:
            self.next_index[m.src] = max(
                1, min(self.next_index[m.src] - 1, m.match))


class AckWithoutPersist(Node):
    """_on_ae_req acks entries its storage rejected: when `_append`
    fails — window full OR the disk-full budget
    exhausted — the reply still advances `match` over the entry, so
    the leader's commit tally counts a copy that does not exist. The
    real oracle's NACK rule stops `hi` at the durable prefix (the
    partial ack IS the NACK); this mutant is the classic
    fsync-skipped durability bug, and `commit_durability` kills it:
    the leader commits an index held by fewer than a majority."""
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
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        if prev >= self.snap_index and self.term_at(prev) != m.prev_term:
            ct = self.term_at(prev)
            ci = prev
            while ci - 1 > self.snap_index and self.term_at(ci - 1) == ct:
                ci -= 1
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=ci))
            return
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
                    self.log[idx - self.snap_index - 1] = (et, ep)
                    hi = idx
                    continue
                if idx <= self.commit:
                    break   # surface as divergence, not a harness crash
                del self.log[idx - self.snap_index - 1:]
            if not self._append(et, ep):
                hi = idx   # BUG: acked without persisting
                break
            hi = idx
        if m.leader_commit > self.commit:
            # Clamped to last_index so the window stays structurally
            # traversable; the durability bug is in the inflated ack.
            self.commit = max(self.commit,
                              min(m.leader_commit, hi, self.last_index))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True,
            match=hi))


class CommitPastDurable(CommitOffByOne):
    """phase_a tallies the optimistic SEND pointer (next_index)
    instead of the durable-acked pointer (match_index): entries the
    leader has merely queued for a peer count as replicated, so an
    index commits before any follower durably holds it — the
    send/ack confusion a pipelined replication refactor could
    introduce. commit_durability kills it the tick the leader
    commits its own un-acked append."""
    def phase_a(self):
        if self.role == LEADER:
            voters, _ = self.current_config()
            vals = sorted(
                (self.last_index if p == self.id else self.next_index[p]
                 for p in range(self.cfg.k) if (voters >> p) & 1),
                reverse=True)   # BUG: next_index, not match_index
            if vals:
                n = vals[majority_of(voters) - 1]
                n = min(n, self.last_index)
                if n > self.commit and self.term_at(n) == self.term:
                    self.commit = n
        self._phase_a_tail()


# ------------------------------------------------------ log-path mutants


class SkipPrevTermCheck(Node):
    """_on_ae_req skips the (prev_index, prev_term) consistency check:
    entries append after a hole/conflict — Log Matching breaks."""
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
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        # BUG: term_at(prev) != m.prev_term conflict check dropped — a
        # divergent suffix is extended instead of truncated.
        self._install_entries(m, prev)

    def _install_entries(self, m, prev):
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
                    self.log[idx - self.snap_index - 1] = (et, ep)
                    hi = idx
                    continue
                if idx <= self.commit:
                    break   # keep the oracle's guard as flow, not assert
                del self.log[idx - self.snap_index - 1:]
            if not self._append(et, ep):
                break
            hi = idx
        if m.leader_commit > self.commit:
            self.commit = max(self.commit, min(m.leader_commit, hi))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True,
            match=hi))


class CommitPastMatch(Node):
    """_on_ae_req advances commit to leader_commit without clamping to
    `hi`: a follower commits indices its own suffix never matched."""
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
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        if prev >= self.snap_index and self.term_at(prev) != m.prev_term:
            ct = self.term_at(prev)
            ci = prev
            while ci - 1 > self.snap_index and self.term_at(ci - 1) == ct:
                ci -= 1
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=ci))
            return
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
                    self.log[idx - self.snap_index - 1] = (et, ep)
                    hi = idx
                    continue
                if idx <= self.commit:
                    break
                del self.log[idx - self.snap_index - 1:]
            if not self._append(et, ep):
                break
            hi = idx
        if m.leader_commit > self.commit:
            # BUG: min(m.leader_commit, hi) dropped — commit outruns the
            # verified-matching prefix (clamped to last_index so the
            # window stays structurally valid; the SAFETY bug remains).
            self.commit = max(self.commit,
                              min(m.leader_commit, self.last_index))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True,
            match=hi))


class TruncateCommitted(Node):
    """_on_ae_req truncates on a TERM conflict without the payload
    re-term escape or the committed-entry guard: an in-place takeover
    re-proposal wipes a committed suffix instead of re-terming it.
    (commit/applied are rewound alongside so the harness state stays
    structurally traversable — the durability bug remains: a wiped
    committed entry re-applies, double-folding the digest against the
    reference, or re-commits with a different payload.)"""
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
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=self.last_index + 1))
            return
        if prev >= self.snap_index and self.term_at(prev) != m.prev_term:
            ct = self.term_at(prev)
            ci = prev
            while ci - 1 > self.snap_index and self.term_at(ci - 1) == ct:
                ci -= 1
            self.transport.send(rpc.AppendEntriesResp(
                rpc.AE_RESP, self.id, m.src, term=self.term,
                success=False, match=ci))
            return
        j0 = max(0, self.snap_index - prev)
        hi = prev + j0
        for j in range(j0, len(m.entries)):
            idx = prev + 1 + j
            et, ep = m.entries[j]
            if idx <= self.last_index:
                if self.term_at(idx) == et:
                    hi = idx
                    continue
                # BUG: the payload-match re-term escape and the
                # committed-entry guard are both gone — ANY term
                # conflict truncates, committed entries included.
                del self.log[idx - self.snap_index - 1:]
                self.commit = min(self.commit, self.last_index)
                self.applied = min(self.applied, self.commit)
            if not self._append(et, ep):
                break
            hi = idx
        if m.leader_commit > self.commit:
            self.commit = max(self.commit, min(m.leader_commit, hi))
        self.transport.send(rpc.AppendEntriesResp(
            rpc.AE_RESP, self.id, m.src, term=self.term, success=True,
            match=hi))


class RetermWholeSuffix(Node):
    """_become_leader re-terms the WHOLE uncommitted suffix instead of
    only the top entry — the documented round-1 takeover bug
    (node.py §2a comment): current-term entries appear BELOW the
    committed frontier of OTHER nodes, because the re-term range is
    keyed on the new leader's LOCAL commit, which can trail the global
    frontier. The kill is a recency-poisoning chain the sticky hunts
    never found: A@1 commits idx 1-2 with B's acks but B never learns
    (leader_commit blocked); B wins term 2 with commit=0 and re-terms
    the GLOBALLY COMMITTED idx 1 to term 2; a dark node C catching up
    gets just [x1@2] — whose last-log term now BEATS A's genuine
    4-entry term-1 log, so C wins term 3 lacking committed idx 2 and
    replicates over it (state_machine_safety). The top-only oracle
    hands C [x1@1] and A's log-recency vote denies the takeover."""
    def _become_leader(self):
        self.role = LEADER
        self.leader_id = self.id
        self.next_index = [self.last_index + 1] * self.cfg.k
        self.match_index = [0] * self.cfg.k
        self._drop_client_state()
        self.heartbeat_elapsed = self.cfg.heartbeat_every
        # BUG: the round-1 variant — every uncommitted entry re-termed.
        for idx in range(self.commit + 1, self.last_index + 1):
            pos = idx - self.snap_index - 1
            self.log[pos] = (self.term, self.log[pos][1])


class AlwaysEffective(Node):
    """_session_effective drops the duplicate-seq skip: a retried
    (sid, seq) folds into the digest AGAIN on every node — broken
    identically everywhere, so cross-node digest agreement still
    holds; only the reference-digest ghost (an independent recompute
    of the exactly-once fold) catches it."""
    def _session_effective(self, index: int, payload: int) -> bool:
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
        if sid not in self.sessions:
            return False
        # BUG: `seq <= self.sessions[sid]` duplicate skip dropped.
        self.sessions[sid] = max(self.sessions[sid], seq)
        return True


class ShedThenApply(Node):
    """admit_and_propose ignores the shed verdict:
    an arrival the admission queue rejected — whose client got a
    DEFINITIVE reject and will re-issue under a fresh seq, never retry
    this one — is proposed anyway. The command commits and applies, so
    a node's dedup table runs ahead of the issued frontier and
    `client_safety`'s no-phantom-apply clause kills it. This is the
    bug the definitive-reject contract exists to exclude: shed must
    mean NOT IN THE LOG, or exactly-once accounting is fiction."""
    def admit_and_propose(self, sid: int, seq: int, val: int, shed: bool):
        # BUG: `if shed: return None` dropped — the reject is ignored.
        return self.propose_seq(sid, seq, val)


# ------------------------------------------------------------ the catalog


def _b(**kw) -> Bounds:
    base = dict(k=2, ticks=6, max_states=40_000, max_term=3, max_index=4,
                max_dead=1, max_pulses=1)
    base.update(kw)
    return Bounds(**base)


# Every entry is a VERIFIED kill: `check(bounds, node_cls, prefix)`
# trips `expect` on the final tick's exhaustive fan-out, and
# `check(bounds, Node, prefix)` — the unmutated oracle on the same
# waypoint drive — completes clean. Prefixes are the shrunk schedules
# the sticky hunts found (or hand-derived choreography where the random
# walk structurally can't reach the bug — see each docstring); bounds
# carry the trace's actual term/index envelope, so replay never exits
# via in_bounds() early.
MUTANTS: Tuple[Mutant, ...] = (
    Mutant("accept_stale_append", AcceptStaleAppend,
           "sim/step.py phase_d AE_REQ stale-term reject clause",
           # commit_durability (the stronger commit-rule clause)
           # catches the deposed leader's divergent install SHALLOWER
           # than leader_completeness does — BFS reports the first
           # violation, so the expectation follows the new frontier.
           "commit_durability",
           _b(k=3, ticks=14, log_cap=4, compact_every=2, max_index=5,
              max_dead=0, adversary="isolate"),
           "deposed leader's AE still installs entries",
           _sched(3, "p0", "", "", "p2",
                  "b01 b02 b10 b20", "b01 b02 b10 b20",
                  "b01 b02 b10 b20", "b01 b02 b10 b20",
                  "b01 b02 b10 b20 b21", "b01 b02 b10 b20 b21",
                  "b02 b10 b20 b21", "b02 b20 b21 p0", "b02 b20 b21")),
    Mutant("skip_vote_dedup", SkipVoteDedup,
           "sim/step.py phase_d RV_REQ grant clause (voted_for dedup)",
           "election_safety_history", _b(max_pulses=2),
           "voted_for dedup dropped — double vote per term"),
    Mutant("index_only_log_ok", IndexOnlyLogOk,
           "sim/step.py phase_d RV_REQ log-recency clause",
           "state_machine_safety",
           _b(k=3, ticks=25, max_term=4, max_pulses=2),
           "log recency by index alone — stale log electable",
           _sched(3, "", "p0", "", "", "p2", "", "", "p0",
                  "b01 b02", "b01 b02", "b01 b21", "", "", "", "", "",
                  "", "", "p0", "", "", "", "", "")),
    Mutant("count_stale_vote_resp", CountStaleVoteResp,
           "sim/step.py phase_d RV_RESP tally guard",
           "log_matching", _b(k=3, ticks=14, max_term=4, max_pulses=2),
           "grants from a dead candidacy tallied",
           _sched(3, "", "", "", "p2", "", "", "", "", "p1", "p0",
                  "p0", "b01 b02 p2", "b01 b02 b20")),
    Mutant("minority_quorum", MinorityQuorum,
           "sim/step.py vote-quorum popcount threshold",
           "election_safety_history", _b(max_pulses=2),
           "k//2 votes win — disjoint majorities"),
    Mutant("volatile_term", VolatileTerm,
           "sim/step.py restart mask (term is durable)",
           "election_safety_history",
           _b(k=3, ticks=22, max_index=10, adversary="isolate"),
           "crash drops the durable term — re-win a used term",
           _sched(3, "p0", "", "", "", "", "", "", "", "", "", "", "",
                  "", "", "p2", "x2", "x0 b02 b12", "", "x1", "p2",
                  "")),
    Mutant("commit_off_by_one", CommitOffByOne,
           "sim/step.py phase_a sorted-match commit rank",
           "state_machine_safety", _b(k=3, ticks=6, max_pulses=2),
           "minority replication commits",
           _sched(3, "p1", "", "", "p2", "")),
    Mutant("commit_stale_term", CommitStaleTerm,
           "sim/step.py phase_a §5.4.2 current-term commit guard",
           "state_machine_safety",
           _b(k=3, ticks=23, max_states=120_000, max_term=5,
              max_entries=1, max_pulses=2),
           "prior-term entry commits by counting (Figure 8)",
           _sched(3, "", "", "p0", "b01 b21", "", "p2", "", "p1", "",
                  "", "p0", "b02 b12", "", "b02 b12", "", "", "p2",
                  "", "", "", "", "")),
    Mutant("ack_beyond_sent", AckBeyondSent,
           "sim/step.py phase_d AE_RESP match-index credit",
           "state_machine_safety", _b(k=3, ticks=10),
           "success acks credit one entry past the matched prefix",
           _sched(3, "p0", "", "", "", "", "b01 b02 p1", "", "", "")),
    Mutant("skip_prev_term_check", SkipPrevTermCheck,
           "sim/step.py phase_d AE_REQ prev-term conflict clause",
           "state_machine_safety",
           _b(k=3, ticks=17, max_term=4, max_index=5, max_pulses=2),
           "append after divergence — Log Matching breaks",
           _sched(3, "", "", "p0", "", "", "", "", "p2", "", "p0",
                  "p2", "", "", "", "", "")),
    Mutant("commit_past_match", CommitPastMatch,
           "sim/step.py phase_d AE_REQ commit clamp (min with hi)",
           "state_machine_safety",
           _b(k=3, ticks=16, log_cap=7, compact_every=5, max_entries=1,
              max_term=4, max_index=7),
           "follower commit outruns its matched prefix",
           _sched(3, "p1", "", "", "", "", "p2",
                  "b10 b12 b01 b21", "", "b10 b12 b01 b21", "", "",
                  "b10 b12 b01 b21", "b10 b12 b01 b21",
                  "b10 b12 b01 b21", "")),
    Mutant("truncate_committed", TruncateCommitted,
           "sim/step.py phase_d AE_REQ committed-prefix truncate guard",
           "state_machine_digest",
           _b(k=3, ticks=20, log_cap=4, compact_every=2, max_index=5,
              max_pulses=2),
           "conflict resolution deletes below the commit frontier",
           _sched(3, "", "", "", "", "", "", "", "", "", "p0", "", "",
                  "", "x1", "b01 b02 p2", "", "", "", "")),
    Mutant("reterm_whole_suffix", RetermWholeSuffix,
           "sim/step.py become-leader takeover re-term (top entry only)",
           "state_machine_safety",
           _b(k=3, ticks=19, log_cap=4, compact_every=2, max_entries=1,
              max_index=5, max_dead=0),
           "whole-suffix re-term — the documented round-1 bug",
           _sched(3, "p0", "", "", "", "b02 b20", "b02 b20", "b02 b20",
                  "b02 b20 b01", "b02 b20 b01 p1", "", "", "", "", "",
                  "p2", "", "", "")),
    Mutant("ack_without_persist", AckWithoutPersist,
           "sim/step.py phase_d AE_REQ entry-walk room clause (~df fold)",
           "commit_durability",
           _b(ticks=6, max_dead=0, max_disk=1, log_cap=4,
              compact_every=2, max_index=5),
           "entries storage rejected are acked — fsync skipped",
           _sched(2, "p0", "", "", "", "d1")),
    Mutant("commit_past_durable", CommitPastDurable,
           "sim/step.py phase_a commit tally (match_index, not next_index)",
           "commit_durability",
           _b(ticks=3, max_dead=0, log_cap=4, compact_every=2,
              max_index=5),
           "send pointer tallied as replicated — commit precedes acks",
           _sched(2, "p0", "")),
    Mutant("shed_then_apply", ShedThenApply,
           "clients/workload.py admission shed gate (definitive reject)",
           "client_safety",
           _b(sessions=True, admission=True, ticks=6, max_dead=0),
           "shed arrival proposed anyway — reject was not definitive",
           _sched(2, "p0", "", "s0", "", "")),
    Mutant("always_effective", AlwaysEffective,
           "sim/step.py session dedup fold (seq <= table entry skip)",
           "state_machine_digest",
           _b(sessions=True, ticks=14, max_pulses=2),
           "duplicate retry re-applies — exactly-once breaks",
           _sched(2, "", "", "", "", "", "p0", "", "", "", "n0", "u0",
                  "", "")),
)


def by_name(name: str) -> Mutant:
    for m in MUTANTS:
        if m.name == name:
            return m
    raise KeyError(name)
