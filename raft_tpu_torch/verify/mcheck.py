"""Bounded exhaustive model checker for the tick semantics, over the
port's CPU oracle: the JAX package's `verify/mcheck.py`, state for
state. It explores the same states in the same order and finds the
same first violation and schedule, so a reproducer written by either
package replays in the other.

Enumerates ALL reachable states of the REAL CPU oracle step
(`core/node.py` `Node` objects on a `core/transport.Transport`, driven
by a tick loop mirroring `Cluster.tick`) for small-scope universes —
k in {2, 3}, log cap <= 3, bounded term/index — under every delivery,
drop, crash, and timeout schedule within `Bounds`, via BFS over
canonicalized states with node-permutation symmetry reduction. At
every state it evaluates the SAME predicates the runtime fold spot-
checks (`verify/invariants.py`, shared with `sim/check.py`) plus two
history-ghost invariants a point-in-time predicate cannot see
(per-term leader uniqueness across time; commit identity of every
(index, payload) ever applied). A violation emits a nemesis-format
reproducer artifact whose explicit schedule replays deterministically
(`replay`), and which `scripts/torch_nemesis_search.py --replay`
accepts.

Soundness of the abstractions (each an OVER-approximation — the
checker explores a superset of the behaviors the hashed production
schedules can produce, so "clean here" implies "clean there"):

- Adversarial timers: every node's election deadline is pinned
  unreachably high and the SCHEDULER chooses which nodes time out each
  tick (a pulse sets `election_elapsed = deadline - 1` so phase T
  fires). Any hash-drawn timeout pattern is one pulse schedule among
  those enumerated; `rng_draws`/`deadline`/`election_elapsed` leave
  the canonical key. This is also what makes node-permutation symmetry
  exact: the only id-dependent inputs (the per-id deadline hashes) are
  replaced by the adversary.
- Adversarial delivery: per tick the scheduler picks any subset of the
  links currently carrying in-flight mail to BLOCK (via the
  `Transport.link_filter` seam — dead-destination loss stays in the
  real `deliver`). Hash-driven drops/partitions/nemesis clauses are
  link subsets, so all are covered.
- Adversarial crashes: any alive-vector per tick with at most
  `max_dead` nodes down (restart-on-revive through the real
  `Node.restart`).
- Adversarial storage pressure: with `max_disk > 0` the scheduler
  forces any subset of at most `max_disk` nodes' persistence budgets
  empty for the tick (`Node.disk_override` — the seam `_append`
  consults before the hashed disk_full_follower schedule), so every
  hash-drawn disk-full pattern is one override schedule among those
  enumerated, and `commit_durability` is checked against the full
  adversarial lossy-persistence space.
- Time-homogeneous scope: reconfig/reads/transfer/nemesis are off and
  fault hashes are scheduler-replaced, so transitions do not depend on
  the absolute tick — state dedup across depths is sound, and
  `ack_time`/read state (which only feed the disabled machinery) leave
  the key. `leader_elapsed` is capped at `election_min` in the key
  (the PreVote lease only tests `>= election_min`).
- The batched engines are NOT re-modeled: sim/step.py and the
  fused-chunk kernel are held bit-identical to this oracle by the
  differential tests, so the verdict transfers to both engines.

The predicates see the oracle through torch tensors (the port's
`verify/invariants.py`); `narrow=True` casts the views to the dtypes
the port's own `sim/state.narrow_spec` gives the same leaves. The u32
digests are int64 tensors of their u32 values, as the port holds them.

The exactly-once client universe (`Bounds.sessions=True`) drives
`propose_seq` adversarially: each tick the scheduler may hand any
self-believed leader a fresh command or a duplicate retry of the last
issued seq — the dual-leader double-append scenarios session dedup
exists for — and `client_safety` is checked against the ghost issued
frontier. With `Bounds.admission=True` it may also hand a leader a
SHED arrival (`Node.admit_and_propose` with shed=True): the
definitive-reject contract means the seq is never issued, so a node
that applies it anyway trips `client_safety`'s issued-frontier clause.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Callable, List, Optional

import torch

from raft_tpu_torch import config as cfgmod
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import rpc
from raft_tpu_torch.core.node import LEADER, Node
from raft_tpu_torch.core.transport import Transport
from raft_tpu_torch.utils import rng
from raft_tpu_torch.verify import invariants as inv

#: Unreachably-high election deadline: the adversary owns timeouts.
HUGE_DEADLINE = 1 << 30

ARTIFACT_KIND = "mcheck-reproducer"
ARTIFACT_ENGINES = "oracle-mcheck"



def _narrow_view_dtypes() -> dict:
    """The checker's view name -> the dtype the port's `narrow_spec`
    gives that node leaf with every narrow dial on. Payload and digest
    lanes stay wide, as the spec keeps them."""
    from raft_tpu_torch.sim.state import full_narrow_spec
    spec = full_narrow_spec(RaftConfig())
    return {name: spec[f"nodes.{name}"]
            for name in ("role", "term", "commit", "applied",
                         "snap_index", "last_index", "log_term")}


#: The narrow-native dtype map over the checker's view names, used by
#: `predicate_report(narrow=True)` to prove the shared predicates are
#: width-robust over the exhaustive small scope.
_NARROW_VIEW_DTYPES = _narrow_view_dtypes()


@dataclasses.dataclass(frozen=True)
class Bounds:
    """The small-scope universe: every knob both caps the state space
    and names exactly what the verdict covers."""
    k: int = 2                # replicas (2 or 3; symmetry reduces k!)
    log_cap: int = 3          # ring window (>= compact_every + cmds + 1)
    ticks: int = 6            # schedule depth (BFS levels)
    max_states: int = 50_000  # canonical-state budget (complete=False past it)
    max_term: int = 3         # prune states whose any term exceeds this
    max_index: int = 4        # prune states whose any last_index exceeds this
    max_dead: int = 1         # simultaneously-crashed cap per tick
    max_pulses: int = 1       # nodes the timeout adversary fires per tick
    max_disk: int = 0         # simultaneously disk-full cap per tick
    sessions: bool = False    # exactly-once client universe (cmds off)
    admission: bool = False   # shed arrivals in the propose menu
    prevote: bool = False
    # compact_every=1 snapshots every committed entry immediately (the
    # smallest window state space). Some bug classes live in the gap
    # between commit and compaction — e.g. truncating a committed entry
    # still in the window — and need compact_every >= 2 (with log_cap
    # respecting cfg's `log_cap >= compact_every + cmds + 1` floor).
    compact_every: int = 1
    max_entries: int = 2      # cfg.max_entries_per_msg (1 = one-entry AEs)
    # Narrow the delivery adversary from arbitrary per-link subsets
    # ("links": 2^active_links options) to directional single-node
    # isolation ("isolate": none, or one node's inbound / outbound /
    # both links cut). Kill runs use "isolate" to tame the branch
    # factor — any schedule found is still a real schedule, so a kill
    # stands; CLEAN exhaustive runs keep the full per-link adversary
    # (asymmetric loss included).
    adversary: str = "links"


def bounds_config(b: Bounds) -> RaftConfig:
    """The RaftConfig of a small-scope universe. Faults are OFF — the
    scheduler owns them — and reconfig/reads/transfer are outside the
    modeled scope (documented above)."""
    return RaftConfig(
        seed=0, k=b.k, log_cap=b.log_cap,
        max_entries_per_msg=min(b.max_entries, b.log_cap),
        heartbeat_every=1, election_min=3, election_range=1,
        compact_every=b.compact_every,
        cmds_per_tick=0 if b.sessions else 1,
        sessions=b.sessions,
        client_rate=0.5 if b.sessions else 0.0,  # pre-registers slot 0
        client_slots=1 if b.sessions else 4,
        prevote=b.prevote)


# ------------------------------------------------------------ the universe


def _adversarial_reset(n: Node):
    """Instance-patched `_reset_election_timer`: no hash draw, no
    reachable deadline — timeouts happen only when pulsed."""
    n.election_elapsed = 0
    n.deadline = HUGE_DEADLINE
    n.rng_draws += 1


class Universe:
    """k real `Node`s + a real `Transport` under scheduler control,
    with freeze/restore so BFS can fan out from any state."""

    def __init__(self, bounds: Bounds, node_cls=Node,
                 narrow: bool = False):
        self.bounds = bounds
        # narrow=True evaluates every predicate on narrow-native views
        # (_NARROW_VIEW_DTYPES) — the kill-matrix re-run mode: a
        # mutant must die, and the clean oracle must survive, at BOTH
        # widths or the _signed lifts are wrong.
        self.narrow = narrow
        self.cfg = bounds_config(bounds)
        self.transport = Transport(self.cfg, 0)
        self.nodes = [node_cls(self.cfg, 0, i, self.transport,
                               on_apply=self._on_apply)
                      for i in range(self.cfg.k)]
        for n in self.nodes:
            n._reset_election_timer = (lambda n=n: _adversarial_reset(n))
            n.deadline = HUGE_DEADLINE
        self.alive_prev = [True] * self.cfg.k
        # History ghosts (part of the frozen state): term -> leader id,
        # applied index -> payload, exactly-once issued frontier.
        self.ghost_leaders: dict = {}
        self.ghost_committed: dict = {}
        self.issued = -1
        self._sm_violation = False
        # Reference session table at index 0 (clients_u32 pre-registers
        # the slots) — seed of the reference-digest recompute.
        self._initial_sessions = dict(self.nodes[0].snap_sessions)

    def _on_apply(self, node_id: int, index: int, term: int, payload: int):
        """State-machine safety ghost (cluster._on_apply's commit-
        identity check): every apply of index i must carry the payload
        the first apply of i carried, on every node, forever."""
        prev = self.ghost_committed.setdefault(index, payload)
        if prev != payload:
            self._sm_violation = True

    # -------------------------------------------------- freeze / restore

    def freeze(self) -> tuple:
        b, cfg = self.bounds, self.cfg
        nodes = []
        for n in self.nodes:
            nodes.append((
                n.term, n.voted_for, tuple(n.log), n.snap_index,
                n.snap_term, n.snap_digest, n.snap_voters,
                tuple(sorted(n.snap_sessions.items())),
                n.role, n.leader_id, n.commit, n.applied, n.digest,
                tuple(sorted(n.sessions.items())),
                tuple(n.votes), tuple(n.next_index), tuple(n.match_index),
                n.heartbeat_elapsed,
                min(n.leader_elapsed, cfg.election_min) if b.prevote else 0,
            ))
        msgs = tuple(sorted(dataclasses.astuple(m)
                            for m in self.transport._outbox))
        return (tuple(nodes), msgs, tuple(self.alive_prev),
                tuple(sorted(self.ghost_leaders.items())),
                tuple(sorted(self.ghost_committed.items())),
                self.issued)

    def restore(self, raw: tuple):
        nodes, msgs, alive_prev, gl, gc, issued = raw
        for n, s in zip(self.nodes, nodes):
            (n.term, n.voted_for, log, n.snap_index, n.snap_term,
             n.snap_digest, n.snap_voters, snap_sessions, n.role,
             n.leader_id, n.commit, n.applied, n.digest, sessions,
             votes, next_index, match_index, n.heartbeat_elapsed,
             n.leader_elapsed) = s
            n.log = list(log)
            n.snap_sessions = dict(snap_sessions)
            n.sessions = dict(sessions)
            n.votes = list(votes)
            n.next_index = list(next_index)
            n.match_index = list(match_index)
            n.election_elapsed = 0
            n.deadline = HUGE_DEADLINE
            n.ack_time = [-1] * self.cfg.k
            n.pending_reads = {}
            n.sched_read = None
        self.transport._outbox = [_msg_from_tuple(m) for m in msgs]
        self.alive_prev = list(alive_prev)
        self.ghost_leaders = dict(gl)
        self.ghost_committed = dict(gc)
        self.issued = issued
        self._sm_violation = False

    # ------------------------------------------------------- one tick

    def tick(self, t: int, choice: dict) -> List[str]:
        """Run ONE tick under `choice` (mirrors Cluster.tick with the
        scheduler owning alive/links/timeouts/proposes); returns the
        violated predicate names (empty = safe)."""
        cfg = self.cfg
        alive_now = list(choice["alive"])
        blocked = {tuple(l) for l in choice["blocked"]}
        disk = set(choice.get("disk", ()))
        for i, n in enumerate(self.nodes):
            n.now = t
            # Adversarial storage pressure: the override seam every
            # `_append` consults (set for ALL nodes every tick, so no
            # stale override survives a restore).
            n.disk_override = i in disk
        for i, n in enumerate(self.nodes):
            if alive_now[i] and not self.alive_prev[i]:
                n.restart()
        self.transport.link_filter = (
            lambda tick, s, d: (s, d) not in blocked)
        inboxes = self.transport.deliver(t, alive_now)
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_d(inboxes[i])
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                if i in choice["pulse"]:
                    n.election_elapsed = n.deadline - 1
                n.phase_t()
                n.election_elapsed = 0   # excluded from the key; keep flat
        # Adversarial client (sessions universe): a fresh command or a
        # duplicate retry lands on a self-believed leader at phase C's
        # position — the real client seam (node.phase_c appends client
        # payloads after phase D/T, so a leader deposed THIS tick no
        # longer appends, while a not-yet-informed dual leader does).
        prop = choice.get("propose")
        if prop is not None:
            i, kind = prop
            n = self.nodes[i]
            # "new"/"shed" arrive with the next unissued seq; "dup"
            # retries the last issued one. Routed through the
            # admission seam: a shed arrival is a definitive reject, so
            # `issued` NEVER advances for it (only an accepted "new"
            # does) — a node that applies a shed command runs ahead of
            # the ghost frontier and client_safety kills it.
            seq = self.issued if kind == "dup" else self.issued + 1
            if seq >= 0 and n.role == LEADER and alive_now[i]:
                r = n.admit_and_propose(0, seq, seq, shed=(kind == "shed"))
                if r is not None and kind == "new":
                    self.issued = seq
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_c(None)
        for i, n in enumerate(self.nodes):
            if alive_now[i]:
                n.phase_a()
        self.alive_prev = alive_now
        # History ghosts.
        for n in self.nodes:
            if n.role == LEADER:
                if self.ghost_leaders.setdefault(n.term, n.id) != n.id:
                    return ["election_safety_history"]
        if self._sm_violation:
            return ["state_machine_safety"]
        if not self._digests_match_reference():
            return ["state_machine_digest"]
        return self.violations()

    def _digests_match_reference(self) -> bool:
        """Reference-semantics ghost: every node's digest must equal the
        fold of the committed payload sequence (ghost_committed, which
        state-machine safety pins to one payload per index) through the
        REFERENCE exactly-once filter, up to that node's applied point.
        Catches bugs the cross-node predicates cannot: a dedup filter
        broken IDENTICALLY on every node double-applies everywhere, so
        digests still agree with each other — only a recompute against
        independent reference semantics notices."""
        for n in self.nodes:
            if n.digest != self._reference_digest(n.applied):
                return False
        return True

    def _reference_digest(self, upto: int) -> int:
        d = 0
        table = dict(self._initial_sessions)
        for i in range(1, upto + 1):
            p = self.ghost_committed[i]
            if self._ref_effective(table, i, p):
                d = rng.digest_update(d, i, p)
        return d

    def _ref_effective(self, table: dict, index: int, payload: int) -> bool:
        """`Node._session_effective` re-derived over a local table — an
        independent transcription of the spec, NOT a call into the
        (possibly mutated) node under test."""
        if not self.cfg.sessions:
            return True
        if (payload & cfgmod.CONFIG_FLAG
                or not payload & cfgmod.SESSION_FLAG):
            return True
        sid = ((payload >> cfgmod.SESSION_SID_SHIFT)
               & cfgmod.SESSION_SID_MASK)
        if sid == cfgmod.SESSION_SID_MASK:          # REGISTER
            new_sid = index % cfgmod.SESSION_SID_MASK
            if new_sid in table:
                return False
            table[new_sid] = -1
            return True
        seq = ((payload >> cfgmod.SESSION_SEQ_SHIFT)
               & cfgmod.SESSION_SEQ_MASK)
        if sid not in table or seq <= table[sid]:
            return False
        table[sid] = seq
        return True

    # --------------------------------------------------- shared predicates

    def views(self):
        """`[1, K]` / `[1, K, L]` int64 tensor views of the oracle state,
        built by the ring slot rule ((i-1) % L) — the exact leaf layout
        the batched State carries, so the SHARED predicates see the
        oracle through the same lens the runtime fold sees the
        engines."""
        cfg = self.cfg
        k, L = cfg.k, cfg.log_cap
        f = lambda attr: torch.tensor([[getattr(n, attr)
                                        for n in self.nodes]])
        v = {name: f(name) for name in
             ("role", "term", "commit", "applied", "digest", "snap_index")}
        v["last_index"] = torch.tensor([[n.last_index for n in self.nodes]])
        lt = [[0] * L for _ in range(k)]
        lp = [[0] * L for _ in range(k)]
        for i, n in enumerate(self.nodes):
            for idx in range(n.snap_index + 1, n.last_index + 1):
                et, ep = n.log[idx - n.snap_index - 1]
                lt[i][(idx - 1) % L] = et
                lp[i][(idx - 1) % L] = ep
        v["log_term"] = torch.tensor([lt])
        v["log_payload"] = torch.tensor([lp])
        return v

    def predicate_report(self, narrow: bool = False) -> dict:
        """name -> bool: the verify/invariants predicates (the clause
        registry sim/check.py folds, plus log_matching which the
        runtime approximates via digest agreement) on this state.

        `narrow=True` evaluates the SAME predicates on views cast to
        the narrow-native dtypes (sim/state.narrow_spec's map — u16
        terms/indices, i8 roles, i16 session tables): at bounded-model
        scope every value fits, so the two
        reports must be identical — `narrow_agreement_problems` walks
        the small universe asserting exactly that, which is how the
        width-robustness of verify/invariants (its `_signed` lifts) is
        proven against the exhaustive state space rather than one
        hand-picked example."""
        cfg, v = self.cfg, self.views()
        if narrow:
            v = {name: a.to(_NARROW_VIEW_DTYPES.get(name, a.dtype))
                 for name, a in v.items()}
        rep = {
            "election_safety": inv.election_safety(v["role"], v["term"]),
            "digest_agreement": inv.digest_agreement(v["applied"],
                                                     v["digest"]),
            "window_bounds": inv.window_bounds(
                v["applied"], v["commit"], v["snap_index"],
                v["last_index"], cfg.log_cap),
            "log_matching": inv.log_matching(
                v["last_index"], v["snap_index"], v["log_term"],
                v["log_payload"], cfg.log_cap),
            "leader_completeness": inv.leader_completeness(
                v["role"], v["term"], v["commit"], v["last_index"],
                v["snap_index"], v["log_payload"], cfg.log_cap),
            # Checker-side like log_matching (not in the runtime fold):
            # the commit rule vs lossy persistence — every
            # committed index still in view is held by a k-majority.
            "commit_durability": inv.commit_durability(
                v["commit"], v["last_index"], v["snap_index"],
                v["log_payload"], cfg.log_cap),
        }
        if self.bounds.sessions:
            table = torch.tensor([[[n.sessions.get(0, -1)]
                                   for n in self.nodes]])  # [1, K, 1]
            done = torch.tensor([[self.issued]])           # [1, 1]
            if narrow:
                # i16 both: the spec's table dtype, and — for `done` —
                # the sign-preserving width, because the mcheck frontier
                # uses a -1 "nothing issued" sentinel the resident u16
                # lane never stores (ClientState.done is a count).
                table = table.to(torch.int16)
                done = done.to(torch.int16)
            rep["client_safety"] = inv.client_safety(
                v["applied"], table, done)
        return {name: bool(ok.all()) for name, ok in rep.items()}

    def violations(self) -> List[str]:
        return [name for name, ok
                in self.predicate_report(narrow=self.narrow).items()
                if not ok]

    def in_bounds(self) -> bool:
        b = self.bounds
        return all(n.term <= b.max_term and n.last_index <= b.max_index
                   for n in self.nodes)

    # ------------------------------------------------------ choice menu

    def choices(self):
        """Every scheduler choice from the CURRENT state: alive vectors
        (<= max_dead down), blocked-link subsets over links actually
        carrying in-flight mail, timeout pulses (<= max_pulses alive
        voters), and (sessions) propose actions on self-believed
        leaders. Restore the state before calling."""
        b, k = self.bounds, self.cfg.k
        alive_opts = []
        for dead in range(b.max_dead + 1):
            for down in itertools.combinations(range(k), dead):
                alive_opts.append(tuple(i not in down for i in range(k)))
        active = sorted({(m.src, m.dst) for m in self.transport._outbox})
        if b.adversary == "isolate":
            # Directional single-node isolation: nothing blocked, or one
            # node's inbound / outbound / both directions cut (deduped —
            # isolating a node with no mail changes nothing).
            subsets = {()}
            for i in range(k):
                subsets.add(tuple(sorted(l for l in active if l[1] == i)))
                subsets.add(tuple(sorted(l for l in active if l[0] == i)))
                subsets.add(tuple(sorted(l for l in active if i in l)))
            blocked_opts = sorted(subsets)
        else:
            blocked_opts = []
            for r in range(len(active) + 1):
                for sub in itertools.combinations(active, r):
                    blocked_opts.append(sub)
        pulse_opts = [()]
        for r in range(1, b.max_pulses + 1):
            pulse_opts.extend(itertools.combinations(range(k), r))
        disk_opts = [()]
        for r in range(1, b.max_disk + 1):
            disk_opts.extend(itertools.combinations(range(k), r))
        prop_opts: list = [None]
        if b.sessions:
            for i, n in enumerate(self.nodes):
                if n.role == LEADER:
                    prop_opts.append((i, "new"))
                    if self.issued >= 0:
                        prop_opts.append((i, "dup"))
                    if b.admission:
                        prop_opts.append((i, "shed"))
        for alive in alive_opts:
            for blocked in blocked_opts:
                for pulse in pulse_opts:
                    if any(not alive[i] for i in pulse):
                        continue   # a dead node cannot time out
                    for disk in disk_opts:
                        for prop in prop_opts:
                            yield {"alive": alive, "blocked": blocked,
                                   "pulse": pulse, "disk": disk,
                                   "propose": prop}


def _msg_from_tuple(t: tuple):
    """Invert dataclasses.astuple for the 9 frozen RPC dataclasses
    (astuple of a flat dataclass is positional-field order)."""
    cls = _MSG_CLS[t[0]]
    vals = list(t)
    # astuple recursed into the entries tuple-of-tuples already; the
    # field wants tuples back (astuple yields tuples here, not lists).
    return cls(*vals)


_MSG_CLS = {
    rpc.RV_REQ: rpc.RequestVoteReq, rpc.RV_RESP: rpc.RequestVoteResp,
    rpc.AE_REQ: rpc.AppendEntriesReq, rpc.AE_RESP: rpc.AppendEntriesResp,
    rpc.IS_REQ: rpc.InstallSnapshotReq, rpc.IS_RESP: rpc.InstallSnapshotResp,
    rpc.PV_REQ: rpc.PreVoteReq, rpc.PV_RESP: rpc.PreVoteResp,
    rpc.TN_REQ: rpc.TimeoutNow,
}


# -------------------------------------------------- symmetry + canonical


def _permute_raw(raw: tuple, perm: tuple, k: int) -> tuple:
    """The frozen state under node relabeling i -> perm[i]: node order,
    every id-valued field (voted_for/leader_id/ghost leaders), every
    peer-indexed vector (votes/next/match), voter bitmasks, and message
    endpoints. Valid because the adversarial-timer regime removed the
    only id-dependent inputs (module docstring)."""
    nodes, msgs, alive_prev, gl, gc, issued = raw
    invp = [0] * k
    for i, p in enumerate(perm):
        invp[p] = i

    def rid(x):
        return perm[x] if 0 <= x < k else x

    def rmask(m):
        out = 0
        for i in range(k):
            if (m >> i) & 1:
                out |= 1 << perm[i]
        return out

    new_nodes = []
    for j in range(k):
        (term, voted_for, log, snap_index, snap_term, snap_digest,
         snap_voters, snap_sessions, role, leader_id, commit, applied,
         digest, sessions, votes, next_index, match_index, hb,
         le) = nodes[invp[j]]
        new_nodes.append((
            term, rid(voted_for), log, snap_index, snap_term, snap_digest,
            rmask(snap_voters), snap_sessions, role, rid(leader_id),
            commit, applied, digest, sessions,
            tuple(votes[invp[i]] for i in range(k)),
            tuple(next_index[invp[i]] for i in range(k)),
            tuple(match_index[invp[i]] for i in range(k)), hb, le))
    new_msgs = tuple(sorted(
        _permute_msg(m, perm, rmask) for m in msgs))
    return (tuple(new_nodes), new_msgs,
            tuple(alive_prev[invp[j]] for j in range(k)),
            tuple(sorted((t, perm[i]) for t, i in gl)), gc, issued)


def _permute_msg(m: tuple, perm: tuple, rmask) -> tuple:
    out = list(m)
    out[1], out[2] = perm[m[1]], perm[m[2]]
    if m[0] == rpc.IS_REQ:
        # snap_voters rides InstallSnapshot (field 6 after type/src/dst/
        # term/snap_index/snap_term... positional: type,src,dst,term,
        # snap_index,snap_term,snap_digest,snap_voters,snap_sessions).
        out[7] = rmask(m[7])
    return tuple(out)


def canonical(raw: tuple, k: int) -> tuple:
    """Minimum over all k! node relabelings — the symmetry quotient."""
    return min(_permute_raw(raw, perm, k)
               for perm in itertools.permutations(range(k)))


# --------------------------------------------------------------- the BFS


@dataclasses.dataclass
class Result:
    ok: bool
    states: int                 # canonical states reached
    transitions: int            # ticks executed
    depth: int                  # BFS levels completed
    complete: bool              # True iff no budget cap was hit
    pruned: int                 # states past max_term/max_index
    violation: Optional[dict] = None   # tick / predicates / schedule

    def summary(self) -> str:
        if not self.ok:
            v = self.violation
            return (f"VIOLATION {v['predicates']} at tick {v['tick']} "
                    f"({self.states} states)")
        tag = "exhaustive" if self.complete else "budget-capped"
        return (f"clean: {self.states} canonical states, "
                f"{self.transitions} transitions, depth {self.depth} "
                f"({tag}, {self.pruned} pruned at scope bound)")


def check(bounds: Bounds, node_cls=Node, log: Callable = None,
          prefix: tuple = (), narrow: bool = False) -> Result:
    """BFS over the canonicalized reachable states. Every state at
    every depth is checked against the shared predicates + history
    ghosts; the first violation wins and carries its full scheduler
    trace (root -> violation), already minimal in DEPTH because BFS
    reaches shallow states first.

    `prefix`: fixed scheduler choices for the first len(prefix) ticks —
    a waypoint drive into a deep protocol region, after which the BFS
    fans out exhaustively for the remaining `bounds.ticks - len(prefix)`
    levels (guided model checking). The emitted counterexample contains
    the prefix, so the artifact is still one complete, replayable
    schedule; clean-verification runs use no prefix. `narrow=True`
    evaluates the predicates on narrow-native views — the kill matrix
    must reproduce at both widths."""
    uni = Universe(bounds, node_cls, narrow=narrow)
    root = uni.freeze()
    seen = {canonical(root, bounds.k)}
    frontier = [(root, ())]     # (raw state, schedule that reached it)
    states = transitions = pruned = 0
    capped = False
    for depth in range(bounds.ticks):
        nxt = []
        for raw, sched in frontier:
            if depth < len(prefix):
                menu = [prefix[depth]]
            else:
                uni.restore(raw)
                menu = list(uni.choices())
            for choice in menu:
                uni.restore(raw)
                try:
                    viol = uni.tick(depth, choice)
                except AssertionError:
                    # A step-internal assert (e.g. "refusing to truncate
                    # committed entries") firing IS a safety finding —
                    # the oracle's own last-line guard tripped.
                    viol = ["oracle_assertion"]
                transitions += 1
                if viol:
                    try:
                        report = uni.predicate_report(narrow=uni.narrow)
                    except Exception:
                        report = {}   # mid-assert state may not view
                    return Result(
                        ok=False, states=len(seen),
                        transitions=transitions, depth=depth + 1,
                        complete=False, pruned=pruned,
                        violation={
                            "tick": depth,
                            "predicates": viol,
                            "schedule": list(sched) + [choice],
                            "report": report,
                        })
                if not uni.in_bounds():
                    pruned += 1
                    continue
                new_raw = uni.freeze()
                ck = canonical(new_raw, bounds.k)
                if depth < len(prefix):
                    # Prefix drive, not exploration: a waypoint tick may
                    # be a canonical no-op (e.g. a quiet tick before any
                    # mail is in flight) — dedup must not prune the ride.
                    seen.add(ck)
                    nxt.append((new_raw, sched + (choice,)))
                    continue
                if ck in seen:
                    continue
                if len(seen) >= bounds.max_states:
                    capped = True
                    continue
                seen.add(ck)
                nxt.append((new_raw, sched + (choice,)))
        frontier = nxt
        if log:
            log(f"mcheck depth {depth + 1}: {len(seen)} states, "
                f"{transitions} transitions")
        if not frontier:
            break
    return Result(ok=True, states=len(seen), transitions=transitions,
                  depth=depth + 1, complete=not capped, pruned=pruned)


# ----------------------------------------------- hunt (guided search)


def _quiet(choice_alive_k: int) -> dict:
    return {"alive": tuple([True] * choice_alive_k), "blocked": (),
            "pulse": (), "disk": (), "propose": None}


def hunt(bounds: Bounds, node_cls=Node, episodes: int = 2000,
         horizon: int = 20, seed: int = 0, log: Callable = None):
    """Biased random-walk search for deep counterexamples — the
    simulation mode every bounded checker grows once exhaustive depth
    runs out (TLC's -simulate). Episodes sample schedules that LOOK
    like fault traces — STICKY faults: a crashed node stays down and a
    blocked direction stays blocked across consecutive ticks with high
    probability, the way real gray failures persist, plus occasional
    pulses. The deep counterexamples (Figure 8, deposed-leader
    replication) all need a fault HELD across 5-10 ticks, which
    independent per-tick sampling essentially never produces. A hit is
    shrunk (`shrink_schedule`) and returned as (schedule, predicates).
    Deterministic under `seed` — the kill matrix pins its seeds.
    Returns None if no violation within the budget."""
    import random
    r = random.Random(seed)
    uni = Universe(bounds, node_cls)
    root = uni.freeze()
    k = bounds.k
    links = [(a, b) for a in range(k) for b in range(k) if a != b]
    for ep in range(episodes):
        uni.restore(root)
        sched = []
        down = None          # sticky crash
        blocked = ()         # sticky directional block
        full = None          # sticky disk-full node
        for t in range(horizon):
            c = dict(_quiet(k))
            if down is not None and r.random() < 0.65:
                pass                            # stays down
            elif bounds.max_dead and r.random() < 0.15:
                down = r.randrange(k)
            else:
                down = None
            if down is not None:
                c["alive"] = tuple(i != down for i in range(k))
            if blocked and r.random() < 0.70:
                pass                            # stays blocked
            elif r.random() < 0.35:
                i = r.randrange(k)
                dirn = r.random()
                if dirn < 0.4:
                    blocked = tuple(l for l in links if l[0] == i)
                elif dirn < 0.8:
                    blocked = tuple(l for l in links if l[1] == i)
                else:
                    blocked = tuple(l for l in links if i in l)
            else:
                blocked = ()
            c["blocked"] = blocked
            # Sticky disk pressure: a full disk stays full across ticks
            # with high probability, like the crash/block faults — the
            # durability bugs need the budget held across an AE round
            # trip, which per-tick sampling essentially never produces.
            if full is not None and r.random() < 0.70:
                pass                            # stays full
            elif bounds.max_disk and r.random() < 0.30:
                full = r.randrange(k)
            else:
                full = None
            if full is not None:
                c["disk"] = (full,)
            if r.random() < 0.45:
                c["pulse"] = (r.randrange(k),)
            if bounds.sessions and r.random() < 0.5:
                lead = [i for i, n in enumerate(uni.nodes)
                        if n.role == LEADER]
                if lead:
                    kind = "dup" if (uni.issued >= 0
                                     and r.random() < 0.5) else "new"
                    if bounds.admission and r.random() < 0.35:
                        kind = "shed"
                    c["propose"] = (r.choice(lead), kind)
            sched.append(c)
            try:
                viol = uni.tick(t, c)
            except AssertionError:
                viol = ["oracle_assertion"]
            if viol:
                if log:
                    log(f"hunt: hit {viol} at tick {t}, episode {ep}")
                return shrink_schedule(bounds, node_cls, sched), viol
    return None


def run_schedule(bounds: Bounds, node_cls, sched):
    """Run a fixed schedule from the initial state; returns (tick,
    predicates) of the first violation or None."""
    uni = Universe(bounds, node_cls)
    for t, c in enumerate(sched):
        try:
            viol = uni.tick(t, c)
        except AssertionError:
            viol = ["oracle_assertion"]
        if viol:
            return t, viol
    return None


def shrink_schedule(bounds: Bounds, node_cls, sched):
    """Greedy counterexample minimization (the nemesis searcher's
    auto-shrink, on scheduler traces): truncate to the violating tick,
    then try simplifying each tick's choice one field at a time toward
    the quiet choice (everyone alive, nothing blocked, no pulse, no
    propose), keeping a change only if SOME violation still occurs."""
    hit = run_schedule(bounds, node_cls, sched)
    assert hit is not None, "shrink called on a non-violating schedule"
    sched = list(sched[:hit[0] + 1])
    quiet = _quiet(bounds.k)
    for t in range(len(sched)):
        for field in ("alive", "blocked", "pulse", "disk", "propose"):
            if sched[t].get(field, quiet[field]) == quiet[field]:
                continue
            trial = [dict(c) for c in sched]
            trial[t][field] = quiet[field]
            if run_schedule(bounds, node_cls, trial) is not None:
                sched = trial
    hit = run_schedule(bounds, node_cls, sched)
    return list(sched[:hit[0] + 1])


# ------------------------------------------- nemesis-format reproducers


def _choice_json(c: dict) -> dict:
    return {"alive": list(c["alive"]),
            "blocked": [list(l) for l in c["blocked"]],
            "pulse": list(c["pulse"]),
            "disk": list(c.get("disk", ())),
            "propose": list(c.get("propose")) if c.get("propose") else None}


def reproducer(result: Result, bounds: Bounds,
               mutant: str = None) -> dict:
    """A model-checker counterexample as a nemesis-format artifact
    (nemesis/search.py ARTIFACT_SCHEMA): same schema/violation shape so
    the triage tooling reads it, with kind/engines marking it an oracle
    schedule and the explicit per-tick scheduler trace replacing the
    hashed nemesis program. `scripts/torch_nemesis_search.py --replay`
    dispatches on `kind` to `replay` below. `mutant` names the seeded
    mutant the schedule kills (verify/mutants.py) — None means the
    counterexample is against the REAL oracle step (which would be a
    genuine protocol bug, not a harness artifact)."""
    from raft_tpu_torch.nemesis import search as nsearch
    assert not result.ok and result.violation is not None
    v = result.violation
    cfg = bounds_config(bounds)
    return {
        "schema": nsearch.ARTIFACT_SCHEMA,
        "kind": ARTIFACT_KIND,
        "engines": ARTIFACT_ENGINES,
        "mutant": mutant,
        "config": {"k": cfg.k, "log_cap": cfg.log_cap,
                   "sessions": cfg.sessions, "prevote": cfg.prevote},
        "bounds": dataclasses.asdict(bounds),
        "program": None,
        "inject": None,
        "n_ticks": len(v["schedule"]),
        "n_groups": 1,
        "schedule": [_choice_json(c) for c in v["schedule"]],
        "violation": {"tick": v["tick"],
                      "leaf": "predicates." + v["predicates"][0],
                      "leaf_report": {k_: bool(ok)
                                      for k_, ok in v["report"].items()},
                      "boundary": None},
        "note": ("bounded model-checker counterexample: explicit "
                 "scheduler trace (alive/blocked/pulse/propose per "
                 "tick) on the CPU oracle at small scope"),
    }


def save_reproducer(art: dict, path: str):
    with open(path, "w") as f:
        json.dump(art, f, indent=2, sort_keys=True)


def load_reproducer(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"not an mcheck artifact: kind={art.get('kind')}")
    return art


def replay(art: dict, node_cls=None) -> dict:
    """Re-run an artifact's schedule on a fresh universe; returns the
    violation report and raises if the violation does not reproduce at
    the recorded tick (nsearch.verify_reproducer's contract). With
    `node_cls=None` the artifact's own `mutant` field picks the node
    class (the real oracle when it is None/absent)."""
    if node_cls is None:
        name = art.get("mutant")
        if name:
            from raft_tpu_torch.verify import mutants
            node_cls = mutants.by_name(name).node_cls
        else:
            node_cls = Node
    bounds = Bounds(**art["bounds"])
    uni = Universe(bounds, node_cls)
    for t, c in enumerate(art["schedule"]):
        choice = {"alive": tuple(c["alive"]),
                  "blocked": tuple(tuple(l) for l in c["blocked"]),
                  "pulse": tuple(c["pulse"]),
                  "disk": tuple(c.get("disk", ())),
                  "propose": (tuple(c["propose"])
                              if c.get("propose") else None)}
        try:
            viol = uni.tick(t, choice)
        except AssertionError:
            viol = ["oracle_assertion"]
        if viol:
            want = art["violation"]
            if t != want["tick"]:
                raise AssertionError(
                    f"violation moved: tick {t} != {want['tick']}")
            leaf = "predicates." + viol[0]
            if leaf != want["leaf"]:
                raise AssertionError(
                    f"violation leaf moved: {leaf} != {want['leaf']}")
            return {"tick": t, "predicates": viol}
    raise AssertionError("schedule replayed clean — violation did not "
                         "reproduce")


# ----------------------------------------------- narrow-width agreement


def narrow_agreement_problems(ticks: int = 2, max_states: int = 250,
                              sessions: bool = False) -> list[str]:
    """Walk the k=2 small-scope universe (depth `ticks`, up to
    `max_states` states) asserting `predicate_report()` and
    `predicate_report(narrow=True)` return IDENTICAL verdicts at every
    visited state — the proof that verify/invariants' predicates
    hold at the narrow-native widths (their `_signed` lifts work) over
    an exhaustive state space, not one example. Returns problem
    strings (empty = agreement everywhere); wired into `smoke` and the
    auditor's narrowing pass."""
    b = Bounds(k=2, ticks=ticks, max_states=max_states, sessions=sessions)
    uni = Universe(b)
    problems: list[str] = []
    seen = 0

    def walk(depth: int, t: int):
        nonlocal seen
        if problems or seen >= max_states:
            return
        seen += 1
        wide = uni.predicate_report()
        narrow = uni.predicate_report(narrow=True)
        if wide != narrow:
            diff = {k: (wide[k], narrow[k]) for k in wide
                    if wide[k] != narrow.get(k)}
            problems.append(
                f"narrow-width predicate disagreement at depth "
                f"{ticks - depth}: wide vs narrow {diff}")
            return
        if depth == 0:
            return
        frozen = uni.freeze()
        for choice in list(uni.choices()):
            uni.restore(frozen)
            try:
                uni.tick(t, choice)
            except AssertionError:
                continue   # pruned oracle path; agreement is the question
            walk(depth - 1, t + 1)
            if problems or seen >= max_states:
                break
        uni.restore(frozen)

    walk(ticks, 0)
    return problems


# ------------------------------------------------------------- the smoke


def smoke(ticks: int = 3, max_states: int = 1500) -> Result:
    """The depth-limited audit smoke (`analysis.audit_report(
    level="deep")`): the k=2 universe explored a few
    levels deep must verify clean, AND a canary mutant (the documented
    round-1 takeover bug) must be killed — proof the checker both
    passes the real step and still has teeth, in seconds."""
    b = Bounds(k=2, ticks=ticks, max_states=max_states)
    res = check(b)
    if not res.ok:
        return res
    # The shared predicates must report identically on wide and
    # narrow-native views over the explored scope.
    nw = narrow_agreement_problems(ticks=2, max_states=250)
    if nw:
        return Result(ok=False, states=res.states,
                      transitions=res.transitions, depth=res.depth,
                      complete=res.complete, pruned=res.pruned,
                      violation={"tick": -1,
                                 "predicates": ["narrow_disagreement"],
                                 "schedule": [],
                                 "report": {"narrow": nw[:4]}})
    from raft_tpu_torch.verify import mutants
    canary = mutants.by_name("minority_quorum")
    kill = check(Bounds(k=2, ticks=2, max_states=max_states,
                        max_pulses=2), node_cls=canary.node_cls)
    if kill.ok:
        return Result(ok=False, states=kill.states,
                      transitions=kill.transitions, depth=kill.depth,
                      complete=kill.complete, pruned=kill.pruned,
                      violation={"tick": -1,
                                 "predicates": ["mutant_survived"],
                                 "schedule": [],
                                 "report": {"canary": False}})
    return res
