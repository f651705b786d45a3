"""The batched Raft tick in plain PyTorch: the reference inside the port
for the CUDA fused-chunk kernel (sim/kernel.py), and the JAX package's
`sim/step.py` `tick` written over tensors.

Every handler runs over the whole `[G, K]` batch at once — one lane per
replica, the batch axes written out where the JAX package `vmap`s —
with the sender `src` a Python int, so the canonical (type, src) inbox
order of the tick contract (DESIGN.md §2) is the statically unrolled
6 x K chain of masked handler applications. Dynamic ring reads are
`gather`s; masked writes are `where`s.

Layouts: node leaves `[G, K]`, `[G, K, K]` (peer vectors), `[G, K, L]`
(rings); the mailbox `[G, dst, src]`. A handler for messages from
`src` reads the inbox column `mb[:, :, src]` (every receiver at once)
and writes its reply into the outbox row `out[:, src, :]` (the
receivers are the senders of the reply).

Faults (DESIGN.md §4) apply at the batch level: the delivery filter
masks occupancy bits, dead nodes' state is frozen wholesale and their
outbox erased (their in-flight mail survives), and the dead->alive edge
rewinds volatile state.

Narrow resident form (the `narrow_*` dials, sim/state.py `narrow_spec`):
`tick` widens the state on entry, runs the unchanged int32 tick
(`_tick_wide`) and narrows it on exit, latching an overflow.

The features here: RequestVote,
AppendEntries, InstallSnapshot, fire-hose commands, commit/apply/
compaction, crash/partition/drop faults, four protocol features and
scheduled client traffic, each gated statically on its config knob as
the JAX package gates it — PreVote (`prevote`), leadership transfer
(`transfer_prob`), single-server membership change (`reconfig_prob`),
scheduled ReadIndex reads (`read_every`) and exactly-once client
sessions (`cfg.clients_u32`: session appends in phase C, the dedup
filter at apply time, the tables in InstallSnapshot and restart, the
client transition after the tick) — and the nemesis program's seams,
each gated on its filtered subprogram (`cfg.nem_*`): link clauses in the
delivery filter, crash storms in the aliveness mask, skew in every
deadline draw, disk-full nodes' appends, compaction blocks in phase A.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.clients import workload
from raft_tpu_torch.config import (CONFIG_FLAG, SESSION_FLAG,
                                   SESSION_SEQ_MASK, SESSION_SEQ_SHIFT,
                                   SESSION_SID_MASK, SESSION_SID_SHIFT,
                                   RaftConfig)
from raft_tpu_torch.core.node import (CANDIDATE, FOLLOWER, LEADER, NO_VOTE,
                                      PRECANDIDATE)
from raft_tpu_torch.ops import quorum
from raft_tpu_torch.sim.state import (I32, Mailbox, PerNode, State,
                                      empty_mailbox, narrow_active,
                                      narrow_state, present_fields,
                                      widen_state)
from raft_tpu_torch.utils import trng

W = torch.where

# --------------------------------------------------------------- log helpers
# Ring addressing: absolute index i lives in slot (i - 1) % L (floor-mod:
# index 0 maps to slot L - 1, never to -1).


def _slot(cfg: RaftConfig, idx):
    return torch.remainder(idx - 1, cfg.log_cap)


def _lget(arr, idx):
    """arr[..., idx] over the trailing axis, per lane."""
    return torch.gather(arr, -1, idx.unsqueeze(-1).long()).squeeze(-1)


def _lset(arr, idx, cond, val):
    """Masked arr[..., idx] = val over the trailing axis."""
    lanes = torch.arange(arr.shape[-1], dtype=I32, device=arr.device)
    hit = (lanes == idx.unsqueeze(-1)) & cond.unsqueeze(-1)
    if isinstance(val, torch.Tensor):
        val = val.unsqueeze(-1)
    return W(hit, val, arr)


def _term_at(cfg, ns: PerNode, idx):
    """Term of absolute index idx; valid for snap_index <= idx <=
    last_index (callers mask the rest)."""
    return W(idx == ns.snap_index, ns.snap_term,
             _lget(ns.log_term, _slot(cfg, idx)))


def _payload_at(cfg, ns: PerNode, idx):
    return _lget(ns.log_payload, _slot(cfg, idx))


def _last_log_term(cfg, ns: PerNode):
    return _term_at(cfg, ns, ns.last_index)


def _put(out: dict, field: str, dst: int, cond, val):
    """Masked write of every node's outbox slot to `dst` (a slot may have
    trailing dims: `cond` broadcasts over them)."""
    a = out[field]
    cond = cond.reshape(cond.shape + (1,) * (a.dim() - 3))
    a[:, dst, :] = W(cond, val, a[:, dst, :])


def _abs_index(cfg, ns: PerNode):
    """i32[..., L]: the absolute index each live-window ring slot holds
    (slots beyond last_index are stale; callers mask)."""
    lanes = torch.arange(cfg.log_cap, dtype=I32, device=ns.snap_index.device)
    off = lanes - (ns.snap_index % cfg.log_cap).unsqueeze(-1)
    return ns.snap_index.unsqueeze(-1) + 1 + W(off >= 0, off,
                                               off + cfg.log_cap)


def _lanes(cfg, ref):
    return torch.arange(cfg.k, dtype=I32, device=ref.device)


# -------------------------------------------------------- membership config


def _config_scan(cfg, ns: PerNode, through=None):
    """(voters, cfg_index): the membership entry with the highest
    absolute index <= `through` (default: the whole log) in the live
    window, else the snapshot's config. Derived, never stored:
    truncation reverts membership. Callers gate on `cfg.reconfig_u32`:
    without the schedule no membership entry can enter a log."""
    absidx = _abs_index(cfg, ns)
    lim = ns.last_index if through is None else torch.minimum(
        ns.last_index, through)
    is_cfg = (((ns.log_payload & CONFIG_FLAG) != 0)
              & (absidx <= lim.unsqueeze(-1)))
    best = W(is_cfg, absidx, 0).amax(-1)   # 0 == none (indices are >= 1)
    found = best > 0
    mask_at = W(is_cfg & (absidx == best.unsqueeze(-1)), ns.log_payload,
                0).sum(-1, dtype=I32) & cfg.full_mask
    return W(found, mask_at, ns.snap_voters), W(found, best, ns.snap_index)


def _committed_voters(cfg, ns: PerNode, commit):
    if cfg.reconfig_u32 == 0:
        return cfg.full_mask
    return _config_scan(cfg, ns, commit)[0]


def _is_voter(voters, node):
    return ((voters >> node) & 1) == 1


def _vote_quorum(cfg, ns: PerNode, votes):
    """Granted votes from current-config voters reach that config's
    majority (the full set's, with reconfig off)."""
    if cfg.reconfig_u32 == 0:
        return quorum.vote_count(votes) >= cfg.majority
    voters, _ = _config_scan(cfg, ns)
    return quorum.vote_won(votes, voters, cfg.k)


# -------------------------------------------------------------- transitions


def _skewed(cfg, deadline, g, i, t):
    """A deadline drawn at tick t, shifted by the active skew clauses and
    clamped at 1 (unchanged without skew clauses)."""
    if not cfg.nem_skew:
        return deadline
    return torch.clamp(deadline + trng.nem_deadline_extra(
        cfg.seed, cfg.nem_skew, g, i, t), min=1)


def _disk_full(cfg, g, i, t):
    """[G, K]: the nodes whose appends fail at tick t (None without disk
    clauses)."""
    if not cfg.nem_disk:
        return None
    return trng.nem_disk_full(cfg.seed, cfg.nem_disk, g, i, t, cfg.k)


def _room(cfg, ns: PerNode, idx, df):
    """The window has room for index idx and the disk takes the append."""
    room = (idx - ns.snap_index) <= cfg.log_cap
    return room if df is None else room & ~df


def _reset_timer(cfg, ns: PerNode, g, i, cond, t):
    """One counted election-deadline draw, made at tick t."""
    deadline = _skewed(cfg, trng.election_deadline(
        cfg.seed, g, i, ns.rng_draws, cfg.election_min, cfg.election_range),
        g, i, t)
    return ns._replace(
        election_elapsed=W(cond, 0, ns.election_elapsed),
        deadline=W(cond, deadline, ns.deadline),
        rng_draws=ns.rng_draws + cond.to(I32),
    )


def _drop_reads(cfg, ns: PerNode, cond):
    """The pending scheduled read aborts and the ack evidence goes stale
    (reads off: nothing to drop)."""
    if not cfg.read_every:
        return ns
    return ns._replace(
        ack_time=W(cond.unsqueeze(-1), -1, ns.ack_time),
        sched_read_index=W(cond, -1, ns.sched_read_index),
    )


def _step_down(cfg, ns: PerNode, new_term, cond):
    """Adopt term, follower, no timer reset."""
    ns = ns._replace(
        term=W(cond, new_term, ns.term),
        role=W(cond, FOLLOWER, ns.role),
        voted_for=W(cond, NO_VOTE, ns.voted_for),
        leader_id=W(cond, NO_VOTE, ns.leader_id),
        votes=ns.votes & ~cond.unsqueeze(-1),
    )
    return _drop_reads(cfg, ns, cond)


def _become_leader(cfg, ns: PerNode, i, cond):
    """Leadership, including the takeover re-proposal (DESIGN.md §2a):
    the top uncommitted entry takes the new term in place."""
    ns = _drop_reads(cfg, ns, cond)
    c1 = cond.unsqueeze(-1)
    ns = ns._replace(
        role=W(cond, LEADER, ns.role),
        leader_id=W(cond, i, ns.leader_id),
        next_index=W(c1, (ns.last_index + 1).unsqueeze(-1), ns.next_index),
        match_index=W(c1, 0, ns.match_index),
        heartbeat_elapsed=W(cond, cfg.heartbeat_every, ns.heartbeat_elapsed),
    )
    top = cond & (ns.last_index > ns.commit)
    return ns._replace(log_term=_lset(ns.log_term, _slot(cfg, ns.last_index),
                                      top, ns.term))


def _accept_leader(cfg, ns: PerNode, g, i, src: int, cond, t):
    ns = ns._replace(
        role=W(cond, FOLLOWER, ns.role),
        leader_id=W(cond, src, ns.leader_id),
        votes=ns.votes & ~cond.unsqueeze(-1),
        leader_elapsed=W(cond, 0, ns.leader_elapsed),
    )
    return _reset_timer(cfg, ns, g, i, cond, t)


# ----------------------------------------------------------------- phase D


def _on_rv_req(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    present = ib.rv_req_present[:, :, src]
    m_term = ib.rv_req_term[:, :, src]
    m_lli = ib.rv_req_lli[:, :, src]
    m_llt = ib.rv_req_llt[:, :, src]
    ns = _step_down(cfg, ns, m_term, present & (m_term > ns.term))
    llt = _last_log_term(cfg, ns)
    log_ok = (m_llt > llt) | ((m_llt == llt) & (m_lli >= ns.last_index))
    grant = (present & (m_term == ns.term)
             & ((ns.voted_for == NO_VOTE) | (ns.voted_for == src))
             & log_ok)
    ns = ns._replace(voted_for=W(grant, src, ns.voted_for))
    ns = _reset_timer(cfg, ns, g, i, grant, gl[2])
    _put(out, "rv_resp_present", src, present, True)
    _put(out, "rv_resp_term", src, present, ns.term)
    _put(out, "rv_resp_granted", src, present, grant)
    return ns


def _on_rv_resp(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    present = ib.rv_resp_present[:, :, src]
    m_term = ib.rv_resp_term[:, :, src]
    m_granted = ib.rv_resp_granted[:, :, src]
    higher = present & (m_term > ns.term)
    ns = _step_down(cfg, ns, m_term, higher)
    cont = (present & ~higher & (ns.role == CANDIDATE)
            & (m_term == ns.term) & m_granted)
    votes = ns.votes.clone()
    votes[..., src] |= cont
    ns = ns._replace(votes=votes)
    won = cont & _vote_quorum(cfg, ns, votes)
    return _become_leader(cfg, ns, i, won)


def _on_ae_req(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    """The log-matching workhorse. Entries are pulled from the sender's
    ring as of the end of the previous tick (`gl`: the group's [G, K, L]
    rings, and the tick): the range (prev, prev + n] cannot change
    between the send and this delivery. Reads of the receiver's own ring
    see this tick's earlier handlers' writes (sequential delivery)."""
    glog_t, glog_p, _ = gl
    present = ib.ae_req_present[:, :, src]
    m_term = ib.ae_req_term[:, :, src]
    m_prev = ib.ae_req_prev_index[:, :, src]
    m_prev_term = ib.ae_req_prev_term[:, :, src]
    m_n = ib.ae_req_n[:, :, src]
    m_commit = ib.ae_req_commit[:, :, src]
    E = cfg.max_entries_per_msg
    ent_t = [_lget(glog_t[:, src:src + 1, :].expand_as(glog_t),
                   _slot(cfg, m_prev + 1 + j)) for j in range(E)]
    ent_p = [_lget(glog_p[:, src:src + 1, :].expand_as(glog_p),
                   _slot(cfg, m_prev + 1 + j)) for j in range(E)]

    ns = _step_down(cfg, ns, m_term, present & (m_term > ns.term))
    stale = present & (m_term < ns.term)
    ok = present & ~stale
    ns = _accept_leader(cfg, ns, g, i, src, ok, gl[2])

    past = ok & (m_prev > ns.last_index)
    conflict = (ok & ~past & (m_prev >= ns.snap_index)
                & (_term_at(cfg, ns, m_prev) != m_prev_term))
    # Fast backup to the first index of the conflicting term: one past
    # the highest in-window index below m_prev whose term differs.
    ct = _term_at(cfg, ns, m_prev)
    absidx = _abs_index(cfg, ns)
    snap1 = ns.snap_index.unsqueeze(-1)
    bad = ((absidx > snap1) & (absidx < m_prev.unsqueeze(-1))
           & (ns.log_term != ct.unsqueeze(-1)))
    ci = torch.minimum(W(bad, absidx, snap1).amax(-1) + 1, m_prev)

    proceed = ok & ~past & ~conflict
    # A disk-full node's appends fail, so `hi` (the match reply and the
    # commit clamp) stops at the durable prefix; matching entries, term
    # rewrites in place and the truncation of a divergent suffix go on.
    df = _disk_full(cfg, g, i, gl[2])
    # Entry walk, decide then write: the E entries address E consecutive
    # indices, pairwise distinct ring slots, so within one message no
    # write feeds a later read.
    j0 = torch.clamp(ns.snap_index - m_prev, min=0)
    hi = m_prev + j0
    last_index = ns.last_index
    stopped = torch.zeros_like(present)
    write_t, write_p, slots = [], [], []
    for j in range(E):
        idx = m_prev + 1 + j
        act = proceed & (j0 <= j) & (m_n > j) & ~stopped
        s = _slot(cfg, idx)
        slots.append(s)
        in_log = act & (idx <= last_index)
        same_t = in_log & (_lget(ns.log_term, s) == ent_t[j])
        same_p = in_log & ~same_t & (_lget(ns.log_payload, s) == ent_p[j])
        diverge = in_log & ~same_t & ~same_p   # truncate, then append
        need_append = (act & ~in_log) | diverge
        room = _room(cfg, ns, idx, df)
        do_append = need_append & room
        write_t.append(same_p | do_append)
        write_p.append(do_append)
        last_index = W(do_append, idx,
                       W(diverge & ~room, idx - 1, last_index))
        stopped = stopped | (need_append & ~room)
        hi = W(same_t | same_p | do_append, idx, hi)
    log_term, log_payload = ns.log_term, ns.log_payload
    for j in range(E):
        log_term = _lset(log_term, slots[j], write_t[j], ent_t[j])
        log_payload = _lset(log_payload, slots[j], write_p[j], ent_p[j])

    commit = W(proceed & (m_commit > ns.commit),
               torch.maximum(ns.commit, torch.minimum(m_commit, hi)),
               ns.commit)
    ns = ns._replace(log_term=log_term, log_payload=log_payload,
                     last_index=last_index, commit=commit)
    match = W(past, last_index + 1, W(conflict, ci, W(proceed, hi, 0)))
    _put(out, "ae_resp_present", src, present, True)
    _put(out, "ae_resp_term", src, present, ns.term)
    _put(out, "ae_resp_success", src, present, proceed)
    _put(out, "ae_resp_match", src, present, match)
    return ns


def _set_peer(vec, src: int, val):
    vec = vec.clone()
    vec[..., src] = val
    return vec


def _stamp_ack(cfg, ns, src: int, cont, t):
    """Any current-term response is ReadIndex deference evidence: stamp
    its arrival tick, success or not."""
    if not cfg.read_every:
        return ns
    return ns._replace(ack_time=_set_peer(
        ns.ack_time, src, W(cont, t, ns.ack_time[..., src])))


def _on_ae_resp(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    present = ib.ae_resp_present[:, :, src]
    m_term = ib.ae_resp_term[:, :, src]
    m_success = ib.ae_resp_success[:, :, src]
    m_match = ib.ae_resp_match[:, :, src]
    higher = present & (m_term > ns.term)
    ns = _step_down(cfg, ns, m_term, higher)
    cont = present & ~higher & (ns.role == LEADER) & (m_term == ns.term)
    ns = _stamp_ack(cfg, ns, src, cont, gl[2])
    succ = cont & m_success
    fail = cont & ~m_success
    mi = ns.match_index[..., src]
    ni = ns.next_index[..., src]
    new_match = torch.maximum(mi, m_match)
    back = torch.clamp(torch.minimum(ni - 1, m_match), min=1)
    return ns._replace(
        match_index=_set_peer(ns.match_index, src, W(succ, new_match, mi)),
        next_index=_set_peer(ns.next_index, src,
                             W(succ, new_match + 1, W(fail, back, ni))))


def _on_is_req(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    present = ib.is_req_present[:, :, src]
    m_term = ib.is_req_term[:, :, src]
    m_si = ib.is_req_snap_index[:, :, src]
    m_st = ib.is_req_snap_term[:, :, src]
    m_sd = ib.is_req_snap_digest[:, :, src]
    m_sv = ib.is_req_snap_voters[:, :, src]
    ns = _step_down(cfg, ns, m_term, present & (m_term > ns.term))
    stale = present & (m_term < ns.term)
    ok = present & ~stale
    ns = _accept_leader(cfg, ns, g, i, src, ok, gl[2])
    have = ok & (m_si <= ns.commit)   # already covered
    inst = ok & ~have
    # Keep the suffix when it matches: in the ring model last_index is
    # simply left alone (slots are absolute).
    keep = (inst & (m_si <= ns.last_index) & (m_si >= ns.snap_index)
            & (_term_at(cfg, ns, torch.maximum(m_si, ns.snap_index)) == m_st))
    ns = ns._replace(
        last_index=W(inst, W(keep, ns.last_index, m_si), ns.last_index),
        snap_index=W(inst, m_si, ns.snap_index),
        snap_term=W(inst, m_st, ns.snap_term),
        snap_digest=W(inst, m_sd, ns.snap_digest),
        snap_voters=W(inst, m_sv, ns.snap_voters),
        commit=W(inst, m_si, ns.commit),
        applied=W(inst, m_si, ns.applied),
        digest=W(inst, m_sd, ns.digest),
    )
    if cfg.clients_u32:
        # The snapshot's dedup table installs into both tables.
        m_sess = ib.is_req_snap_sessions[:, :, src]
        i1 = inst.unsqueeze(-1)
        ns = ns._replace(session_seq=W(i1, m_sess, ns.session_seq),
                         snap_session_seq=W(i1, m_sess, ns.snap_session_seq))
    match = W(stale, 0, W(have, ns.commit, m_si))
    _put(out, "is_resp_present", src, present, True)
    _put(out, "is_resp_term", src, present, ns.term)
    _put(out, "is_resp_match", src, present, match)
    return ns


def _on_is_resp(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    present = ib.is_resp_present[:, :, src]
    m_term = ib.is_resp_term[:, :, src]
    m_match = ib.is_resp_match[:, :, src]
    higher = present & (m_term > ns.term)
    ns = _step_down(cfg, ns, m_term, higher)
    cont = present & ~higher & (ns.role == LEADER) & (m_term == ns.term)
    ns = _stamp_ack(cfg, ns, src, cont, gl[2])
    mi = ns.match_index[..., src]
    new_match = torch.maximum(mi, m_match)
    return ns._replace(
        match_index=_set_peer(ns.match_index, src, W(cont, new_match, mi)),
        next_index=_set_peer(ns.next_index, src,
                             W(cont, new_match + 1, ns.next_index[..., src])))


def _start_election_masked(cfg, ns, out, g, i, cond, t):
    """Term bump, candidacy, fresh timer draw, instant single-voter win,
    RequestVote broadcast. Shared by phase T, the pre-vote quorum and
    TimeoutNow (both in phase D)."""
    ns = ns._replace(
        term=W(cond, ns.term + 1, ns.term),
        role=W(cond, CANDIDATE, ns.role),
        voted_for=W(cond, i, ns.voted_for),
        leader_id=W(cond, NO_VOTE, ns.leader_id),
        votes=W(cond.unsqueeze(-1), _lanes(cfg, cond) == i.unsqueeze(-1),
                ns.votes),
    )
    ns = _reset_timer(cfg, ns, g, i, cond, t)
    won = cond & _vote_quorum(cfg, ns, ns.votes)
    ns = _become_leader(cfg, ns, i, won)
    llt = _last_log_term(cfg, ns)
    for p in range(cfg.k):
        send = cond & ~won & (i != p)
        _put(out, "rv_req_present", p, send, True)
        _put(out, "rv_req_term", p, send, ns.term)
        _put(out, "rv_req_lli", p, send, ns.last_index)
        _put(out, "rv_req_llt", p, send, llt)
    return ns


def _on_pv_req(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    """Non-binding pre-vote grant: proposed term ahead, log up to date,
    not the leader, lease expired. No term adoption, no voted_for, no
    timer reset."""
    present = ib.pv_req_present[:, :, src]
    m_term = ib.pv_req_term[:, :, src]
    m_lli = ib.pv_req_lli[:, :, src]
    m_llt = ib.pv_req_llt[:, :, src]
    llt = _last_log_term(cfg, ns)
    log_ok = (m_llt > llt) | ((m_llt == llt) & (m_lli >= ns.last_index))
    grant = (present & (m_term > ns.term) & log_ok & (ns.role != LEADER)
             & (ns.leader_elapsed >= cfg.election_min))
    _put(out, "pv_resp_present", src, present, True)
    _put(out, "pv_resp_term", src, present, ns.term)
    _put(out, "pv_resp_req_term", src, present, m_term)
    _put(out, "pv_resp_granted", src, present, grant)
    return ns


def _on_pv_resp(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    """Tally pre-votes; a quorum starts the real election (term bump and
    RequestVote broadcast) right here in phase D."""
    present = ib.pv_resp_present[:, :, src]
    m_term = ib.pv_resp_term[:, :, src]
    m_req = ib.pv_resp_req_term[:, :, src]
    m_granted = ib.pv_resp_granted[:, :, src]
    higher = present & (m_term > ns.term)
    ns = _step_down(cfg, ns, m_term, higher)
    cont = (present & ~higher & (ns.role == PRECANDIDATE)
            & (m_req == ns.term + 1) & m_granted)
    votes = ns.votes.clone()
    votes[..., src] |= cont
    ns = ns._replace(votes=votes)
    won_pre = cont & _vote_quorum(cfg, ns, votes)
    return _start_election_masked(cfg, ns, out, g, i, won_pre, gl[2])


def _on_tn_req(cfg, ns, out, g, i, src: int, ib: Mailbox, gl):
    """TimeoutNow: campaign at once, bypassing PreVote. Followers and
    pre-candidates only: a candidate already campaigned (perhaps this
    very tick, on a pre-vote quorum), and a second start would write the
    RequestVote slots twice."""
    present = ib.tn_present[:, :, src]
    m_term = ib.tn_term[:, :, src]
    ns = _step_down(cfg, ns, m_term, present & (m_term > ns.term))
    cond = (present & (m_term == ns.term)
            & (ns.role != LEADER) & (ns.role != CANDIDATE))
    if cfg.reconfig_u32:
        cond = cond & _is_voter(_config_scan(cfg, ns)[0], i)
    return _start_election_masked(cfg, ns, out, g, i, cond, gl[2])


def _handlers(cfg):
    """The handlers in canonical rpc type order (PreVote and TimeoutNow
    last), those of features that are off left out."""
    return ((_on_rv_req, _on_rv_resp, _on_ae_req, _on_ae_resp, _on_is_req,
             _on_is_resp)
            + ((_on_pv_req, _on_pv_resp) if cfg.prevote else ())
            + ((_on_tn_req,) if cfg.transfer_u32 else ()))


# ----------------------------------------------------------------- phase T


def _phase_t(cfg, ns, out, g, i, t: int):
    """Heartbeat/replication broadcast, the scheduled leadership
    transfer, then the election timeout (through PreVote when on). `t`
    is the absolute tick (the transfer schedule hashes it)."""
    is_leader = ns.role == LEADER
    hb = ns.heartbeat_elapsed + 1
    fire = is_leader & (hb >= cfg.heartbeat_every)
    ns = ns._replace(heartbeat_elapsed=W(is_leader, W(fire, 0, hb),
                                         ns.heartbeat_elapsed))
    for p in range(cfg.k):
        cond = fire & (i != p)
        nip = ns.next_index[..., p]
        use_is = cond & (nip <= ns.snap_index)
        use_ae = cond & (nip > ns.snap_index)
        _put(out, "is_req_present", p, use_is, True)
        _put(out, "is_req_term", p, use_is, ns.term)
        _put(out, "is_req_snap_index", p, use_is, ns.snap_index)
        _put(out, "is_req_snap_term", p, use_is, ns.snap_term)
        _put(out, "is_req_snap_digest", p, use_is, ns.snap_digest)
        _put(out, "is_req_snap_voters", p, use_is, ns.snap_voters)
        if cfg.clients_u32:
            _put(out, "is_req_snap_sessions", p, use_is,
                 ns.snap_session_seq)
        # No entries ride the message: the receiver pulls (prev,
        # prev + n] from this sender's ring at delivery.
        prev = nip - 1
        n = torch.clamp(ns.last_index - prev, max=cfg.max_entries_per_msg)
        _put(out, "ae_req_present", p, use_ae, True)
        _put(out, "ae_req_term", p, use_ae, ns.term)
        _put(out, "ae_req_prev_index", p, use_ae, prev)
        _put(out, "ae_req_prev_term", p, use_ae, _term_at(cfg, ns, prev))
        _put(out, "ae_req_n", p, use_ae, n)
        _put(out, "ae_req_commit", p, use_ae, ns.commit)

    if cfg.transfer_u32 and t % cfg.transfer_epoch == 0:
        # First tick of a firing epoch: TimeoutNow to a hash-chosen
        # target that is a current-config voter holding every committed
        # entry and as caught up as any peer (the leader's own match slot
        # is always 0).
        epoch = t // cfg.transfer_epoch
        attempts = is_leader & trng.transfer_fires(cfg.seed, g, epoch,
                                                   cfg.transfer_u32)
        target = trng.transfer_target(cfg.seed, g, epoch, cfg.k)
        mt = _lget(ns.match_index, target)
        caught_up = (mt >= ns.commit) & (mt == ns.match_index.amax(-1))
        ok = attempts & caught_up & (target != i)
        if cfg.reconfig_u32:
            ok = ok & _is_voter(_config_scan(cfg, ns)[0], target)
        for p in range(cfg.k):
            send = ok & (target == p)
            _put(out, "tn_present", p, send, True)
            _put(out, "tn_term", p, send, ns.term)

    # Election timeout: non-leaders that are current-config voters. The
    # PreVote lease clock: leaders zero it, everyone else counts up.
    ee = ns.election_elapsed + 1
    timeout = ~is_leader & (ee >= ns.deadline)
    if cfg.reconfig_u32:
        timeout = timeout & _is_voter(_config_scan(cfg, ns)[0], i)
    ns = ns._replace(
        election_elapsed=W(is_leader, ns.election_elapsed, ee),
        leader_elapsed=W(is_leader, 0, ns.leader_elapsed + 1))
    if not cfg.prevote:
        return _start_election_masked(cfg, ns, out, g, i, timeout, t)
    # Pre-candidacy, no term bump; a config where one vote is a quorum
    # skips straight to the real election (with its second deadline
    # draw).
    ns = ns._replace(
        role=W(timeout, PRECANDIDATE, ns.role),
        leader_id=W(timeout, NO_VOTE, ns.leader_id),
        votes=W(timeout.unsqueeze(-1), _lanes(cfg, i) == i.unsqueeze(-1),
                ns.votes),
    )
    ns = _reset_timer(cfg, ns, g, i, timeout, t)
    skip = timeout & _vote_quorum(cfg, ns, ns.votes)
    ns = _start_election_masked(cfg, ns, out, g, i, skip, t)
    llt = _last_log_term(cfg, ns)
    for p in range(cfg.k):
        send = timeout & ~skip & (i != p)
        _put(out, "pv_req_present", p, send, True)
        _put(out, "pv_req_term", p, send, ns.term + 1)
        _put(out, "pv_req_lli", p, send, ns.last_index)
        _put(out, "pv_req_llt", p, send, llt)
    return ns


# ----------------------------------------------------------------- phase C


def _phase_c(cfg, ns, g, i, t: int, csub=None, cpay=None):
    """Scheduled read registration, the scheduled membership proposal,
    the pulsed client session ops (`csub`/`cpay`, `[G, S]`, raised by the
    previous tick's client transition; None with clients off), then
    fire-hose command appends, by every node that believes itself
    leader, stopping at a full window. A disk-full leader appends
    nothing."""
    lead = ns.role == LEADER
    df = _disk_full(cfg, g, i, t)
    if cfg.read_every and t % cfg.read_every == 0:
        # ReadIndex at the start of phase C: the read point is the
        # pre-append commit index, registered once the leader has
        # committed an entry of its own term (or holds nothing past it).
        gate = ((ns.commit == ns.last_index)
                | (_term_at(cfg, ns, ns.commit) == ns.term))
        reg = lead & (ns.sched_read_index < 0) & gate
        ns = ns._replace(
            sched_read_index=W(reg, ns.commit, ns.sched_read_index),
            sched_read_reg=W(reg, t, ns.sched_read_reg))
    if cfg.reconfig_u32 and t % cfg.reconfig_epoch == 0:
        # First tick of a firing epoch: toggle one hash-chosen node's
        # membership, once the last config entry is committed, the
        # leader has committed in its term and enough voters remain.
        epoch = t // cfg.reconfig_epoch
        fires = trng.reconfig_fires(cfg.seed, g, epoch, cfg.reconfig_u32)
        target = trng.reconfig_target(cfg.seed, g, epoch, cfg.k)
        voters, cfg_index = _config_scan(cfg, ns)
        new_mask = voters ^ torch.bitwise_left_shift(
            torch.ones_like(target), target)
        gate = ((quorum.popcount(new_mask) >= cfg.effective_min_voters)
                & (cfg_index <= ns.commit)
                & (_term_at(cfg, ns, ns.commit) == ns.term))
        idx = ns.last_index + 1
        room = _room(cfg, ns, idx, df)
        do = lead & fires & gate & room
        s = _slot(cfg, idx)
        ns = ns._replace(
            log_term=_lset(ns.log_term, s, do, ns.term),
            log_payload=_lset(ns.log_payload, s, do, CONFIG_FLAG | new_mask),
            last_index=W(do, idx, ns.last_index))
    last_index = ns.last_index
    log_term, log_payload = ns.log_term, ns.log_payload
    stopped = torch.zeros_like(lead)
    if cfg.clients_u32:
        # The pulsed session ops in slot order; duplicates appended by two
        # transient leaders are safe by the exactly-once fold.
        for sl in range(cfg.client_slots):
            idx = last_index + 1
            room = _room(cfg, ns, idx, df)
            want = lead & (csub[:, sl:sl + 1] != 0)
            do = want & room & ~stopped
            s = _slot(cfg, idx)
            log_term = _lset(log_term, s, do, ns.term)
            log_payload = _lset(log_payload, s, do,
                                cpay[:, sl:sl + 1].expand_as(last_index))
            last_index = W(do, idx, last_index)
            stopped = stopped | (want & ~room)
    for _ in range(cfg.cmds_per_tick):
        idx = last_index + 1
        room = _room(cfg, ns, idx, df)
        do = lead & room & ~stopped
        payload = trng.client_payload(cfg.seed, g, ns.term, idx)
        s = _slot(cfg, idx)
        log_term = _lset(log_term, s, do, ns.term)
        log_payload = _lset(log_payload, s, do, payload)
        last_index = W(do, idx, last_index)
        stopped = stopped | (lead & ~room)
    return ns._replace(last_index=last_index, log_term=log_term,
                       log_payload=log_payload)


# ----------------------------------------------------------------- phase A


def _phase_a(cfg, ns, g, i, t: int):
    """Voters-aware commit advance, removed-leader step-down, apply (the
    digest chain), compaction (unless a compaction clause blocks it),
    scheduled-read completion."""
    if cfg.reconfig_u32 == 0:
        n = quorum.commit_candidate(ns.match_index, ns.last_index, i,
                                    cfg.k, cfg.majority)
    else:
        voters, cfg_index = _config_scan(cfg, ns)
        n = quorum.commit_candidate_voters(ns.match_index, ns.last_index,
                                           i, voters, cfg.k)
    # Current-term entries only; n > commit >= snap_index makes the
    # term read valid under the mask (n == -1 without voters fails it).
    advance = ((ns.role == LEADER) & (n > ns.commit)
               & (_term_at(cfg, ns, n) == ns.term))
    commit = W(advance, n, ns.commit)

    if cfg.reconfig_u32:
        # A removed leader steps down once its removal is committed.
        demote = ((ns.role == LEADER) & (cfg_index <= commit)
                  & ~_is_voter(voters, i))
        ns = ns._replace(
            role=W(demote, FOLLOWER, ns.role),
            leader_id=W(demote, NO_VOTE, ns.leader_id),
            votes=ns.votes & ~demote.unsqueeze(-1))
        ns = _drop_reads(cfg, ns, demote)

    # Apply: commit - applied <= L by the window invariant. Steps past
    # the batch's largest gap are no-ops, so the loop stops there. With
    # clients on, the exactly-once filter runs at fold time: a session
    # command folds, and advances its sid's table entry, only if its seq
    # is above the entry and its sid is one of the S pre-registered ones.
    applied, digest = ns.applied, ns.digest
    table = ns.session_seq
    # sync-ok: the plain tick runs its apply loop to the fleet's largest
    # commit gap (the kernel loops per group, on the card)
    steps = int((commit - applied).amax().clamp(0, cfg.log_cap))  # sync-ok
    for _ in range(steps):
        idx = applied + 1
        act = idx <= commit
        p = _payload_at(cfg, ns, idx)
        fold = act
        if cfg.clients_u32:
            is_sess = ((p & SESSION_FLAG) != 0) & ((p & CONFIG_FLAG) == 0)
            sid = (p >> SESSION_SID_SHIFT) & SESSION_SID_MASK
            seq = (p >> SESSION_SEQ_SHIFT) & SESSION_SEQ_MASK
            known = sid < cfg.client_slots
            cur = _lget(table, torch.where(known, sid, 0))
            eff = is_sess & known & (seq > cur)
            table = _lset(table, sid, act & eff, seq)
            fold = act & (~is_sess | eff)
        digest = W(fold, trng.digest_update(digest, idx, p), digest)
        applied = W(act, idx, applied)

    compact = (commit - ns.snap_index) >= cfg.compact_every
    if cfg.nem_compact:
        compact = compact & ~trng.nem_compact_block(
            cfg.seed, cfg.nem_compact, g, i, t)
    if cfg.clients_u32:
        # Compaction folds the live table into the snapshot's.
        ns = ns._replace(session_seq=table, snap_session_seq=W(
            compact.unsqueeze(-1), table, ns.snap_session_seq))
    ns = ns._replace(
        commit=commit, applied=applied, digest=digest,
        snap_term=W(compact, _term_at(cfg, ns, commit), ns.snap_term),
        snap_voters=W(compact, _committed_voters(cfg, ns, commit),
                      ns.snap_voters),
        snap_index=W(compact, commit, ns.snap_index),
        snap_digest=W(compact, digest, ns.snap_digest),
    )
    if not cfg.read_every:
        return ns
    # Scheduled-read completion: a current-config voter majority (self
    # included when a voter) acked at ticks >= reg + 2, and the state
    # machine has applied through the read point.
    lanes = _lanes(cfg, i)
    recent = ns.ack_time >= (ns.sched_read_reg + 2).unsqueeze(-1)
    if cfg.reconfig_u32 == 0:
        voter_lane = torch.ones_like(recent)
        self_voter, maj = 1, cfg.majority
    else:
        voters2, _ = _config_scan(cfg, ns)
        voter_lane = quorum.voter_bits(voters2, cfg.k)
        self_voter = (voters2 >> i) & 1
        maj = quorum.voter_majority(voters2)
    acks = (recent & voter_lane & (lanes != i.unsqueeze(-1))).to(I32).sum(
        -1, dtype=I32)
    done = ((ns.sched_read_index >= 0) & (acks + self_voter >= maj)
            & (ns.applied >= ns.sched_read_index))
    return ns._replace(
        reads_done=ns.reads_done + done.to(I32),
        sched_read_index=W(done, -1, ns.sched_read_index))


# ------------------------------------------------------------ per-node tick


def _node_tick(cfg, nodes: PerNode, inbox: Mailbox, g, i, t: int,
               csub=None, cpay=None):
    """Every replica's phases D/T/C/A at once. Returns the new nodes and
    the outbox ([G, dst, src])."""
    gsz, k = nodes.role.shape
    out = empty_mailbox(cfg, (gsz, k, k), nodes.role.device)._asdict()
    # Phase-D context: the end-of-previous-tick rings and the clock.
    gl = (nodes.log_term, nodes.log_payload, t)
    ns = nodes
    for handler in _handlers(cfg):
        for src in range(cfg.k):
            ns = handler(cfg, ns, out, g, i, src, inbox, gl)
    ns = _phase_t(cfg, ns, out, g, i, t)
    ns = _phase_c(cfg, ns, g, i, t, csub, cpay)
    ns = _phase_a(cfg, ns, g, i, t)
    return ns, Mailbox(**out)


# ------------------------------------------------------------- global tick


def _apply_restart(cfg, nodes: PerNode, g_grid, i_grid, edge, t: int):
    """Restart: durable state survives, volatile state rewinds."""
    new_deadline = _skewed(cfg, trng.election_deadline(
        cfg.seed, g_grid, i_grid, nodes.rng_draws, cfg.election_min,
        cfg.election_range), g_grid, i_grid, t)
    e1 = edge.unsqueeze(-1)
    return nodes._replace(
        role=W(edge, FOLLOWER, nodes.role),
        leader_id=W(edge, NO_VOTE, nodes.leader_id),
        commit=W(edge, nodes.snap_index, nodes.commit),
        applied=W(edge, nodes.snap_index, nodes.applied),
        digest=W(edge, nodes.snap_digest, nodes.digest),
        votes=nodes.votes & ~e1,
        next_index=W(e1, 1, nodes.next_index),
        match_index=W(e1, 0, nodes.match_index),
        heartbeat_elapsed=W(edge, 0, nodes.heartbeat_elapsed),
        election_elapsed=W(edge, 0, nodes.election_elapsed),
        leader_elapsed=W(edge, 0, nodes.leader_elapsed),
        deadline=W(edge, new_deadline, nodes.deadline),
        rng_draws=nodes.rng_draws + edge.to(I32),
        ack_time=W(e1, -1, nodes.ack_time),
        sched_read_index=W(edge, -1, nodes.sched_read_index),
        reads_done=W(edge, 0, nodes.reads_done),
        # The live dedup table is state-machine state: it rewinds to the
        # snapshot's, like the digest.
        session_seq=(W(e1, nodes.snap_session_seq, nodes.session_seq)
                     if cfg.clients_u32 else nodes.session_seq),
    )


def _filter_mailbox(cfg, mb: Mailbox, t, alive_now, group_id) -> Mailbox:
    """Delivery filter: dead destinations, partitioned links, dropped
    links. Layout [G, dst, src]."""
    k = alive_now.shape[1]
    dev = alive_now.device
    gg = group_id[:, None, None]
    dst = torch.arange(k, dtype=I32, device=dev)[None, :, None]
    src = torch.arange(k, dtype=I32, device=dev)[None, None, :]
    part = trng.link_partitioned(cfg.seed, gg, t, src, dst,
                                 cfg.partition_u32, cfg.partition_epoch)
    drop = trng.link_dropped(cfg.seed, gg, t, src, dst, cfg.drop_u32)
    keep = alive_now[:, :, None] & ~part & ~drop
    if cfg.nem_link:
        keep = keep & trng.nem_link_ok(cfg.seed, cfg.nem_link, gg, t, src,
                                       dst, cfg.k)
    return mb._replace(**{f: getattr(mb, f) & keep
                          for f in present_fields(cfg)})


def tick(cfg: RaftConfig, st: State, t: int) -> State:
    """One global tick over all [G, K] replicas. `t` is the absolute
    tick (the fault schedules hash it). A narrow resident state is
    widened on entry and narrowed on exit (the latch records an
    overflow); the tick itself always computes at int32."""
    if not narrow_active(cfg):
        return _tick_wide(cfg, st, t)
    return narrow_state(cfg, _tick_wide(cfg, widen_state(cfg, st), t))


def _tick_wide(cfg: RaftConfig, st: State, t: int) -> State:
    """The int32 tick body."""
    g, k = st.alive_prev.shape
    dev = st.alive_prev.device
    g_grid = st.group_id[:, None].expand(g, k)
    i_grid = torch.arange(k, dtype=I32, device=dev)[None, :].expand(g, k)
    alive_now = trng.node_alive(cfg.seed, g_grid, i_grid, t, cfg.crash_u32,
                                cfg.crash_epoch).expand(g, k)
    if cfg.nem_crash:
        # Crash storms AND into the base schedule, before the restart edge.
        alive_now = alive_now & trng.nem_alive(cfg.seed, cfg.nem_crash,
                                               g_grid, i_grid, t)
    nodes = _apply_restart(cfg, st.nodes, g_grid, i_grid,
                           alive_now & ~st.alive_prev, t)
    inbox = _filter_mailbox(cfg, st.mailbox, t, alive_now, st.group_id)
    csub = cpay = None
    if cfg.clients_u32:
        # The pulses raised by the previous tick's client transition, with
        # their payloads ([G, S]), broadcast to every node of the group.
        scol = torch.arange(cfg.client_slots, dtype=I32, device=dev)[None, :]
        csub, cpay = workload.submit_payloads(cfg, st.clients,
                                              st.group_id[:, None], scol)
    new_nodes, outbox = _node_tick(cfg, nodes, inbox, g_grid, i_grid, t,
                                   csub, cpay)

    # Dead nodes: state frozen, sends erased; their in-flight mail stays.
    def freeze(new, old):
        if new is None:
            return None
        m = alive_now.reshape(alive_now.shape + (1,) * (new.dim() - 2))
        return W(m, new, old)

    new_nodes = PerNode(*(freeze(a, b) for a, b in zip(new_nodes, nodes)))
    src_alive = alive_now[:, None, :]   # sender axis is 2 in [G, dst, src]
    outbox = outbox._replace(**{f: getattr(outbox, f) & src_alive
                                for f in present_fields(cfg)})
    clients = st.clients
    if cfg.clients_u32:
        # The client transition on the post-tick (post-freeze) state: acks
        # come from the group's applied dedup tables.
        clients = workload.client_update(
            cfg, clients, workload.table_max(new_nodes.session_seq, 1),
            st.group_id[:, None],
            torch.arange(cfg.client_slots, dtype=I32, device=dev)[None, :],
            t)
    return State(nodes=new_nodes, mailbox=outbox,
                 alive_prev=alive_now.contiguous(), group_id=st.group_id,
                 clients=clients)

