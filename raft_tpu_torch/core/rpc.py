"""Raft RPC message types and the canonical per-tick processing order.

At most one message of each (type, src, dst) exists per tick by
construction (DESIGN.md §2), so the canonical inbox order — type first,
then sender id — fully determinizes phase D.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

# Canonical type order for phase D. The batched tick unrolls its handler loop in
# exactly this order. Pre-vote types come last so that enabling
# `cfg.prevote` leaves the processing order of the original six
# unchanged (prevote-off traces are bit-identical to older builds).
(RV_REQ, RV_RESP, AE_REQ, AE_RESP, IS_REQ, IS_RESP, PV_REQ, PV_RESP,
 TN_REQ) = range(9)


@dataclasses.dataclass(frozen=True)
class Msg:
    type: int
    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class RequestVoteReq(Msg):
    term: int = 0
    last_log_index: int = 0
    last_log_term: int = 0


@dataclasses.dataclass(frozen=True)
class RequestVoteResp(Msg):
    term: int = 0
    granted: bool = False


@dataclasses.dataclass(frozen=True)
class AppendEntriesReq(Msg):
    term: int = 0
    prev_index: int = 0
    prev_term: int = 0
    entries: Tuple[Tuple[int, int], ...] = ()   # ((term, payload), ...)
    leader_commit: int = 0


@dataclasses.dataclass(frozen=True)
class AppendEntriesResp(Msg):
    term: int = 0
    success: bool = False
    # On success: highest index known replicated (prev + len(entries)).
    # On failure: conflict fast-backup hint for the leader's next_index.
    match: int = 0


@dataclasses.dataclass(frozen=True)
class InstallSnapshotReq(Msg):
    term: int = 0
    snap_index: int = 0
    snap_term: int = 0
    snap_digest: int = 0
    snap_voters: int = 0   # voter bitmask as of the snapshot prefix
    # Session table as of the snapshot prefix (sid -> last applied seq);
    # None unless cfg.sessions (the batched path never carries it).
    snap_sessions: tuple = None


@dataclasses.dataclass(frozen=True)
class InstallSnapshotResp(Msg):
    term: int = 0
    match: int = 0


@dataclasses.dataclass(frozen=True)
class PreVoteReq(Msg):
    """Non-binding pre-ballot probe (dissertation §9.6): `term` is the
    PROPOSED next term (sender's term + 1); the sender has not bumped its
    own term. Receivers never adopt this term."""
    term: int = 0
    last_log_index: int = 0
    last_log_term: int = 0


@dataclasses.dataclass(frozen=True)
class PreVoteResp(Msg):
    """`term` is the responder's CURRENT term (authoritative — a higher
    one steps the pre-candidate down); `req_term` echoes the proposed
    term so a grant can be matched to the pre-ballot that asked."""
    term: int = 0
    req_term: int = 0
    granted: bool = False


@dataclasses.dataclass(frozen=True)
class TimeoutNow(Msg):
    """Leadership transfer (dissertation §3.10): the leader tells a
    fully-caught-up voter to campaign immediately — bypassing PreVote,
    since the handoff is deliberate. `term` is the sender's term."""
    term: int = 0


def inbox_sort_key(m: Msg):
    return (m.type, m.src)


def sort_inbox(msgs: List[Msg]) -> List[Msg]:
    return sorted(msgs, key=inbox_sort_key)
