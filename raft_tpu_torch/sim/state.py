"""Struct-of-arrays state of the batched tick, as torch tensors.

Every field of a replica becomes a tensor with leading dims `[G, K]`
(G independent Raft groups, K replicas each); the names and layouts are
those of the JAX package's `sim/state.py`. Logs are ring-addressed by
absolute index: the entry at absolute index ``i`` lives in slot
``(i - 1) % L``, injective over the live window because
``last_index - snap_index <= L``.

The in-flight `Mailbox` holds one slot per (group, dst, src,
message type), `[G, K_dst, K_src]`: at most one message of each type
crosses each link per tick.

dtypes: int32 and bool as in the JAX package. The u32 digests
(`snap_digest`, `digest`, `is_req_snap_digest`) are carried as int64 in
[0, 2**32), because torch has no usable uint32 arithmetic
(utils/trng.py); `to_numpy` restores uint32.

With scheduled clients on, each replica carries its dedup tables
(`session_seq`, `snap_session_seq`, `[G, K, S]`), InstallSnapshot
carries the sender's snapshot table (`is_req_snap_sessions`,
`[G, K_dst, K_src, S]`) and `State.clients` the client state
(clients/state.py).

Narrow resident form (`narrow_*` dials, `narrow_spec`): the leaves the
spec names are held at u16/i16/i8 between ticks; every tick widens them
on entry, computes at int32 and narrows on exit, latching bit 31 of
`group_id` in a group where a value does not survive the narrowing.
Every host boundary refuses a latched state (`check_narrow_overflow`).

`from_numpy` / `to_numpy` carry a State (or Metrics, or Flight) across
from and to numpy arrays — the numpy side is exactly a JAX State with every leaf
passed through `np.asarray` — so both packages can start from one
mid-run state.
"""

from __future__ import annotations

from typing import NamedTuple

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.clients.state import (NARROW_CLIENT_SPEC, ClientState,
                                          active_client_leaves,
                                          clients_init)
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.node import FOLLOWER, NO_VOTE
from raft_tpu_torch.utils import trng

I32 = torch.int32
U32 = torch.int64   # u32 values in int64 (module docstring)
BOOL = torch.bool
U16, I16, I8 = torch.uint16, torch.int16, torch.int8


class PerNode(NamedTuple):
    """Per-replica state; leading dims `[G, K]`."""

    # Durable (survives crash/restart).
    term: torch.Tensor         # i32
    voted_for: torch.Tensor    # i32, NO_VOTE = -1
    snap_index: torch.Tensor   # i32
    snap_term: torch.Tensor    # i32
    snap_digest: torch.Tensor  # u32
    snap_voters: torch.Tensor  # i32 — voter bitmask as of the snapshot
    rng_draws: torch.Tensor    # i32 — monotone deadline-draw counter
    last_index: torch.Tensor   # i32
    log_term: torch.Tensor     # i32[L], ring slot (i-1) % L
    log_payload: torch.Tensor  # i32[L]
    # Volatile (reset on restart).
    role: torch.Tensor         # i32: FOLLOWER/CANDIDATE/LEADER
    leader_id: torch.Tensor    # i32
    commit: torch.Tensor       # i32
    applied: torch.Tensor      # i32
    digest: torch.Tensor       # u32 — state-machine hash chain
    votes: torch.Tensor        # bool[K]
    next_index: torch.Tensor   # i32[K]
    match_index: torch.Tensor  # i32[K]
    election_elapsed: torch.Tensor   # i32
    heartbeat_elapsed: torch.Tensor  # i32
    deadline: torch.Tensor     # i32
    leader_elapsed: torch.Tensor     # i32 — PreVote lease clock
    # Scheduled-read state; written only when `cfg.read_every` (and by
    # the restart edge).
    ack_time: torch.Tensor           # i32[K] — last current-term resp tick
    sched_read_index: torch.Tensor   # i32 — read point, -1 = none
    sched_read_reg: torch.Tensor     # i32 — registration tick
    reads_done: torch.Tensor         # i32 — completed linearizable reads
    # Session dedup tables, i32[S] (-1 = nothing applied): present only
    # with scheduled clients on.
    session_seq: torch.Tensor | None = None       # the live table
    snap_session_seq: torch.Tensor | None = None  # as of the snapshot


class Mailbox(NamedTuple):
    """One slot per (dst, src, rpc type); `[G, K_dst, K_src]` in flight.
    `*_present` is the occupancy bit; every other field is meaningful
    only under it. AppendEntries carries no entries: the receiver pulls
    them from the sender's ring as of the end of the previous tick."""

    rv_req_present: torch.Tensor   # bool
    rv_req_term: torch.Tensor      # i32
    rv_req_lli: torch.Tensor       # i32 — last_log_index
    rv_req_llt: torch.Tensor       # i32 — last_log_term

    rv_resp_present: torch.Tensor  # bool
    rv_resp_term: torch.Tensor     # i32
    rv_resp_granted: torch.Tensor  # bool

    ae_req_present: torch.Tensor   # bool
    ae_req_term: torch.Tensor      # i32
    ae_req_prev_index: torch.Tensor  # i32
    ae_req_prev_term: torch.Tensor   # i32
    ae_req_n: torch.Tensor         # i32 — number of valid entries
    ae_req_commit: torch.Tensor    # i32 — leader_commit

    ae_resp_present: torch.Tensor  # bool
    ae_resp_term: torch.Tensor     # i32
    ae_resp_success: torch.Tensor  # bool
    ae_resp_match: torch.Tensor    # i32

    is_req_present: torch.Tensor   # bool
    is_req_term: torch.Tensor      # i32
    is_req_snap_index: torch.Tensor   # i32
    is_req_snap_term: torch.Tensor    # i32
    is_req_snap_digest: torch.Tensor  # u32
    is_req_snap_voters: torch.Tensor  # i32

    is_resp_present: torch.Tensor  # bool
    is_resp_term: torch.Tensor     # i32
    is_resp_match: torch.Tensor    # i32

    # PreVote slots: present only when `cfg.prevote` (None otherwise).
    pv_req_present: torch.Tensor | None = None   # bool
    pv_req_term: torch.Tensor | None = None      # i32 — proposed term
    pv_req_lli: torch.Tensor | None = None       # i32
    pv_req_llt: torch.Tensor | None = None       # i32
    pv_resp_present: torch.Tensor | None = None  # bool
    pv_resp_term: torch.Tensor | None = None     # i32 — responder's term
    pv_resp_req_term: torch.Tensor | None = None  # i32 — echoed proposal
    pv_resp_granted: torch.Tensor | None = None  # bool
    # TimeoutNow (leadership transfer): present only when the transfer
    # schedule is on.
    tn_present: torch.Tensor | None = None       # bool
    tn_term: torch.Tensor | None = None          # i32
    # InstallSnapshot's session table, i32[S]: present only with
    # scheduled clients on.
    is_req_snap_sessions: torch.Tensor | None = None


class State(NamedTuple):
    nodes: PerNode            # leaves [G, K, ...]
    mailbox: Mailbox          # in flight: sent last tick, delivered this tick
    alive_prev: torch.Tensor  # bool[G, K] — liveness during the previous tick
    group_id: torch.Tensor    # i32[G] — global group index (seeds the hashes)
    clients: ClientState | None = None   # [G, S] leaves; clients on only


MB_BOOL = ("rv_req_present", "rv_resp_present", "rv_resp_granted",
           "ae_req_present", "ae_resp_present", "ae_resp_success",
           "is_req_present", "is_resp_present", "pv_req_present",
           "pv_resp_present", "pv_resp_granted", "tn_present")
MB_U32 = ("is_req_snap_digest",)
MB_BASE = Mailbox._fields[:26]   # always carried
MB_PV = Mailbox._fields[26:34]   # carried when cfg.prevote
MB_TN = Mailbox._fields[34:36]   # carried when cfg.transfer_u32
MB_FIELDS = MB_BASE + MB_PV + MB_TN   # every [K, K] slot the port carries
MB_CS = ("is_req_snap_sessions",)    # [K, K, S], carried when clients on
PRESENT_FIELDS = ("rv_req_present", "rv_resp_present", "ae_req_present",
                  "ae_resp_present", "is_req_present", "is_resp_present",
                  "pv_req_present", "pv_resp_present", "tn_present")


def mb_fields(cfg: RaftConfig) -> tuple:
    """The mailbox slots a universe carries, in Mailbox order."""
    return (MB_BASE + (MB_PV if cfg.prevote else ())
            + (MB_TN if cfg.transfer_u32 else ())
            + (MB_CS if cfg.clients_u32 else ()))


def present_fields(cfg: RaftConfig) -> tuple:
    """The occupancy bits a universe carries."""
    on = set(mb_fields(cfg))
    return tuple(f for f in PRESENT_FIELDS if f in on)


def mailbox_dtype(field: str) -> torch.dtype:
    if field in MB_BOOL:
        return BOOL
    return U32 if field in MB_U32 else I32


def empty_mailbox(cfg: RaftConfig, lead_shape: tuple, device) -> Mailbox:
    """Zero mailbox with the given leading shape (`(g, k, k)` in flight);
    the PreVote, TimeoutNow and session-table slots exist only when their
    features are on (None otherwise)."""
    def extra(f):
        return (cfg.client_slots,) if f in MB_CS else ()

    return Mailbox(**{f: torch.zeros(lead_shape + extra(f),
                                     dtype=mailbox_dtype(f), device=device)
                      for f in mb_fields(cfg)})


def init(cfg: RaftConfig, n_groups: int | None = None,
         device="cuda", first_group: int = 0) -> State:
    """Fresh state: every replica a follower at term 0 with one timer
    draw taken (deadline = draw 0, rng_draws = 1). `first_group` starts
    the group ids there: groups [first_group, first_group + n_groups) of
    a larger fleet, built a window at a time."""
    g = cfg.n_groups if n_groups is None else n_groups
    k, cap = cfg.k, cfg.log_cap
    device = torch.device(device)

    g_idx = torch.arange(first_group, first_group + g, dtype=I32,
                         device=device)[:, None]
    i_idx = torch.arange(k, dtype=I32, device=device)[None, :]
    deadline = trng.election_deadline(cfg.seed, g_idx, i_idx, 0,
                                      cfg.election_min, cfg.election_range)
    if cfg.nem_skew:
        # The first draw is made at tick 0: a skew clause covering it
        # skews the initial deadline.
        deadline = torch.clamp(deadline + trng.nem_deadline_extra(
            cfg.seed, cfg.nem_skew, g_idx, i_idx, 0), min=1)
    deadline = deadline.expand(g, k).contiguous()

    def z(dtype, *extra):
        return torch.zeros((g, k) + extra, dtype=dtype, device=device)

    def full(v, *extra):
        return torch.full((g, k) + extra, v, dtype=I32, device=device)

    sess = {}
    if cfg.clients_u32:
        # Slots 0..S-1 are born registered with nothing applied.
        sess = dict(session_seq=full(-1, cfg.client_slots),
                    snap_session_seq=full(-1, cfg.client_slots))
    nodes = PerNode(
        term=z(I32), voted_for=full(NO_VOTE),
        snap_index=z(I32), snap_term=z(I32), snap_digest=z(U32),
        snap_voters=full(cfg.full_mask), rng_draws=full(1),
        last_index=z(I32),
        log_term=z(I32, cap), log_payload=z(I32, cap),
        role=full(FOLLOWER), leader_id=full(NO_VOTE),
        commit=z(I32), applied=z(I32), digest=z(U32),
        votes=z(BOOL, k), next_index=full(1, k), match_index=z(I32, k),
        election_elapsed=z(I32), heartbeat_elapsed=z(I32),
        deadline=deadline, leader_elapsed=z(I32),
        ack_time=full(-1, k), sched_read_index=full(-1),
        sched_read_reg=z(I32), reads_done=z(I32), **sess,
    )
    st = State(nodes=nodes, mailbox=empty_mailbox(cfg, (g, k, k), device),
               alive_prev=torch.ones((g, k), dtype=BOOL, device=device),
               group_id=g_idx[:, 0].clone(),
               clients=(clients_init(cfg, g, device) if cfg.clients_u32
                        else None))
    # The resident form is the narrow one when a narrow dial is on; the
    # initial values are all in range, so this narrowing never latches.
    return narrow_state(cfg, st)


# ------------------------------------------------ narrow resident form

# Bit 31 of the int32 group_id: the sticky narrow-overflow latch.
NARROW_LATCH = -(2 ** 31)

# PerNode scalars at u16 under narrow_scalars (nonnegative terms, log
# indices, counters and clocks).
_NODE_U16 = ("term", "snap_index", "snap_term", "rng_draws",
             "last_index", "commit", "applied", "next_index",
             "match_index", "election_elapsed", "heartbeat_elapsed",
             "deadline", "leader_elapsed", "sched_read_reg",
             "reads_done")
# Mailbox term and index payloads at u16 under narrow_mailbox; the
# PreVote slots only when the universe carries them.
_MB_U16 = ("rv_req_term", "rv_req_lli", "rv_req_llt", "rv_resp_term",
           "ae_req_term", "ae_req_prev_index", "ae_req_prev_term",
           "ae_req_commit", "ae_resp_term", "ae_resp_match",
           "is_req_term", "is_req_snap_index", "is_req_snap_term",
           "is_resp_term", "is_resp_match")
_MB_PV_U16 = ("pv_req_term", "pv_req_lli", "pv_req_llt", "pv_resp_term",
              "pv_resp_req_term")


def narrow_spec(cfg: RaftConfig) -> dict:
    """Dot-path leaf name -> narrow dtype of every State leaf the
    config's narrow dials re-declare; empty when every dial is off. The
    voter bitmasks narrow only while they fit 16 bits (k <= 16)."""
    spec: dict = {}
    if cfg.narrow_scalars:
        for n in _NODE_U16:
            spec[f"nodes.{n}"] = U16
        for n in ("voted_for", "role", "leader_id"):
            spec[f"nodes.{n}"] = I8
        spec["nodes.ack_time"] = I16
        spec["nodes.sched_read_index"] = I16
        if cfg.k <= 16:
            spec["nodes.snap_voters"] = U16
    if cfg.narrow_ring:
        spec["nodes.log_term"] = U16
    if cfg.narrow_mailbox:
        for n in _MB_U16:
            spec[f"mailbox.{n}"] = U16
        if cfg.prevote:
            for n in _MB_PV_U16:
                spec[f"mailbox.{n}"] = U16
        if cfg.transfer_u32:
            spec["mailbox.tn_term"] = U16
        spec["mailbox.ae_req_n"] = I8
        if cfg.k <= 16:
            spec["mailbox.is_req_snap_voters"] = U16
    if cfg.narrow_clients and cfg.clients_u32:
        spec["nodes.session_seq"] = I16
        spec["nodes.snap_session_seq"] = I16
        spec["mailbox.is_req_snap_sessions"] = I16
        for n in active_client_leaves(cfg):
            spec[f"clients.{n}"] = NARROW_CLIENT_SPEC[n]
    return spec


def full_narrow_spec(cfg: RaftConfig) -> dict:
    """The spec with every narrow dial on."""
    return narrow_spec(dataclasses.replace(
        cfg, narrow_scalars=True, narrow_ring=True, narrow_mailbox=True,
        narrow_clients=True))


def narrow_active(cfg: RaftConfig) -> bool:
    """True iff the resident form differs from the wide one (the spec
    decides: `narrow_clients` alone on a clients-off universe maps no
    leaf)."""
    return bool(narrow_spec(cfg))


def _map_named(tree, prefix: str, fn):
    """Rebuild a NamedTuple tree, applying fn(dot path, leaf) to every
    leaf that is not None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(getattr(tree, f), f"{prefix}{f}.",
                                       fn) for f in tree._fields))
    return fn(prefix[:-1], tree)


def narrow_state(cfg: RaftConfig, st: State) -> State:
    """Wide State -> the config's narrow resident form, latching bit 31
    of `group_id` in every group holding a value that does not survive
    the round trip (sticky: the other lanes pass through). Identity when
    every narrow dial is off."""
    spec = narrow_spec(cfg)
    if not spec:
        return st
    overflow = []

    def leaf(name, a):
        dt = spec.get(name)
        if dt is None or a.dtype == dt:
            return a
        na = a.to(dt)
        overflow.append((na.to(a.dtype) != a).reshape(a.shape[0], -1)
                        .any(dim=1))
        return na

    out = _map_named(st, "", leaf)
    if not overflow:
        return out
    ov = torch.stack(overflow).any(dim=0)
    return out._replace(group_id=torch.where(
        ov, out.group_id | NARROW_LATCH, out.group_id))


def widen_state(cfg: RaftConfig, st: State) -> State:
    """Narrow resident form -> the int32 compute form (zero-extending the
    unsigned lanes, sign-extending the signed ones). `group_id` passes
    through, latch and all. Identity when every narrow dial is off."""
    spec = narrow_spec(cfg)
    if not spec:
        return st
    return _map_named(st, "", lambda name, a: a.to(I32)
                      if name in spec and a.dtype != I32 else a)


def narrow_overflow(st: State) -> torch.Tensor:
    """bool[G]: the groups whose narrow-overflow latch has fired."""
    return st.group_id < 0


def check_narrow_overflow(cfg: RaftConfig, st: State) -> None:
    """The host-boundary refusal (kfinish, the stream driver): raise
    ValueError naming the latched groups."""
    if not narrow_active(cfg):
        return
    bad = narrow_overflow(st).nonzero().flatten().tolist()
    if bad:
        raise ValueError(
            f"narrow-dtype overflow latched in {len(bad)} group(s) "
            f"(first: {bad[:8]}): a value outgrew its narrow native dtype "
            f"(DESIGN.md §18 range table). Re-run with the narrow_* dials "
            f"off — results after the latch tick are invalid and are "
            f"refused rather than silently truncated")


# ------------------------------------------------- carrying state across


def _map(tree, cls, fn):
    """Rebuild NamedTuple `tree` as `cls`, applying `fn` to its leaves;
    nested NamedTuples map onto the port's class of the same name."""
    nested = {"nodes": PerNode, "mailbox": Mailbox, "clients": ClientState}
    out = {}
    for f in cls._fields:
        v = getattr(tree, f, None)
        if v is None:
            out[f] = None
        elif f in nested:
            out[f] = _map(v, nested[f], fn)
        else:
            out[f] = fn(v)
    return cls(**out)


def _np_to_torch(a, device):
    a = np.array(a)   # a writable copy, 0-d arrays kept 0-d
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _torch_to_np(t):
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def from_numpy(tree, device="cuda"):
    """A State, Metrics or Flight of numpy arrays, as
    `jax.tree.map(np.asarray, jax_tree)` gives it, as the port's class of
    the same name on `device`."""
    from raft_tpu_torch.obs.recorder import Flight
    from raft_tpu_torch.sim.run import Metrics
    cls = {c.__name__: c for c in (State, Metrics, Flight)}[
        type(tree).__name__]
    return _map(tree, cls, lambda a: _np_to_torch(a, torch.device(device)))


def to_numpy(tree):
    """The port's State, Metrics or Flight as numpy arrays with the JAX
    package's dtypes (bool, int32, uint32 for the digests, and the
    narrow dtypes of a narrow resident State)."""
    return _map(tree, type(tree), _torch_to_np)
