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

`from_numpy` / `to_numpy` carry a State (or Metrics, or Flight) across
from and to numpy arrays — the numpy side is exactly a JAX State with every leaf
passed through `np.asarray` — so both packages can start from one
mid-run state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch.clients.state import ClientState, clients_init
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core.node import FOLLOWER, NO_VOTE
from raft_tpu_torch.utils import trng

I32 = torch.int32
U32 = torch.int64   # u32 values in int64 (module docstring)
BOOL = torch.bool


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
         device="cuda") -> State:
    """Fresh state: every replica a follower at term 0 with one timer
    draw taken (deadline = draw 0, rng_draws = 1)."""
    g = cfg.n_groups if n_groups is None else n_groups
    k, cap = cfg.k, cfg.log_cap
    device = torch.device(device)

    g_idx = torch.arange(g, dtype=I32, device=device)[:, None]
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
    return State(nodes=nodes, mailbox=empty_mailbox(cfg, (g, k, k), device),
                 alive_prev=torch.ones((g, k), dtype=BOOL, device=device),
                 group_id=torch.arange(g, dtype=I32, device=device),
                 clients=(clients_init(cfg, g, device) if cfg.clients_u32
                          else None))


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
    package's dtypes (bool, int32, and uint32 for the digests)."""
    return _map(tree, type(tree), _torch_to_np)
