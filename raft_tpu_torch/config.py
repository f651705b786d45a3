"""`RaftConfig` for the PyTorch port: the same fields, defaults and
validation as the JAX package's config, so one set of keyword arguments
builds the same universe in both packages.

Probabilities are floats in [0, 1], converted to uint32 thresholds
(`*_u32`) so every engine makes bit-identical draws against the
counter-based hashes (utils/trng.py).

The port runs the default protocol with crash, partition and drop
faults, PreVote, leadership transfer, single-server membership change,
scheduled ReadIndex reads, scheduled exactly-once client traffic
(sessions, with bounded admission) and nemesis programs (gray failures
and storage pressure, `nemesis/program.py`). Three registries of dials
change where and how the state is held but never what a tick computes:
the wire layout (`LAYOUT_FIELDS`, sim/kernel.py's packed wire codec),
cohort streaming (`STREAM_FIELDS`, parallel/cohort.py) and the narrow
resident dtypes (`NARROW_FIELDS`, sim/state.py `narrow_spec`).
Validation failures raise `ValueError` (the JAX package asserts).
"""

from __future__ import annotations

import dataclasses

from raft_tpu_torch.utils import rng as _nem

_U32 = 0xFFFFFFFF

# Log-entry payload encoding: client payloads are 30-bit hashes; a set
# CONFIG_FLAG bit marks a membership-change entry whose low k bits are
# the new voter bitmask.
CONFIG_FLAG = 1 << 30

# Client-session encoding: a set SESSION_FLAG bit (below CONFIG_FLAG)
# marks a session command, with the sid in bits 20-28, the client
# sequence number in bits 10-19 and a 10-bit value hash in bits 0-9. The
# state machine applies a (sid, seq) at most once. A session issues at
# most SESSION_SEQ_MASK + 1 = 1024 commands.
SESSION_FLAG = 1 << 29
SESSION_SID_SHIFT, SESSION_SID_MASK = 20, 0x1FF
SESSION_SEQ_SHIFT, SESSION_SEQ_MASK = 10, 0x3FF
SESSION_VAL_MASK = 0x3FF


def _prob_to_u32(p: float) -> int:
    """Map a probability to a uint32 threshold: event iff hash < threshold.

    Probabilities are quantized to k/2**32 with k <= 2**32 - 1, so p=1.0
    means 1 - 2**-32 — the threshold must itself fit in a uint32 lane.
    """
    if p <= 0.0:
        return 0
    return min(int(p * 4294967296.0), _U32)


# Wire-layout dials (sim/kernel.py): how the fused-chunk kernel's wire is
# laid out at rest between launches (bit-packed bools, 16-bit ring-term
# deltas, the output written over the input, no histogram rows). Never
# what a tick computes.
LAYOUT_FIELDS = ("pack_bools", "pack_ring", "alias_wire", "wire_hist")

# Residency dials (parallel/cohort.py): the fleet's wire in host memory,
# paged through the card `cohort_blocks` 1,024-group blocks at a time.
STREAM_FIELDS = ("stream_groups", "cohort_blocks")

# Narrow resident dtypes (sim/state.py `narrow_spec`): the dtypes State
# leaves are held at between ticks; every tick widens on entry and
# narrows on exit, latching an overflow. `donate_scan` rides here as in
# the JAX package.
NARROW_FIELDS = ("narrow_scalars", "narrow_ring", "narrow_mailbox",
                 "narrow_clients", "donate_scan")


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    """Semantic parameters of the simulated Raft universe (DESIGN.md §2).
    Field for field the JAX package's `RaftConfig`."""

    n_groups: int = 1          # G — independent Raft groups (batch axis)
    k: int = 5                 # K — replicas per group
    log_cap: int = 32          # L — ring window: last_index - snap_index <= L
    max_entries_per_msg: int = 4   # E — entries carried per AppendEntries
    heartbeat_every: int = 2   # leader AE cadence, in ticks
    election_min: int = 10     # randomized election timeout in
    election_range: int = 10   # [election_min, election_min + election_range)
    compact_every: int = 8     # snapshot when commit - snap_index >= this
    cmds_per_tick: int = 1     # client commands the leader appends per tick
    sessions: bool = False
    seed: int = 0

    client_rate: float = 0.0
    client_slots: int = 4
    client_retry_backoff: int = 8
    client_queue_cap: int = 0

    # Fault injection (DESIGN.md §4). All off by default.
    drop_prob: float = 0.0       # per-link per-tick message loss
    crash_prob: float = 0.0      # per-node per-epoch crash probability
    crash_epoch: int = 64        # ticks per crash epoch
    partition_prob: float = 0.0  # per-group per-epoch partition probability
    partition_epoch: int = 64    # ticks per partition epoch

    reconfig_prob: float = 0.0
    reconfig_epoch: int = 64
    min_voters: int = 0

    transfer_prob: float = 0.0
    transfer_epoch: int = 64

    read_every: int = 0

    prevote: bool = False

    pack_bools: bool = False
    pack_ring: bool = False
    alias_wire: bool = False
    wire_hist: bool = True

    stream_groups: bool = False
    cohort_blocks: int = 4

    narrow_scalars: bool = False
    narrow_ring: bool = False
    narrow_mailbox: bool = False
    narrow_clients: bool = False
    donate_scan: bool = False

    nemesis: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "nemesis", _check_program(self.nemesis))
        _check(not self.sessions or self.cmds_per_tick == 0,
               "sessions=True needs cmds_per_tick=0: scheduled payloads "
               "hash the full 30-bit space, so bit 29 would be misread as "
               "session commands")
        if self.client_rate > 0.0:
            _check(self.sessions, "client_rate > 0 needs sessions=True")
            _check(self.clients_u32 > 0,
                   f"client_rate {self.client_rate} quantizes to a zero "
                   f"uint32 arrival threshold")
            _check(1 <= self.client_slots <= 16,
                   "client_slots must be in [1, 16]")
            _check(self.client_retry_backoff >= 1,
                   "client_retry_backoff must be >= 1")
        _check(self.client_queue_cap >= 0,
               "client_queue_cap must be >= 0 (0 = admission control off)")
        _check(self.client_queue_cap == 0 or self.client_rate > 0.0,
               "client_queue_cap > 0 needs client_rate > 0")
        _check(self.cohort_blocks >= 1, "cohort_blocks must be >= 1")
        _check(self.k >= 1, "k must be >= 1")
        _check(self.election_range >= 1, "election_range must be >= 1")
        _check(self.heartbeat_every >= 1, "heartbeat_every must be >= 1")
        _check(self.max_entries_per_msg >= 1,
               "max_entries_per_msg must be >= 1")
        # The AE entry walk relies on one message's E consecutive
        # indices occupying pairwise-distinct ring slots.
        _check(self.max_entries_per_msg <= self.log_cap,
               "max_entries_per_msg must not exceed log_cap")
        _check(self.log_cap >= self.compact_every + self.cmds_per_tick + 1,
               "log_cap must cover compact_every + cmds_per_tick + 1 or "
               "the window can deadlock before compaction frees space")
        _check(self.election_min > 2 * self.heartbeat_every,
               "election timeout must comfortably exceed the heartbeat "
               "cadence or steady-state leadership is impossible")
        _check(not self.pack_ring or self.log_cap % 2 == 0,
               "pack_ring packs two ring-term deltas per int32 word, so "
               "log_cap must be even")

    @property
    def majority(self) -> int:
        """Majority of the full k-node set."""
        return self.k // 2 + 1

    @property
    def full_mask(self) -> int:
        return (1 << self.k) - 1

    @property
    def effective_min_voters(self) -> int:
        return self.min_voters if self.min_voters > 0 else self.k // 2 + 1

    @property
    def clients_u32(self) -> int:
        """Arrival threshold of the scheduled client traffic: the one
        gate of the whole client subsystem (0 = absent)."""
        return _prob_to_u32(self.client_rate)

    @property
    def reconfig_u32(self) -> int:
        return _prob_to_u32(self.reconfig_prob)

    @property
    def transfer_u32(self) -> int:
        return _prob_to_u32(self.transfer_prob)

    @property
    def drop_u32(self) -> int:
        return _prob_to_u32(self.drop_prob)

    @property
    def crash_u32(self) -> int:
        return _prob_to_u32(self.crash_prob)

    @property
    def partition_u32(self) -> int:
        return _prob_to_u32(self.partition_prob)

    # The nemesis program split by seam: link clauses gate the delivery
    # filter, storm clauses the aliveness mask, skew clauses the deadline
    # draw, disk clauses every append, compaction clauses phase A's
    # snapshot step. Each seam is gated on its subprogram being non-empty.

    @property
    def nem_link(self) -> tuple:
        return _kinds(self.nemesis, _nem.NEM_LINK_KINDS)

    @property
    def nem_crash(self) -> tuple:
        return _kinds(self.nemesis, _nem.NEM_CRASH_KINDS)

    @property
    def nem_skew(self) -> tuple:
        return _kinds(self.nemesis, _nem.NEM_TIMING_KINDS)

    @property
    def nem_disk(self) -> tuple:
        return _kinds(self.nemesis, _nem.NEM_DISK_KINDS)

    @property
    def nem_compact(self) -> tuple:
        return _kinds(self.nemesis, _nem.NEM_COMPACT_KINDS)


def _kinds(prog: tuple, kinds: tuple) -> tuple:
    return tuple(c for c in prog if c[0] in kinds)


def _check_program(prog) -> tuple:
    """A nemesis program as a tuple of int 8-tuples, each clause checked
    as the JAX package checks it (`ValueError` on a malformed one)."""
    norm = []
    for c in prog:
        c = tuple(int(x) for x in c)
        _check(len(c) == 8, f"nemesis clause {c} must have 8 fields "
                            f"(kind, t0, t1, group_u32, p_u32, a, b, cid)")
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        _check(kind in _nem.NEM_KINDS, f"nemesis clause kind {kind} unknown "
                                       f"(known: {_nem.NEM_KINDS})")
        _check(0 <= t0 <= t1, f"nemesis clause span [{t0}, {t1}) invalid")
        _check(0 <= group_u32 <= _U32 and 0 <= p_u32 <= _U32,
               f"nemesis clause thresholds ({group_u32}, {p_u32}) outside "
               f"u32")
        # The engines carry a and b in u32 lanes (the skew amount in i32):
        # an out-of-range value would wrap into a different schedule.
        if kind == _nem.NEM_SKEW:
            _check(-2 ** 31 <= a < 2 ** 31,
                   f"nemesis skew amount {a} outside i32")
        else:
            _check(0 <= a <= _U32, f"nemesis clause a={a} outside u32")
        _check(0 <= b <= _U32, f"nemesis clause b={b} outside u32")
        _check(kind not in (_nem.NEM_FLAKY, _nem.NEM_STORM, _nem.NEM_WAVE,
                            _nem.NEM_DISK, _nem.NEM_COMPACT) or a >= 1,
               f"nemesis clause kind {kind} needs its epoch/period a >= 1, "
               f"got {a}")
        _check(kind != _nem.NEM_SLOW or a in (1, 2, 3),
               f"nemesis slow-follower clause needs direction a in "
               f"(1, 2, 3), got {a}")
        _check(kind != _nem.NEM_WAN or a >= 2,
               f"nemesis WAN clause needs >= 2 sites, got {a}")
        _check(cid >= 0, f"nemesis clause cid {cid} unassigned: build "
                         f"programs with nemesis.program()")
        norm.append(c)
    _check(len({c[7] for c in norm}) == len(norm),
           "nemesis clause cids must be unique: a duplicate cid aliases two "
           "clauses' draws")
    return tuple(norm)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)
