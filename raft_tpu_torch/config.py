"""`RaftConfig` for the PyTorch port: the same fields, defaults and
validation as the JAX package's config, so one set of keyword arguments
builds the same universe in both packages.

Probabilities are floats in [0, 1], converted to uint32 thresholds
(`*_u32`) so every engine makes bit-identical draws against the
counter-based hashes (utils/trng.py).

The port runs the default protocol with crash, partition and drop
faults, PreVote, leadership transfer, single-server membership change,
scheduled ReadIndex reads and scheduled exactly-once client traffic
(sessions, with bounded admission). Every other feature raises
`NotImplementedError` when the config is built, never partway through a
run (`_UNPORTED`).
Validation failures raise `ValueError` (the JAX package asserts).
"""

from __future__ import annotations

import dataclasses

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


# (field, predicate on its value, what it is) for every feature the
# port does not carry yet. Each is refused at construction.
_UNPORTED = (
    ("nemesis", lambda v: len(v) > 0, "the nemesis program"),
    ("narrow_scalars", lambda v: v, "the narrow resident layout"),
    ("narrow_ring", lambda v: v, "the narrow resident layout"),
    ("narrow_mailbox", lambda v: v, "the narrow resident layout"),
    ("narrow_clients", lambda v: v, "the narrow resident layout"),
    ("donate_scan", lambda v: v, "scan donation"),
    ("pack_bools", lambda v: v, "the packed wire layout"),
    ("pack_ring", lambda v: v, "the packed wire layout"),
    ("alias_wire", lambda v: v, "wire aliasing"),
    ("wire_hist", lambda v: not v, "the histogram-free wire"),
    ("stream_groups", lambda v: v, "cohort streaming"),
)


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
        for field, on, what in _UNPORTED:
            if on(getattr(self, field)):
                raise NotImplementedError(
                    f"raft_tpu_torch does not port {what} yet "
                    f"({field}={getattr(self, field)!r}); see ROADMAP.md")
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


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)
