"""[Frozen copy of `raft_tpu_torch/utils/rng.py` for the benchmark's reference,
its imports pointed at `raftbench.reference`.]

The counter-based hashes on plain Python ints, and their constants:
the fold multiplier, the start value and the domain-separation tags.

Everything stochastic in the simulator is a pure function of
``(seed, tag, coordinates...)`` through a 32-bit hash, so the port and
the JAX package make bit-identical draws. The functions here serve the
CPU oracle (`core/`), the nemesis search's draws and program hashes;
utils/trng.py evaluates the same hashes on tensors for the batched tick.
"""

U32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
SEED0 = 0x243F6A88  # pi fraction, arbitrary non-zero start

# Domain-separation tags.
TAG_TIMEOUT = 1   # election deadline draws
TAG_DROP = 2      # per-link per-tick message loss
TAG_CRASH = 3     # per-node per-epoch crash schedule
TAG_PART = 4      # per-group per-epoch partition active?
TAG_PART_SIDE = 5  # per-node partition side assignment
TAG_CMD = 6       # client command payloads
TAG_RECONFIG = 7       # per-group per-epoch membership-change proposal?
TAG_RECONFIG_NODE = 8  # which node's membership the proposal toggles
TAG_TRANSFER = 9       # per-group per-epoch leadership-transfer attempt?
TAG_TRANSFER_NODE = 10  # which node the transfer hands leadership to
TAG_CLIENT_ARRIVAL = 11  # per-(group, sid, tick) open-loop client arrival
TAG_CLIENT_VAL = 12      # 10-bit value of a client op (sid, seq)
# Nemesis programs: every clause's draws are domain-separated by its cid.
TAG_NEM_GROUP = 13   # per-clause per-group participation
TAG_NEM_NODE = 14    # per-clause node / link-endpoint / site selection
TAG_NEM_LINK = 15    # per-clause per-link per-tick delivery draw
TAG_NEM_CRASH = 16   # crash-storm sub-epoch draws
TAG_NEM_SIDE = 17    # partition-wave side assignment (per period)
TAG_NEM_BURST = 18   # flaky-link burst sub-epoch draws
TAG_NEM_DISK = 19     # disk-full-follower sub-epoch draws
TAG_NEM_COMPACT = 20  # compaction-pressure sub-epoch draws

# ------------------------------------------------------ nemesis programs
# A nemesis program is a tuple of 8-int clauses
#     (kind, t0, t1, group_u32, p_u32, a, b, cid)
# (nemesis/program.py builds them). A clause is active at tick t in
# group g when t0 <= t < t1 and hash(seed, TAG_NEM_GROUP, cid, g) <
# group_u32. Kind-specific meaning of (p_u32, a, b):
#   NEM_SLOW    links touching the hash-chosen target node drop w.p.
#               p_u32 per tick; a = direction mask (1 = from the target,
#               2 = to it, 3 = both).
#   NEM_FLAKY   ONE hash-chosen ordered pair (s -> d) drops w.p. p_u32,
#               inside bursts only: sub-epochs of a ticks firing w.p. b.
#   NEM_WAN     nodes hash onto a sites; cross-site links drop w.p. p_u32.
#   NEM_SKEW    nodes selected w.p. p_u32 add the SIGNED a to every
#               election-deadline draw (the sum clamps at 1).
#   NEM_STORM   per (node, sub-epoch of a ticks) down w.p. p_u32, ANDed
#               into the base crash schedule.
#   NEM_WAVE    a partition window of b ticks sweeps the fleet with
#               period a (group g enters it g ticks after g - 1); inside
#               it cross-side links (sides re-drawn per period) drop
#               w.p. p_u32.
#   NEM_DISK    the hash-chosen target node's appends all fail during
#               sub-epochs of a ticks firing w.p. p_u32.
#   NEM_COMPACT each node's compaction is blocked during sub-epochs of a
#               ticks firing w.p. p_u32.
NEM_SLOW = 1
NEM_FLAKY = 2
NEM_WAN = 3
NEM_SKEW = 4
NEM_STORM = 5
NEM_WAVE = 6
NEM_DISK = 7
NEM_COMPACT = 8
NEM_KINDS = (NEM_SLOW, NEM_FLAKY, NEM_WAN, NEM_SKEW, NEM_STORM, NEM_WAVE,
             NEM_DISK, NEM_COMPACT)
# The seam each kind gates; every kind is in exactly one tuple.
NEM_LINK_KINDS = (NEM_SLOW, NEM_FLAKY, NEM_WAN, NEM_WAVE)
NEM_CRASH_KINDS = (NEM_STORM,)
NEM_TIMING_KINDS = (NEM_SKEW,)
NEM_DISK_KINDS = (NEM_DISK,)
NEM_COMPACT_KINDS = (NEM_COMPACT,)


def mix32(x: int) -> int:
    """32-bit avalanche (lowbias32). Pure-Python reference implementation."""
    x &= U32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & U32
    x ^= x >> 15
    x = (x * 0x846CA68B) & U32
    x ^= x >> 16
    return x


def hash_u32(*vals: int) -> int:
    """Fold arbitrarily many int coordinates into one uint32."""
    h = SEED0
    for v in vals:
        h = mix32((h * GOLD + (v & U32)) & U32)
    return h


def election_deadline(seed: int, g: int, node: int, draws: int,
                      election_min: int, election_range: int) -> int:
    """The `draws`-th randomized election deadline for (group, node)."""
    return election_min + hash_u32(seed, TAG_TIMEOUT, g, node, draws) % election_range


def link_dropped(seed: int, g: int, tick: int, src: int, dst: int,
                 drop_u32: int) -> bool:
    return hash_u32(seed, TAG_DROP, g, tick, src, dst) < drop_u32


def node_alive(seed: int, g: int, node: int, tick: int,
               crash_u32: int, crash_epoch: int) -> bool:
    return hash_u32(seed, TAG_CRASH, g, node, tick // crash_epoch) >= crash_u32


def link_partitioned(seed: int, g: int, tick: int, src: int, dst: int,
                     partition_u32: int, partition_epoch: int) -> bool:
    epoch = tick // partition_epoch
    if hash_u32(seed, TAG_PART, g, epoch) >= partition_u32:
        return False
    side_src = hash_u32(seed, TAG_PART_SIDE, g, epoch, src) & 1
    side_dst = hash_u32(seed, TAG_PART_SIDE, g, epoch, dst) & 1
    return side_src != side_dst


def client_payload(seed: int, g: int, term: int, index: int) -> int:
    """Deterministic opaque payload for the entry at (group, term, index).

    30-bit so the CONFIG_FLAG bit (config.py) stays clear: a client
    payload can never be mistaken for a membership-change entry.
    """
    return hash_u32(seed, TAG_CMD, g, term, index) & 0x3FFFFFFF


def reconfig_fires(seed: int, g: int, epoch: int, reconfig_u32: int) -> bool:
    """Does the membership-change schedule propose at this epoch?"""
    return hash_u32(seed, TAG_RECONFIG, g, epoch) < reconfig_u32


def reconfig_target(seed: int, g: int, epoch: int, k: int) -> int:
    """Which node's membership the epoch's proposal toggles."""
    return hash_u32(seed, TAG_RECONFIG_NODE, g, epoch) % k


def transfer_fires(seed: int, g: int, epoch: int, transfer_u32: int) -> bool:
    """Does the leadership-transfer schedule attempt at this epoch?"""
    return hash_u32(seed, TAG_TRANSFER, g, epoch) < transfer_u32


def transfer_target(seed: int, g: int, epoch: int, k: int) -> int:
    """Which node the epoch's transfer attempt hands leadership to."""
    return hash_u32(seed, TAG_TRANSFER_NODE, g, epoch) % k


def client_arrives(seed: int, g: int, sid: int, tick: int,
                   clients_u32: int) -> bool:
    """Does a new op arrive at (group, sid)'s open-loop client this tick?"""
    return hash_u32(seed, TAG_CLIENT_ARRIVAL, g, sid, tick) < clients_u32


def client_val(seed: int, g: int, sid: int, seq: int) -> int:
    """10-bit value hash of client op (sid, seq) — a pure function of
    the op identity, so a RETRY submits the byte-identical payload."""
    return hash_u32(seed, TAG_CLIENT_VAL, g, sid, seq) & 0x3FF


def digest_update(digest: int, index: int, payload: int) -> int:
    """State-machine hash chain: apply entry `index` with `payload`."""
    return mix32((digest * GOLD + mix32((index * GOLD + payload) & U32)) & U32)


# ------------------------------------------- compiled nemesis evaluators
# Host-int versions for the CPU oracle; utils/trng.py carries the
# tensor twins. Callers pass the kind-filtered subprogram
# (RaftConfig.nem_link / nem_crash / ...) and gate the call on it being
# non-empty: an evaluator that finds no relevant clause raises.


def _nem_active(seed: int, c: tuple, g: int, t: int) -> bool:
    """One clause's span ∧ per-group participation gate."""
    _, t0, t1, group_u32, _, _, _, cid = c
    return (t0 <= t < t1
            and hash_u32(seed, TAG_NEM_GROUP, cid, g) < group_u32)


def nem_link_ok(seed, prog, g, t, src, dst, k):
    """True iff no active link clause blocks delivery on (src -> dst)
    at tick t — ANDed into the same delivery filter as drop/partition."""
    relevant = False
    ok = True
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        if kind not in NEM_LINK_KINDS:
            continue
        relevant = True
        if not _nem_active(seed, c, g, t):
            continue
        if kind == NEM_SLOW:
            target = hash_u32(seed, TAG_NEM_NODE, cid, g) % k
            hit = (((a & 1) != 0 and src == target)
                   or ((a & 2) != 0 and dst == target))
        elif kind == NEM_FLAKY:
            if k < 2:
                continue   # a 1-node group has no links
            s = hash_u32(seed, TAG_NEM_NODE, cid, g, 0) % k
            d = (s + 1 + hash_u32(seed, TAG_NEM_NODE, cid, g, 1)
                 % (k - 1)) % k
            hit = (src == s and dst == d
                   and hash_u32(seed, TAG_NEM_BURST, cid, g, t // a) < b)
        elif kind == NEM_WAN:
            hit = (hash_u32(seed, TAG_NEM_NODE, cid, g, src) % a
                   != hash_u32(seed, TAG_NEM_NODE, cid, g, dst) % a)
        else:   # NEM_WAVE
            wave = ((t + g) % a) < b
            hit = (wave
                   and (hash_u32(seed, TAG_NEM_SIDE, cid, g, t // a, src) & 1)
                   != (hash_u32(seed, TAG_NEM_SIDE, cid, g, t // a, dst) & 1))
        if hit and hash_u32(seed, TAG_NEM_LINK, cid, g, t, src, dst) < p_u32:
            ok = False
    if not relevant:
        raise ValueError("nem_link_ok: no link clause in the program — "
                         "gate the call on cfg.nem_link")
    return ok


def nem_alive(seed, prog, g, i, t):
    """True iff no active crash-storm clause holds node i down at tick
    t — ANDed into the base TAG_CRASH aliveness mask."""
    relevant = False
    alive = True
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        if kind not in NEM_CRASH_KINDS:
            continue
        relevant = True
        if (_nem_active(seed, c, g, t)
                and hash_u32(seed, TAG_NEM_CRASH, cid, g, i, t // a) < p_u32):
            alive = False
    if not relevant:
        raise ValueError("nem_alive: no crash clause in the program — "
                         "gate the call on cfg.nem_crash")
    return alive


def nem_deadline_extra(seed, prog, g, i, t):
    """Signed tick skew added to the election-deadline draw node i
    makes at tick t (callers clamp the skewed deadline at 1)."""
    relevant = False
    extra = 0
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        if kind not in NEM_TIMING_KINDS:
            continue
        relevant = True
        if (_nem_active(seed, c, g, t)
                and hash_u32(seed, TAG_NEM_NODE, cid, g, i) < p_u32):
            extra += a
    if not relevant:
        raise ValueError("nem_deadline_extra: no timing clause in the "
                         "program — gate the call on cfg.nem_skew")
    return extra


def nem_disk_full(seed, prog, g, i, t, k):
    """True iff an active disk-full clause exhausts node i's
    persistence budget at tick t (r20, DESIGN.md §19). The target node
    is hash-chosen per (clause, group) like NEM_SLOW's, so a quorum of
    healthy disks usually survives; fullness fires per sub-epoch of a
    ticks w.p. p_u32. A full disk fails every local append — the entry
    is not durable and must never be acked."""
    relevant = False
    full = False
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        if kind not in NEM_DISK_KINDS:
            continue
        relevant = True
        if not _nem_active(seed, c, g, t):
            continue
        target = hash_u32(seed, TAG_NEM_NODE, cid, g) % k
        if (i == target
                and hash_u32(seed, TAG_NEM_DISK, cid, g, t // a) < p_u32):
            full = True
    if not relevant:
        raise ValueError("nem_disk_full: no disk clause in the program — "
                         "gate the call on cfg.nem_disk")
    return full


def nem_compact_block(seed, prog, g, i, t):
    """True iff an active compaction-pressure clause blocks node i's
    snapshot/compaction step at tick t (r20, DESIGN.md §19): per-node
    per-sub-epoch-of-a-ticks draws under p_u32, so the log_cap ring
    genuinely fills while the clause holds."""
    relevant = False
    blocked = False
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        if kind not in NEM_COMPACT_KINDS:
            continue
        relevant = True
        if (_nem_active(seed, c, g, t)
                and hash_u32(seed, TAG_NEM_COMPACT, cid, g, i,
                             t // a) < p_u32):
            blocked = True
    if not relevant:
        raise ValueError("nem_compact_block: no compaction clause in the "
                         "program — gate the call on cfg.nem_compact")
    return blocked
