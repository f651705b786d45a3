"""Constants of the counter-based hashes: the fold multiplier, the start
value and the domain-separation tags the ported path draws under.

Everything stochastic in the simulator is a pure function of
``(seed, tag, coordinates...)`` through a 32-bit hash (utils/trng.py),
so the port and the JAX package make bit-identical draws.
"""

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
