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
