"""Role and vote constants of the reference tick (the values the
program's CPU oracle, `raft_tpu_torch/core/node.py`, defines)."""

FOLLOWER, CANDIDATE, LEADER, PRECANDIDATE = 0, 1, 2, 3
NO_VOTE = -1
