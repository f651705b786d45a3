"""[Frozen copy of `raft_tpu_torch/ops/quorum.py` for the benchmark's reference,
its imports pointed at `raftbench.reference`.]

Quorum reductions over the K (replica) axis, batched over any leading
axes: vote counting is a masked count, commit advance the k-th order
statistic of ``match_index``.

Semantics are pinned to the JAX package's `ops/quorum.py`:
`commit_candidate` ranks the leader's own ``last_index`` first and
takes the (majority - 1)-th largest of the peers' match indices.
"""

from __future__ import annotations

import torch


def vote_count(votes):
    """Number of granted votes. ``votes``: bool[..., K]."""
    return votes.to(torch.int32).sum(-1, dtype=torch.int32)


def popcount(mask):
    """Set bits of an i32/u32 bitmask (any integer tensor), as int32: the
    SWAR bit count on the u32 pattern carried in int64."""
    m = mask.to(torch.int64) & 0xFFFFFFFF
    m = m - ((m >> 1) & 0x55555555)
    m = (m & 0x33333333) + ((m >> 2) & 0x33333333)
    m = (m + (m >> 4)) & 0x0F0F0F0F
    return (((m * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def voter_majority(voters):
    """Majority size of a voter bitmask."""
    return popcount(voters) // 2 + 1


def voter_bits(voters, k: int):
    """bool[..., K]: lane p is a member of the voter bitmask."""
    lanes = torch.arange(k, dtype=torch.int32, device=voters.device)
    return ((voters.unsqueeze(-1) >> lanes) & 1) == 1


def vote_won(votes, voters, k: int):
    """Granted votes from current-config voters reach that config's
    majority. ``votes``: bool[..., K]; ``voters``: i32[...]."""
    granted = (votes & voter_bits(voters, k)).to(torch.int32).sum(
        -1, dtype=torch.int32)
    return granted >= voter_majority(voters)


def commit_candidate_voters(match_index, last_index, node_id, voters,
                            k: int):
    """Voters-aware commit tally: the majority(voters)-th largest
    replication index among voters, the leader contributing its own
    ``last_index`` iff it is a voter; non-voters rank as -1. Returns -1
    when there are no voters (callers mask)."""
    lanes = torch.arange(k, dtype=torch.int32, device=match_index.device)
    own = lanes == node_id.unsqueeze(-1)
    vals = torch.where(voter_bits(voters, k),
                       torch.where(own, last_index.unsqueeze(-1),
                                   match_index),
                       torch.full_like(match_index, -1))
    desc = torch.sort(vals, dim=-1, descending=True).values
    pick = (voter_majority(voters) - 1).unsqueeze(-1).long()
    return torch.gather(desc, -1, pick).squeeze(-1)


def commit_candidate(match_index, last_index, node_id, k: int,
                     majority: int):
    """The highest index replicated on a majority.

    Args:
      match_index: int32[..., K] — the leader's view of peer replication.
      last_index: int32[...] — the leader's own last log index.
      node_id: int32[...] — the leader's id (its own match slot is
        excluded; the leader "matches itself" at ``last_index``, ranked
        first regardless of value).
      k, majority: config constants.
    """
    if majority == 1:
        return last_index
    lanes = torch.arange(k, dtype=torch.int32, device=match_index.device)
    own = lanes == torch.as_tensor(
        node_id, device=match_index.device).unsqueeze(-1)
    peers = torch.where(own, torch.full_like(match_index, -1), match_index)
    desc = torch.sort(peers, dim=-1, descending=True).values
    return desc[..., majority - 2]
