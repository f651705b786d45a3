"""Quorum reductions over the K (replica) axis, batched over any leading
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
    """Set bits of an i32/u32 bitmask (any integer tensor), as int32."""
    m = mask.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(m)
    for b in range(32):
        n = n + ((m >> b) & 1)
    return n.to(torch.int32)


def voter_majority(voters):
    """Majority size of a voter bitmask."""
    return popcount(voters) // 2 + 1


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
