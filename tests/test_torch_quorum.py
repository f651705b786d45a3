"""The port's quorum reductions (raft_tpu_torch.ops.quorum) against the
JAX package's (raft_tpu.ops.quorum) on random [G, K] inputs.
Tolerance 0: integer results."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from raft_tpu.ops import quorum as jq
from raft_tpu_torch.ops import quorum as tq


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7])
def test_commit_candidate_matches_jax(k):
    rs = np.random.default_rng(k)
    g = 256
    match = rs.integers(0, 40, (g, k)).astype(np.int32)
    last = rs.integers(0, 40, (g, k)).astype(np.int32)
    node = np.broadcast_to(np.arange(k, dtype=np.int32), (g, k)).copy()
    maj = k // 2 + 1
    want = jax.vmap(jax.vmap(
        lambda m, li, i: jq.commit_candidate(m, li, i, k, maj),
        in_axes=(None, 0, 0)), in_axes=(0, 0, 0))(match, last, node)
    mb = torch.from_numpy(match)[:, None, :].expand(g, k, k)
    got = tq.commit_candidate(mb, torch.from_numpy(last),
                              torch.from_numpy(node), k, maj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vote_count_matches_jax():
    rs = np.random.default_rng(3)
    votes = rs.random((128, 5, 5)) < 0.5
    got = tq.vote_count(torch.from_numpy(votes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.vote_count(votes)))


def test_popcount_and_majority_match_jax():
    rs = np.random.default_rng(4)
    masks = np.concatenate([
        np.array([0, 1, 0x1F, 0x7FFFFFFF, -1, -2 ** 31], dtype=np.int32),
        rs.integers(-2 ** 31, 2 ** 31, 500, dtype=np.int64).astype(np.int32)])
    t = torch.from_numpy(masks)
    np.testing.assert_array_equal(tq.popcount(t).numpy(),
                                  np.asarray(jq.popcount(masks)))
    np.testing.assert_array_equal(tq.voter_majority(t).numpy(),
                                  np.asarray(jq.voter_majority(masks)))


def test_voters_aware_quorums_match_jax():
    """vote_won and commit_candidate_voters on random voter bitmasks
    (the empty set included: the tally is then -1)."""
    k, g = 5, 512
    rs = np.random.default_rng(6)
    votes = rs.random((g, k)) < 0.5
    voters = rs.integers(0, 1 << k, g).astype(np.int32)
    voters[:3] = (0, 1, (1 << k) - 1)
    match = rs.integers(0, 40, (g, k)).astype(np.int32)
    last = rs.integers(0, 40, g).astype(np.int32)
    node = rs.integers(0, k, g).astype(np.int32)
    np.testing.assert_array_equal(
        tq.voter_bits(torch.from_numpy(voters), k).numpy(),
        np.asarray(jax.vmap(lambda v: jq.voter_bits(v, k))(voters)))
    np.testing.assert_array_equal(
        tq.vote_won(torch.from_numpy(votes), torch.from_numpy(voters),
                    k).numpy(),
        np.asarray(jax.vmap(lambda a, v: jq.vote_won(a, v, k))(votes,
                                                                voters)))
    got = tq.commit_candidate_voters(
        torch.from_numpy(match), torch.from_numpy(last),
        torch.from_numpy(node), torch.from_numpy(voters), k)
    want = jax.vmap(lambda m, li, i, v: jq.commit_candidate_voters(
        m, li, i, v, k))(match, last, node, voters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == -1
