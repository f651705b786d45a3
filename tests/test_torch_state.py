"""The port's State (raft_tpu_torch.sim.state) against the JAX package's:
`init` leaf for leaf, values and dtypes, and the numpy carry-across
(`from_numpy` / `to_numpy`) of a mid-run JAX state. Tolerance 0."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import state as jstate
from raft_tpu.sim import step as jstep
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import state

FAULT_MIX = dict(n_groups=16, k=3, seed=7, drop_prob=0.05, crash_prob=0.1,
                 crash_epoch=16, partition_prob=0.2, partition_epoch=16,
                 log_cap=8, compact_every=4)


def assert_same(jax_tree, torch_tree):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, why


@pytest.mark.parametrize("kw", [dict(n_groups=6, seed=42),
                                dict(n_groups=9, k=3, log_cap=8,
                                     compact_every=4, seed=5),
                                dict(n_groups=4, seed=1, prevote=True),
                                dict(n_groups=4, seed=2, transfer_prob=0.3,
                                     reconfig_prob=0.3, read_every=8)],
                         ids=["k5_L32", "k3_L8", "prevote", "transfer"])
def test_init_matches_jax_every_leaf(kw):
    st = state.init(RaftConfig(**kw), device="cpu")
    assert_same(jstate.init(JaxConfig(**kw)), st)
    assert st.nodes.digest.dtype == torch.int64      # u32 carried in int64
    assert state.to_numpy(st).nodes.digest.dtype == np.uint32


def test_init_n_groups_override_and_device():
    cfg = RaftConfig(n_groups=3, seed=1)
    st = state.init(cfg, 11, device="cpu")
    assert st.alive_prev.shape == (11, 5)
    assert st.nodes.log_term.shape == (11, 5, 32)
    assert st.mailbox.ae_req_term.shape == (11, 5, 5)
    assert all(t.device.type == "cpu" for t in st.nodes if t is not None)


def test_carry_across_round_trips_mid_run_jax_state():
    jcfg = JaxConfig(**FAULT_MIX)
    sj = jstate.init(jcfg)
    for t in range(24):
        sj = jstep.tick(jcfg, sj, t)
    tree = jax.tree.map(np.asarray, sj)
    assert (tree.nodes.digest > 2 ** 31).any(), \
        "no digest above 2**31 - the u32 round trip is untested"
    st = state.from_numpy(tree, device="cpu")
    assert st.nodes.digest.dtype == torch.int64
    assert st.mailbox.is_req_snap_digest.dtype == torch.int64
    back = state.to_numpy(st)
    ok, why = trees_equal_why(tree, back)
    assert ok, why


def test_to_numpy_restores_reference_dtypes():
    st = state.to_numpy(state.init(RaftConfig(n_groups=2), device="cpu"))
    assert st.nodes.term.dtype == np.int32
    assert st.nodes.votes.dtype == np.bool_
    assert st.nodes.snap_digest.dtype == np.uint32
    assert st.mailbox.is_req_snap_digest.dtype == np.uint32
    assert st.mailbox.ae_resp_success.dtype == np.bool_
    assert st.alive_prev.dtype == np.bool_ and st.group_id.dtype == np.int32
