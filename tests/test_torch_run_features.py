"""The port's loop and kernel wrapper against the JAX package with the
protocol features on (tests/test_pkernel.py::test_feature_mix_bit_exact's
universe: PreVote, membership change, leadership transfer and scheduled
reads, with crash and drop faults): full State and Metrics of
`raft_tpu_torch.sim.run.run` equal `raft_tpu.sim.run.run`;
`raft_tpu_torch.sim.kernel.prun` on CPU tensors equals both; chunk
boundaries are invisible; a run resumed from a carried-across mid-run
JAX state (its PreVote and TimeoutNow mailbox slots included) equals the
JAX continuation; `kreads` reads the completed-read count off the wire.
Tolerance 0 throughout."""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import state as jstate
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, run, state

# The module (raft_tpu.sim re-exports its `run` function under that name).
jrun = importlib.import_module("raft_tpu.sim.run")

FEATURE_MIX = dict(n_groups=6, k=3, seed=47, prevote=True, reconfig_prob=0.8,
                   reconfig_epoch=16, transfer_prob=0.7, transfer_epoch=24,
                   read_every=4, crash_prob=0.15, crash_epoch=24,
                   drop_prob=0.04, log_cap=8, compact_every=4)
N_TICKS = 64


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def feature_mix():
    """(cfg, torch init, JAX run.run result, JAX continuation). The JAX
    runs pass their metrics explicitly, so both share one program."""
    jcfg = JaxConfig(**FEATURE_MIX)
    g = FEATURE_MIX["n_groups"]
    sj, mj = jrun.run(jcfg, jstate.init(jcfg), N_TICKS, 0,
                      jrun.metrics_init(g))
    cont = jrun.run(jcfg, sj, N_TICKS, N_TICKS, mj)
    cfg = RaftConfig(**FEATURE_MIX)
    return cfg, state.init(cfg, device="cpu"), (sj, mj), cont


def test_run_matches_jax_run(feature_mix):
    cfg, st0, (sj, mj), _ = feature_mix
    st, m = run.run(cfg, st0, N_TICKS)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert int(m.elections) > 0 and int(m.safety.min()) == 1
    assert st.mailbox.pv_req_present is not None
    assert st.mailbox.tn_present is not None


def test_kernel_prun_cpu_matches_run(feature_mix):
    cfg, st0, (sj, mj), _ = feature_mix
    st, m = kernel.prun(cfg, st0, N_TICKS)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")


def test_chunked_kstep_matches_one_prun(feature_mix):
    cfg, st0, (sj, mj), _ = feature_mix
    leaves, g = kernel.kinit(cfg, st0)
    at = 0
    for n in (20, 24, 20):
        leaves = kernel.kstep(cfg, leaves, at, n)
        at += n
    st, m = kernel.kfinish(cfg, leaves, g)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert kernel.kcommitted(cfg, leaves, g) == jrun.total_rounds(mj)
    assert kernel.kelections(cfg, leaves, g) == int(mj.elections)


def test_resume_from_carried_jax_state_matches_jax_continuation(
        feature_mix):
    """The JAX run's end state and metrics, carried across as numpy with
    their PreVote and TimeoutNow slots, continue on the port exactly as
    on the reference."""
    cfg, _, (sj, mj), (sj2, mj2) = feature_mix
    tree = jax.tree.map(np.asarray, sj)
    assert tree.mailbox.pv_resp_req_term is not None
    assert tree.mailbox.tn_term is not None
    st = state.from_numpy(tree, device="cpu")
    m = state.from_numpy(jax.tree.map(np.asarray, mj), device="cpu")
    st2, m2 = run.run(cfg, st, N_TICKS, N_TICKS, m)
    assert_same(sj2, st2, "run.run state")
    assert_same(mj2, m2, "run.run metrics")
    st3, m3 = kernel.prun(cfg, st, N_TICKS, N_TICKS, m)
    assert_same(sj2, st3, "kernel.prun state")
    assert_same(mj2, m3, "kernel.prun metrics")


def test_kreads_is_the_reads_done_sum(feature_mix):
    cfg, _, (sj, _), (sj2, _) = feature_mix
    for tree in (sj, sj2):
        st = state.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
        leaves, g = kernel.kinit(cfg, st)
        want = int(np.asarray(tree.nodes.reads_done, np.int64).sum())
        assert kernel.kreads(cfg, leaves, g) == want
    assert want > 0, "no read completed - the count is untested"
