"""The port's loop, metrics and kernel wrapper against the JAX package:
full State and Metrics (committed, leaderless, elections, histogram,
max_latency, safety) of `raft_tpu_torch.sim.run.run` equal
`raft_tpu.sim.run.run`; `raft_tpu_torch.sim.kernel.prun` on CPU tensors
equals both `run.run` and `pkernel.prun(interpret=True)`; chunk
boundaries are invisible; a run resumed from a carried-across mid-run
JAX state equals the JAX continuation. Tolerance 0 throughout."""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import pkernel
from raft_tpu.sim import state as jstate
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, run, state

# The module (raft_tpu.sim re-exports its `run` function under that name).
jrun = importlib.import_module("raft_tpu.sim.run")

# tests/test_pkernel.py::test_fault_mix_bit_exact's universe: the JAX
# scan and interpret-mode kernel programs the suite already compiles.
FAULT_MIX = dict(n_groups=16, k=3, seed=7, drop_prob=0.05, crash_prob=0.1,
                 crash_epoch=16, partition_prob=0.2, partition_epoch=16,
                 log_cap=8, compact_every=4)
N_TICKS = 56


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def fault_mix():
    """(cfg, torch init, JAX run.run result) of the fault-mix universe."""
    jcfg = JaxConfig(**FAULT_MIX)
    return (RaftConfig(**FAULT_MIX), state.init(RaftConfig(**FAULT_MIX),
                                                device="cpu"),
            jrun.run(jcfg, jstate.init(jcfg), N_TICKS))


def test_run_matches_jax_run(fault_mix):
    cfg, st0, (sj, mj) = fault_mix
    st, m = run.run(cfg, st0, N_TICKS)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert int(m.elections) > 0 and int(m.hist.sum()) == int(m.elections)
    assert int(m.safety.min()) == 1


def test_kernel_prun_cpu_matches_run_and_interpret_pkernel(fault_mix):
    cfg, st0, (sj, mj) = fault_mix
    st, m = kernel.prun(cfg, st0, N_TICKS)
    assert_same(sj, st, "state vs run.run")
    assert_same(mj, m, "metrics vs run.run")
    jcfg = JaxConfig(**FAULT_MIX)
    sp, mp = pkernel.prun(jcfg, jstate.init(jcfg), N_TICKS, interpret=True)
    assert_same(sp, st, "state vs pkernel.prun")
    assert_same(mp, m, "metrics vs pkernel.prun")


def test_chunked_kstep_matches_one_prun(fault_mix):
    cfg, st0, (sj, mj) = fault_mix
    leaves, g = kernel.kinit(cfg, st0)
    at = 0
    for n in (20, 16, 20):
        leaves = kernel.kstep(cfg, leaves, at, n)
        at += n
    st, m = kernel.kfinish(cfg, leaves, g)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert kernel.kcommitted(cfg, leaves, g) == jrun.total_rounds(mj)
    assert kernel.kelections(cfg, leaves, g) == int(mj.elections)
    np.testing.assert_array_equal(kernel.khist(cfg, leaves, g),
                                  np.asarray(mj.hist))


def test_resume_from_carried_jax_state_matches_jax_continuation(fault_mix):
    """The JAX run's end state and metrics, carried across as numpy,
    continue on the port exactly as on the reference."""
    cfg, _, (sj, mj) = fault_mix
    jcfg = JaxConfig(**FAULT_MIX)
    sj2, mj2 = jrun.run(jcfg, sj, N_TICKS, N_TICKS, mj)
    st = state.from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    m = state.from_numpy(jax.tree.map(np.asarray, mj), device="cpu")
    st2, m2 = run.run(cfg, st, N_TICKS, N_TICKS, m)
    assert_same(sj2, st2, "run.run state")
    assert_same(mj2, m2, "run.run metrics")
    st3, m3 = kernel.prun(cfg, st, N_TICKS, N_TICKS, m)
    assert_same(sj2, st3, "kernel.prun state")
    assert_same(mj2, m3, "kernel.prun metrics")


def test_metric_readouts_match_jax(fault_mix):
    cfg, st0, (_, mj) = fault_mix
    _, m = run.run(cfg, st0, N_TICKS)
    assert run.total_rounds(m) == jrun.total_rounds(mj)
    assert run.unsafe_groups(m) == jrun.unsafe_groups(mj)
    for q in (0.5, 0.9, 0.99):
        assert run.latency_quantile(m.hist, q) == \
            jrun.latency_quantile(mj.hist, q)
        assert run.latency_censored(m.hist, q) == \
            jrun.latency_censored(mj.hist, q)
    h = np.zeros(run.HIST_SIZE, np.int32)
    h[-1] = 3
    assert run.latency_censored(torch.from_numpy(h), 0.5)
    assert jrun.latency_censored(h, 0.5)


def test_kernel_prun_cpu_matches_run_at_headline_width():
    """k=5, L=32, E=4: the wrapper's wire boundary and its plain version
    against the port's run (itself held to the JAX tick per tick in
    test_torch_step.py)."""
    cfg = RaftConfig(n_groups=8, seed=42)
    st0 = state.init(cfg, device="cpu")
    st, m = run.run(cfg, st0, 48)
    leaves, g = kernel.kinit(cfg, st0)
    for at in (0, 24):
        leaves = kernel.kstep(cfg, leaves, at, 24)
    st2, m2 = kernel.kfinish(cfg, leaves, g)
    for a, b in ((st, st2), (m, m2)):
        ok, why = trees_equal_why(state.to_numpy(a), state.to_numpy(b))
        assert ok, why
    assert int(m.committed.min()) > 0


def test_kstep_refuses_what_it_does_not_take():
    cfg = RaftConfig(n_groups=4, k=3, log_cap=8, compact_every=4)
    leaves, _ = kernel.kinit(cfg, state.init(cfg, device="cpu"))
    wire, acc = leaves
    with pytest.raises(ValueError):
        kernel.kstep(cfg, (wire.to(torch.int64), acc), 0, 1)
    with pytest.raises(ValueError):
        kernel.kstep(cfg, (wire[:-1].contiguous(), acc), 0, 1)
    with pytest.raises(ValueError):
        kernel.kstep(cfg, (wire.T, acc), 0, 1)
    with pytest.raises(ValueError):
        kernel.kstep(cfg, (wire,), 0, 1)
    with pytest.raises(ValueError):
        kernel.kstep(cfg, (wire.to("meta"), acc.to("meta")), 0, 1)
