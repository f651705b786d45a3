"""The port's safety fold on states that break it: a mid-run state with
one group planted for each predicate (raft_tpu_torch.verify.plant) goes
through one tick of the port and of the JAX package. Next states and
the `tick_safety` rows must be equal (tolerance 0), each planted group
must fail its own predicate and no other, and the safety lane of the
port's run and of its kernel wrapper must read 0 in exactly the planted
groups."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import check as jcheck
from raft_tpu.sim import state as jstate
from raft_tpu.sim import step as jstep
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import check, kernel, run, state, step
from raft_tpu_torch.verify import invariants as inv
from raft_tpu_torch.verify import plant

HEADLINE = dict(n_groups=8, seed=42)
T0 = 37   # every group's leader window overlaps a follower's prefix


def failing(ok: torch.Tensor) -> list:
    return (~ok.bool()).nonzero().flatten().tolist()


def test_planted_violations_fold_matches_jax():
    jcfg, cfg = JaxConfig(**HEADLINE), RaftConfig(**HEADLINE)
    sj = jstate.init(jcfg)
    for t in range(T0):
        sj = jstep.tick(jcfg, sj, t)
    st = state.from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    st, planted = plant.plant_violations(cfg, st)
    assert sorted(planted) == sorted(plant.KINDS)
    planted_np = state.to_numpy(st)
    leaves = jax.tree.leaves(planted_np)
    assert len(leaves) == len(jax.tree.leaves(sj))
    sj = jax.tree.unflatten(jax.tree.structure(sj),
                            [jnp.asarray(a) for a in leaves])

    sj1, st1 = jstep.tick(jcfg, sj, T0), step.tick(cfg, st, T0)
    ok, why = trees_equal_why(jax.tree.map(np.asarray, sj1),
                              state.to_numpy(st1))
    assert ok, why
    safe = check.tick_safety(st1, cfg.log_cap)
    np.testing.assert_array_equal(
        np.asarray(jcheck.tick_safety(sj1, jcfg.log_cap)), safe.numpy())
    assert failing(safe) == sorted(planted.values())

    n = st1.nodes
    fails = {
        "election_safety": failing(inv.election_safety(n.role, n.term)),
        "digest_agreement": failing(inv.digest_agreement(n.applied,
                                                         n.digest)),
        "window_bounds": failing(inv.window_bounds(
            n.applied, n.commit, n.snap_index, n.last_index, cfg.log_cap)),
        "leader_completeness": failing(inv.leader_completeness(
            n.role, n.term, n.commit, n.last_index, n.snap_index,
            n.log_payload, cfg.log_cap)),
    }
    for kind, g in planted.items():
        pred = kind if kind in fails else "leader_completeness"
        assert [p for p, gs in fails.items() if g in gs] == [pred], kind


def test_planted_violations_clear_safety_lane_in_run_and_wrapper():
    cfg = RaftConfig(**HEADLINE)
    st, m = run.run(cfg, state.init(cfg, device="cpu"), T0)
    st, planted = plant.plant_violations(cfg, st)
    _, m1 = run.run(cfg, st, 3, T0, m)
    assert failing(m1.safety) == sorted(planted.values())
    leaves, g = kernel.kinit(cfg, st, m)
    _, m2 = kernel.kfinish(cfg, kernel.kstep(cfg, leaves, T0, 3), g, m)
    assert torch.equal(m1.safety, m2.safety)
    assert run.unsafe_groups(m2) == len(plant.KINDS)
