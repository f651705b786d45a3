"""The port's scheduled client traffic against the JAX package, tolerance
0, on `raft_tpu.clients.clients_64_cfg()` (64 faulted k=3, L=8 groups,
three retrying exactly-once sessions each): the elementwise client
transition, payloads and table witness on seeded inputs (admission cap
off and on); the full State after every tick of 120, and the client
Metrics folded each tick; a run resumed from a carried JAX mid-run
state and metrics; and planted violations of the two exactly-once
clauses, each failing only its clause, in the port's fold, the JAX
package's and the kernel wrapper's."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.clients import clients_64_cfg
from raft_tpu.clients import workload as jworkload
from raft_tpu.clients.state import ClientState as JClientState
from raft_tpu.sim import check as jcheck
from raft_tpu.sim import state as jstate
from raft_tpu.sim import step as jstep
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.clients import workload
from raft_tpu_torch.clients.state import ClientState
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import check, kernel, run, state, step
from raft_tpu_torch.verify import invariants as inv
from raft_tpu_torch.verify import plant

jrun = importlib.import_module("raft_tpu.sim.run")

JCFG = clients_64_cfg()
KW = {f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)}
CFG = RaftConfig(**KW)
TICKS, RESUME_AT, PLANT_AT = 120, 60, 29


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


def failing(ok: torch.Tensor) -> list:
    return (~ok.bool()).nonzero().flatten().tolist()


@pytest.fixture(scope="module")
def trajectory():
    """The JAX tick's (State, Metrics) after every tick, as numpy; index
    0 is the initial pair."""
    update = jax.jit(jrun.metrics_update, static_argnums=2)
    sj, mj = jstate.init(JCFG), jrun.metrics_init(JCFG.n_groups, clients=True)
    out = [(jax.tree.map(np.asarray, sj), jax.tree.map(np.asarray, mj))]
    for t in range(TICKS):
        sj = jstep.tick(JCFG, sj, t)
        mj = update(mj, sj, JCFG.log_cap)
        out.append((jax.tree.map(np.asarray, sj),
                    jax.tree.map(np.asarray, mj)))
    return out


def _client_inputs(rs, g, s, cap):
    """A seeded client state and table witness covering every branch:
    acks, retries past the backoff, starts, full backlogs at the cap."""
    done = rs.integers(0, 40, (g, s))
    inflight = rs.integers(0, 2, (g, s))
    cols = dict(done=done, backlog=rs.integers(0, max(cap, 4) + 1, (g, s)),
                inflight=inflight, t_start=rs.integers(60, 100, (g, s)),
                t_sub=rs.integers(80, 100, (g, s)),
                submit=rs.integers(0, 2, (g, s)),
                retries=rs.integers(0, 9, (g, s)),
                last_lat=rs.integers(-1, 30, (g, s)))
    if cap:
        cols["shed"] = rs.integers(0, 5, (g, s))
    cols = {k: v.astype(np.int32) for k, v in cols.items()}
    tmax = (done + rs.integers(-3, 2, (g, s))).astype(np.int32)
    return cols, tmax


@pytest.mark.parametrize("cap", [0, 2])
def test_client_update_and_payloads_match_jax(cap):
    jcfg = dataclasses.replace(JCFG, client_queue_cap=cap)
    cfg = dataclasses.replace(CFG, client_queue_cap=cap)
    rs = np.random.default_rng(3 + cap)
    g, s = 48, cfg.client_slots
    gcol = np.arange(5, 5 + g, dtype=np.int32)[:, None]
    scol = np.arange(s, dtype=np.int32)[None, :]
    seen = {"acked": 0, "retry": 0, "shed": 0}
    for t in (100, 104, 106, 111):
        cols, tmax = _client_inputs(rs, g, s, cap)
        jcs = jworkload.client_update(
            jcfg, JClientState(**{k: jnp.asarray(v) for k, v in cols.items()}),
            jnp.asarray(tmax), jnp.asarray(gcol), jnp.asarray(scol), t)
        cs = workload.client_update(
            cfg, ClientState(**{k: torch.from_numpy(v)
                                for k, v in cols.items()}),
            torch.from_numpy(tmax), torch.from_numpy(gcol),
            torch.from_numpy(scol), t)
        assert_same(jcs, cs, f"client_update t={t}")
        jsub, jpay = jworkload.submit_payloads(jcfg, jcs, jnp.asarray(gcol),
                                               jnp.asarray(scol))
        sub, pay = workload.submit_payloads(cfg, cs, torch.from_numpy(gcol),
                                            torch.from_numpy(scol))
        np.testing.assert_array_equal(np.asarray(jsub), sub.numpy())
        np.testing.assert_array_equal(np.asarray(jpay), pay.numpy())
        assert pay.dtype == torch.int32
        seen["acked"] += int((cs.last_lat >= 0).sum())
        seen["retry"] += int((cs.retries > torch.from_numpy(
            cols["retries"])).sum())
        if cap:
            seen["shed"] += int((cs.shed > torch.from_numpy(
                cols["shed"])).sum())
    assert seen["acked"] and seen["retry"] and (seen["shed"] or not cap), seen
    table = rs.integers(-1, 30, (g, cfg.k, s)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jworkload.table_max(jnp.asarray(table), node_axis=1)),
        workload.table_max(torch.from_numpy(table), 1).numpy())


def test_init_matches_jax_with_clients(trajectory):
    for cap in (0, 2):
        cfg = dataclasses.replace(CFG, client_queue_cap=cap)
        jcfg = dataclasses.replace(JCFG, client_queue_cap=cap)
        st = state.init(cfg, device="cpu")
        assert_same(jstate.init(jcfg), st, f"init, cap {cap}")
        assert (st.clients.shed is None) == (cap == 0)
        assert st.mailbox.is_req_snap_sessions.shape == (64, 3, 3, 3)
    assert_same(trajectory[0][1],
                run.metrics_init(CFG.n_groups, clients=True, device="cpu"),
                "metrics_init")


def test_tick_matches_jax_every_tick_with_clients(trajectory):
    st = state.init(CFG, device="cpu")
    m = run.metrics_init(CFG.n_groups, clients=True, device="cpu")
    for t in range(TICKS):
        st = step.tick(CFG, st, t)
        m = run.metrics_update(m, st, CFG.log_cap)
        ok, why = trees_equal_why(trajectory[t + 1][0], state.to_numpy(st))
        assert ok, f"tick {t}: {why}"
    assert_same(trajectory[-1][1], m, "metrics after every tick")
    assert run.total_client_retries(m) > 0 and run.total_client_ops(m) > 0
    assert int(m.client_hist.sum()) == run.total_client_ops(m)
    assert run.unsafe_groups(m) == 0
    installed = (st.nodes.snap_session_seq >= 0).sum()
    assert int(installed) > 0, "no dedup table reached a snapshot"


def test_resume_from_carried_jax_state_matches_jax_continuation(trajectory):
    """The JAX state and metrics at tick 60, carried across as numpy with
    their session tables, IS payload and client state, continue on the
    port (run.run and the kernel wrapper) exactly as on the reference."""
    tree, mtree = trajectory[RESUME_AT]
    assert tree.clients is not None and tree.mailbox.is_req_snap_sessions \
        is not None
    st = state.from_numpy(tree, device="cpu")
    m = state.from_numpy(mtree, device="cpu")
    assert_same(tree, st, "carried state")
    want_s, want_m = trajectory[TICKS]
    st2, m2 = run.run(CFG, st, TICKS - RESUME_AT, RESUME_AT, m)
    assert_same(want_s, st2, "run.run state")
    assert_same(want_m, m2, "run.run metrics")
    st3, m3 = kernel.prun(CFG, st, TICKS - RESUME_AT, RESUME_AT, m)
    assert_same(want_s, st3, "kernel.prun state")
    assert_same(want_m, m3, "kernel.prun metrics")


def _clause_failures(st):
    """Groups failing each predicate of the fold, the two exactly-once
    clauses apart."""
    n, done = st.nodes, st.clients.done
    phantom = (n.session_seq <= done[:, None, :]).all(-1).all(-1)
    divergent = torch.zeros_like(phantom)
    for a in range(CFG.k):
        for b in range(a + 1, CFG.k):
            divergent |= ((n.applied[:, a] == n.applied[:, b])
                          & (n.session_seq[:, a] != n.session_seq[:, b])
                          .any(-1))
    return {
        "election_safety": failing(inv.election_safety(n.role, n.term)),
        "digest_agreement": failing(inv.digest_agreement(n.applied,
                                                         n.digest)),
        "window_bounds": failing(inv.window_bounds(
            n.applied, n.commit, n.snap_index, n.last_index, CFG.log_cap)),
        "leader_completeness": failing(inv.leader_completeness(
            n.role, n.term, n.commit, n.last_index, n.snap_index,
            n.log_payload, CFG.log_cap)),
        "client_phantom": failing(phantom),
        "client_divergent": failing(~divergent),
    }


def test_planted_client_violations_fold_matches_jax(trajectory):
    tree, mtree = trajectory[PLANT_AT]
    st, planted = plant.plant_violations(
        CFG, state.from_numpy(tree, device="cpu"))
    assert sorted(planted) == sorted(plant.kinds(CFG))
    leaves = jax.tree.leaves(state.to_numpy(st))
    sj = jax.tree.unflatten(jax.tree.structure(jstate.init(JCFG)),
                            [jnp.asarray(a) for a in leaves])
    sj1, st1 = jstep.tick(JCFG, sj, PLANT_AT), step.tick(CFG, st, PLANT_AT)
    assert_same(sj1, st1, "planted state after a tick")
    safe = check.tick_safety(st1, CFG.log_cap)
    np.testing.assert_array_equal(
        np.asarray(jcheck.tick_safety(sj1, JCFG.log_cap)), safe.numpy())
    np.testing.assert_array_equal(np.asarray(jcheck.client_safety(sj1)),
                                  check.client_safety(st1).numpy())
    assert failing(safe) == sorted(planted.values())
    fails = _clause_failures(st1)
    for kind, g in planted.items():
        pred = kind if kind in fails else "leader_completeness"
        assert [p for p, gs in fails.items() if g in gs] == [pred], kind

    m = state.from_numpy(mtree, device="cpu")
    _, m1 = run.run(CFG, st, 3, PLANT_AT, m)
    assert failing(m1.safety) == sorted(planted.values())
    leaves, g = kernel.kinit(CFG, st, m)
    _, m2 = kernel.kfinish(CFG, kernel.kstep(CFG, leaves, PLANT_AT, 3), g, m)
    assert torch.equal(m1.safety, m2.safety)
