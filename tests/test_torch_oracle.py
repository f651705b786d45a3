"""The port's CPU oracle (`raft_tpu_torch.core`, with `HostClients`)
against the JAX package's, snapshot for snapshot, and the port's plain
tick against its own oracle (`obs.triage.oracle_divergence` on the CPU),
tolerance 0, on five universes: the default protocol under every fault
class (tests/test_differential.py's fast all-faults universe), the
flagship feature mix, scheduled exactly-once clients
(`clients_64_cfg`'s knobs), the all-kinds nemesis program and the
pressure mix with bounded admission (tests/test_nemesis.py's oracle
universes, 8 groups of which the oracle runs 4). No XLA compile, except
the port's `sim.run.trace` against the reference's on
tests/test_differential.py's `test_comparator_has_teeth` universe (one
group, 60 ticks: one program that file also compiles)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from raft_tpu import nemesis as jnem
from raft_tpu import sim as jsim
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.core.cluster import Cluster as JaxCluster
from raft_tpu.sim.run import trace as jtrace
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import Cluster
from raft_tpu_torch.core.cluster import NodeView
from raft_tpu_torch.obs.triage import oracle_divergence, oracle_trace
from raft_tpu_torch.sim import run, state
from test_torch_nemesis import ADMISSION, BASE, all_kinds

from jax_programs import release_jax_programs  # noqa: F401

ALL_FAULTS = dict(seed=24, drop_prob=0.05, crash_prob=0.2, crash_epoch=48,
                  partition_prob=0.3, partition_epoch=64)
FEATURE_MIX = dict(seed=1, drop_prob=0.05, crash_prob=0.2, crash_epoch=8,
                   partition_prob=0.2, partition_epoch=8, prevote=True,
                   read_every=8, reconfig_prob=0.3, reconfig_epoch=16,
                   transfer_prob=0.3, transfer_epoch=16)
CLIENTS = dict(k=3, seed=29, log_cap=8, compact_every=4, sessions=True,
               cmds_per_tick=0, client_rate=0.3, client_slots=3,
               client_retry_backoff=5, drop_prob=0.05, crash_prob=0.2,
               crash_epoch=16, partition_prob=0.2, partition_epoch=16)

# (id, knobs with the program built by the given nemesis module, groups
# of the batched run, groups of the oracle, ticks)
UNIVERSES = [
    ("all_faults", lambda mod: ALL_FAULTS, 2, 2, 200),
    ("feature_mix", lambda mod: FEATURE_MIX, 2, 2, 200),
    ("clients", lambda mod: CLIENTS, 4, 4, 160),
    ("all_kinds", lambda mod: dict(BASE, nemesis=all_kinds(mod, 120)),
     8, 4, 120),
    ("pressure_mix",
     lambda mod: dict(ADMISSION, nemesis=mod.pressure_mix(120)), 8, 4, 120),
]
IDS = [u[0] for u in UNIVERSES]


def oracle_state(c) -> dict:
    """Everything one oracle group holds beyond its snapshots: every
    attribute of every node (log, tables, timers, reads), the
    commit-identity map, the apply count and the host clients."""
    out = {"committed": dict(c._committed), "applies": c.total_applies,
           "nodes": [{k: v for k, v in vars(n).items()
                      if k not in ("cfg", "transport", "on_apply")}
                     for n in c.nodes]}
    if c.clients is not None:
        out["clients"] = {k: v for k, v in vars(c.clients).items()
                          if k != "cfg"}
    return out


@pytest.mark.parametrize("u", UNIVERSES, ids=IDS)
def test_cluster_snapshots_match_the_reference(u):
    _, knobs, _, g_oracle, ticks = u
    cfg, jcfg = RaftConfig(**knobs(nemesis)), JaxConfig(**knobs(jnem))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for g in range(g_oracle):
        mine, ref = Cluster(cfg, group=g), JaxCluster(jcfg, group=g)
        for t in range(ticks):
            mine.tick()
            ref.tick()
            a = [dataclasses.astuple(v) for v in mine.snapshot()]
            b = [dataclasses.astuple(v) for v in ref.snapshot()]
            assert a == b, f"group {g} diverges at tick {t}: {a} != {b}"
        assert oracle_state(mine) == oracle_state(ref), f"group {g}"
    assert all(isinstance(v, NodeView) for v in mine.snapshot())


def test_host_clients_ack_and_retry():
    """The clients universe is not vacuous on the oracle: ops are acked,
    and retried after a lost submission."""
    cfg = RaftConfig(**CLIENTS)
    c = Cluster(cfg, group=0)
    c.run(160)
    assert sum(c.clients.done) > 10 and sum(c.clients.retries) > 0
    assert len(c.clients.latencies) == sum(c.clients.done)


@pytest.mark.parametrize("u", UNIVERSES, ids=IDS)
def test_plain_tick_in_lockstep_with_the_oracle(u):
    _, knobs, g, g_oracle, ticks = u
    cfg = RaftConfig(**knobs(nemesis))
    assert oracle_divergence(cfg, g, ticks, oracle_groups=g_oracle,
                             device="cpu") is None


def test_oracle_divergence_names_the_first_drift(monkeypatch):
    """The comparator has teeth: one batched trace cell off by one is
    reported with its tick, group, node, field and both values."""
    cfg = RaftConfig(**ALL_FAULTS)
    true_trace = run.trace

    def drifted(*a, **kw):
        st, tr = true_trace(*a, **kw)
        tr["commit"][25, 1, 3] += 1
        return st, tr

    monkeypatch.setattr(run, "trace", drifted)
    rep = oracle_divergence(cfg, 2, 40, device="cpu")
    assert rep is not None
    assert (rep["tick"], rep["group"], rep["node"], rep["field"]) \
        == (25, 1, 3, "commit")
    assert rep["batched"] == rep["cpu"] + 1


def test_trace_matches_the_reference():
    """The port's `trace` against `raft_tpu.sim.run.trace` at
    test_differential.py's `test_comparator_has_teeth` shape, and both
    against the oracle."""
    jcfg, cfg = JaxConfig(seed=7), RaftConfig(seed=7)
    sj, ref = jtrace(jcfg, jsim.init(jcfg, n_groups=1), 60)
    st, mine = run.trace(cfg, state.init(cfg, 1, device="cpu"), 60)
    assert set(mine) == set(ref) == set(run.TRACE_FIELDS) | {"alive"}
    for f, want in ref.items():
        want = np.asarray(want)
        got = mine[f].numpy()
        assert got.shape == want.shape == (60, 1, 5), f
        assert np.array_equal(got.astype(np.int64),
                              want.astype(np.int64)), f
    assert mine["alive"].dtype == state.BOOL
    cpu, _ = oracle_trace(cfg, 1, 60)
    for f in cpu:
        assert np.array_equal(cpu[f], mine[f].numpy().astype(np.int64)), f
    assert int(st.nodes.commit.max()) > 20
