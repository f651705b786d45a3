"""The port's plain tick (raft_tpu_torch.sim.step.tick) against the JAX
package's (raft_tpu.sim.step.tick): full State equality after every
tick, tolerance 0, on five universes — the kernel fault mix, the
headline width, the config-4 fault knobs at headline width, the
election-rounds knobs (no commands: leaders only heartbeat), and the
multi-source AppendEntries universe. Also: every feature the port does
not carry yet (the layout dials, cohort streaming) is refused when the
config is built while a nemesis program is accepted, and the config
validation (the client-traffic rules included) is the reference's."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import state as jstate
from raft_tpu.sim import step as jstep
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import state, step

UNIVERSES = {
    # tests/test_pkernel.py::test_fault_mix_bit_exact
    "fault_mix": (dict(n_groups=16, k=3, seed=7, drop_prob=0.05,
                       crash_prob=0.1, crash_epoch=16, partition_prob=0.2,
                       partition_epoch=16, log_cap=8, compact_every=4), 56),
    # the headline width: k=5, L=32, E=4
    "headline": (dict(n_groups=8, seed=42), 64),
    # bench.py config-4 fault knobs at headline width
    "config4": (dict(n_groups=8, seed=43, crash_prob=0.3, crash_epoch=64,
                     partition_prob=0.2, partition_epoch=64,
                     drop_prob=0.02), 140),
    # bench.py bench_election_rounds: no client commands, crash 0.5/32
    "election_rounds": (dict(n_groups=8, seed=44, cmds_per_tick=0,
                             crash_prob=0.5, crash_epoch=32), 160),
    # tests/test_differential.py::test_differential_multi_source_ae_tick
    "multi_source_ae": (dict(n_groups=2, seed=15, k=3, log_cap=8,
                             compact_every=4, crash_prob=0.2, crash_epoch=40,
                             partition_prob=0.6, partition_epoch=40,
                             drop_prob=0.05), 400),
}


@pytest.mark.parametrize("name", list(UNIVERSES))
def test_tick_matches_jax_every_tick(name):
    kw, n_ticks = UNIVERSES[name]
    jcfg, cfg = JaxConfig(**kw), RaftConfig(**kw)
    sj = jstate.init(jcfg)
    st = state.init(cfg, device="cpu")
    terms = 0
    for t in range(n_ticks):
        sj = jstep.tick(jcfg, sj, t)
        st = step.tick(cfg, st, t)
        ok, why = trees_equal_why(jax.tree.map(np.asarray, sj),
                                  state.to_numpy(st))
        assert ok, f"{name}, tick {t}: {why}"
        terms = max(terms, int(st.nodes.term.max()))
    if kw.get("cmds_per_tick", 1):
        assert int(st.nodes.commit.max()) > 0, "nothing committed - vacuous"
    if name != "headline":
        assert terms > 1, "no leadership churn - fault paths untested"


UNPORTED = [
    dict(narrow_scalars=True), dict(narrow_ring=True),
    dict(narrow_mailbox=True), dict(narrow_clients=True),
    dict(donate_scan=True), dict(pack_bools=True), dict(pack_ring=True),
    dict(alias_wire=True), dict(wire_hist=False), dict(stream_groups=True),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: next(iter(kw)))
def test_unported_feature_refused_at_construction(kw):
    with pytest.raises(NotImplementedError, match="does not port"):
        RaftConfig(**kw)


def test_nemesis_program_accepted_layout_dial_still_refused():
    prog = ((1, 0, 10, 1, 1, 1, 0, 0),)
    assert RaftConfig(nemesis=prog).nemesis == JaxConfig(nemesis=prog).nemesis
    with pytest.raises(NotImplementedError, match="does not port"):
        RaftConfig(nemesis=prog, pack_ring=True)


CLIENTS = dict(sessions=True, cmds_per_tick=0, client_rate=0.1)


@pytest.mark.parametrize("kw", [dict(log_cap=8), dict(election_min=4),
                                dict(max_entries_per_msg=40),
                                dict(k=0), dict(heartbeat_every=0),
                                dict(sessions=True, cmds_per_tick=1),
                                dict(client_rate=0.1),
                                dict(CLIENTS, client_slots=0),
                                dict(CLIENTS, client_slots=17),
                                dict(client_queue_cap=2)])
def test_validation_matches_reference(kw):
    with pytest.raises(AssertionError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        RaftConfig(**kw)


def test_config_fields_and_thresholds_match_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(RaftConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    kw = dict(seed=43, crash_prob=0.3, partition_prob=0.2, drop_prob=1.0,
              sessions=True, cmds_per_tick=0, client_rate=0.37,
              client_queue_cap=3)
    a, b = RaftConfig(**kw), JaxConfig(**kw)
    for p in ("crash_u32", "partition_u32", "drop_u32", "majority",
              "full_mask", "clients_u32"):
        assert getattr(a, p) == getattr(b, p), p
