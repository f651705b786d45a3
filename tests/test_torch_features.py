"""The port's plain tick (raft_tpu_torch.sim.step.tick) against the JAX
package's (raft_tpu.sim.step.tick) with the protocol features on —
PreVote, leadership transfer, membership change, scheduled ReadIndex
reads: full State equality after every tick, tolerance 0, on universes
taken from the reference's own tests. Each universe also shows that its
features fired (the sends of PreVote and TimeoutNow, a changed voter
set, completed reads, a term past the first elections), so the equality
is not vacuous."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from raft_tpu.config import CONFIG_FLAG
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import state as jstate
from raft_tpu.sim import step as jstep
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import state, step

# name: (config, ticks, the features that must fire)
UNIVERSES = {
    # tests/test_pkernel.py::test_feature_mix_bit_exact: all four
    # features with crash and drop
    "feature_mix_k3": (
        dict(n_groups=6, k=3, seed=47, prevote=True, reconfig_prob=0.8,
             reconfig_epoch=16, transfer_prob=0.7, transfer_epoch=24,
             read_every=4, crash_prob=0.15, crash_epoch=24, drop_prob=0.04,
             log_cap=8, compact_every=4), 100,
        ("prevote", "transfer", "membership", "reads", "term")),
    # tests/test_differential.py::test_differential_reads_with_reconfig
    "reads_reconfig": (
        dict(n_groups=2, seed=53, read_every=8, reconfig_prob=0.9,
             reconfig_epoch=32, crash_prob=0.2, crash_epoch=48), 64,
        ("membership", "reads")),
    # tests/test_differential.py::test_differential_transfer_reconfig
    "transfer_reconfig": (
        dict(n_groups=2, seed=61, transfer_prob=0.8, transfer_epoch=48,
             reconfig_prob=0.8, reconfig_epoch=40, crash_prob=0.15,
             crash_epoch=64), 80,
        ("transfer", "membership", "term")),
}


def fired(cfg, st) -> set:
    """The features this post-tick state shows at work."""
    n, mb = st.nodes, st.mailbox
    out = set()
    if mb.pv_req_present is not None and bool(mb.pv_req_present.any()):
        out.add("prevote")
    if mb.tn_present is not None and bool(mb.tn_present.any()):
        out.add("transfer")
    if bool((n.snap_voters != cfg.full_mask).any()
            or ((n.log_payload & CONFIG_FLAG) != 0).any()):
        out.add("membership")
    if int(n.reads_done.max()) > 0:
        out.add("reads")
    if int(n.term.max()) > 2:
        out.add("term")
    return out


def check_every_tick(name, kw, n_ticks, want):
    jcfg, cfg = JaxConfig(**kw), RaftConfig(**kw)
    sj = jstate.init(jcfg)
    st = state.init(cfg, device="cpu")
    seen = set()
    for t in range(n_ticks):
        sj = jstep.tick(jcfg, sj, t)
        st = step.tick(cfg, st, t)
        ok, why = trees_equal_why(jax.tree.map(np.asarray, sj),
                                  state.to_numpy(st))
        assert ok, f"{name}, tick {t}: {why}"
        seen |= fired(cfg, st)
    assert set(want) <= seen, f"{name}: {set(want) - seen} never fired"


@pytest.mark.parametrize("name", list(UNIVERSES))
def test_tick_matches_jax_every_tick(name):
    kw, n_ticks, want = UNIVERSES[name]
    check_every_tick(name, kw, n_ticks, want)
