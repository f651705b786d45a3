"""The frozen reference: a group's trajectory depends only on the config,
the seed and its global id, and the copy computes what the port's plain
tick computes. CPU only, small sizes.

    python -m pytest raftbench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest

from raftbench import refworker, spec
from raftbench.runner import tree_leaves
from raftbench.reference import recorder as ref_recorder
from raftbench.reference import run as ref_run
from raftbench.reference import state as ref_state
from raftbench.reference.config import RaftConfig as RefConfig

TICKS = 40
SEED = 2 ** 31 + 77   # more than 32 signed bits hold

# A universe of each cell's semantics, plus one with the features and
# faults no cell has yet (a later cell's).
UNIVERSES = {
    "raft5.steady": None,
    "raft5-sessions.clients-jepsen": None,
    "features": dict(k=5, prevote=True, read_every=4, transfer_prob=0.1,
                     transfer_epoch=16, reconfig_prob=0.1, reconfig_epoch=16,
                     crash_prob=0.2, crash_epoch=16, partition_prob=0.2,
                     partition_epoch=16, drop_prob=0.05),
}


def _fields(name: str) -> dict:
    f = UNIVERSES[name]
    f = spec.cell(name).fields if f is None else f
    return dict(f, seed=spec.config_seed(SEED))


def _flat(st, m, f) -> dict:
    out = {"state." + k: v.numpy() for k, v in tree_leaves(st).items()}
    out.update({"metrics." + k: v.numpy()
                for k, v in tree_leaves(m).items()
                if k in refworker.PER_GROUP_LANES})
    out.update({"flight." + k: v.numpy()
                for k, v in tree_leaves(f).items()})
    return out


def _ref(fields: dict, n: int, first: int = 0, ids=None) -> dict:
    cfg = RefConfig(n_groups=n if ids is None else len(ids), **fields)
    st = ref_state.init(cfg, n, device="cpu", first_group=first,
                        group_ids=ids)
    g = st.group_id.shape[0]
    m = ref_run.metrics_init(g, clients=cfg.clients_u32 != 0, device="cpu")
    f = ref_recorder.flight_init(g, 64, device="cpu")
    return _flat(*ref_recorder.run_recorded(cfg, st, TICKS, 0, m, f))


def _cols(arrs: dict, idx) -> dict:
    return {k: (v[:, idx] if k.startswith("flight.") else v[idx])
            for k, v in arrs.items()}


@pytest.mark.parametrize("name", sorted(UNIVERSES))
def test_trajectory_depends_only_on_seed_and_global_id(name):
    fields = _fields(name)
    whole = _ref(fields, 8, first=100)
    alone = _ref(fields, 0, ids=[105, 101])
    want = _cols(whole, [5, 1])
    assert set(alone) == set(want)
    for k in want:
        np.testing.assert_array_equal(alone[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(UNIVERSES))
def test_copy_agrees_with_the_ports_plain_tick(name):
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.obs import recorder
    from raft_tpu_torch.sim import run, state
    fields = _fields(name)
    cfg = RaftConfig(n_groups=6, **fields)
    st = state.init(cfg, 6, device="cpu", first_group=3)
    m = run.metrics_init(6, clients=cfg.clients_u32 != 0, device="cpu")
    f = recorder.flight_init(6, 64, device="cpu")
    port = _flat(*recorder.run_recorded(cfg, st, TICKS, 0, m, f))
    ref = _ref(fields, 6, first=3)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def test_refworker_output_is_the_reference_run():
    fields = _fields("raft5-sessions.clients-jepsen")
    out = refworker.reference_run(fields, TICKS, 64, [9, 4, 30])
    want = _cols(_ref(fields, 0, ids=[9, 4, 30]), slice(None))
    for k in want:
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)
    assert out["ops"] > 0 and out["group_bytes"] > 0
