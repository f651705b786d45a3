"""The port's comparator (`utils/trees.py`), safety predicates
(`sim/check.py`, `verify/invariants.py`), `config_hash` and
`bisect_divergence` against the JAX package's, tolerance 0 (messages
compared as strings). No XLA compile: the reference's comparator and
predicates run on numpy leaves, and both engines of the bisection are
the port's on CPU tensors (the kernel wrapper runs its plain version
there)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.obs.manifest import config_hash as jconfig_hash
from raft_tpu.sim import check as jcheck
from raft_tpu.utils import trees as jtrees
from raft_tpu.verify import invariants as jinv
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.nemesis import search as nsearch
from raft_tpu_torch.obs.manifest import config_hash
from raft_tpu_torch.obs.triage import bisect_divergence
from raft_tpu_torch.sim import check, run, state
from raft_tpu_torch.utils import trees
from raft_tpu_torch.verify import invariants as inv
from raft_tpu_torch.verify import plant
from test_torch_nemesis import ADMISSION, BASE

PREVOTE = dict(BASE, prevote=True, transfer_prob=0.3, transfer_epoch=16)


@pytest.fixture(scope="module")
def states():
    """Mid-run port states: clients with bounded admission (optional
    client leaves and IS table present) and PreVote + transfer (the
    optional mailbox slots present)."""
    out = {}
    for name, knobs in (("clients", ADMISSION), ("prevote", PREVOTE)):
        cfg = RaftConfig(**knobs)
        out[name] = (cfg, run.run(cfg, state.init(cfg, 48, device="cpu"),
                                  40)[0])
    return out


def _pairs(states):
    """(id, a, b): state pairs covering every outcome of the
    comparator."""
    _, st = states["clients"]
    _, pv = states["prevote"]
    n = st.nodes
    term = n.term.clone()
    term[3, 1] += 4
    digest = n.digest.clone()
    digest[5, 2] ^= 0xFFFF0000   # a u32 lane: int64 in the port
    return [
        ("equal", st, st._replace(nodes=n._replace(term=n.term.clone()))),
        ("one_leaf", st, st._replace(nodes=n._replace(term=term))),
        ("u32_leaf", st, st._replace(nodes=n._replace(digest=digest))),
        ("dtype", st, st._replace(nodes=n._replace(
            commit=n.commit.to(torch.int16)))),
        ("shape", st, st._replace(nodes=n._replace(
            log_term=n.log_term[:, :, :4]))),
        ("leaf_count", st, st._replace(clients=None)),
        ("mailbox_slots", st, pv),
        ("scalar", (st.group_id[0], n.term), (st.group_id[1], n.term)),
        ("dict", {"b": n.term, "a": n.commit}, {"a": n.commit, "b": term}),
    ]


@pytest.mark.parametrize("values_only", [False, True])
def test_trees_equal_why_matches_the_reference(states, values_only):
    for name, a, b in _pairs(states):
        ja, jb = (trees.named_leaves(x) and _numpy(x) for x in (a, b))
        want = jtrees.trees_equal_why(ja, jb, values_only=values_only)
        got = trees.trees_equal_why(a, b, values_only=values_only)
        assert got == want, name
        assert trees.trees_equal_why(ja, jb, values_only=values_only) \
            == want, f"{name}, numpy leaves"
        assert trees.trees_equal(a, b) == jtrees.trees_equal(ja, jb)
        assert trees.trees_equal_values(a, b) \
            == jtrees.trees_equal_values(ja, jb)
    assert not trees.trees_equal(*_pairs(states)[1][1:])


def _numpy(tree):
    """A tree with every tensor leaf as `state.to_numpy` gives it."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return state._torch_to_np(tree)
    return tree


def test_leaf_names_and_override(states):
    _, st = states["clients"]
    names = [p for p, _ in trees.named_leaves(st)]
    assert names[0] == ".nodes.term" and ".clients.done" in names
    assert ".mailbox.pv_req_present" not in names   # a None slot
    ok, why = trees.trees_equal_why((st.nodes.term,), (st.nodes.commit,),
                                    names=("term",))
    assert why == jtrees.trees_equal_why(
        (_numpy(st.nodes.term),), (_numpy(st.nodes.commit),),
        names=("term",))[1]
    assert not ok and why.startswith("first divergent leaf: term — ")


@pytest.fixture(scope="module")
def planted():
    """Fault-free mid-run states (tick 37, as tests/test_torch_plant.py
    plants them) with one group planted per predicate: the headline
    universe, and scheduled clients behind an admission cap."""
    out = {}
    for name, knobs, g in (
            ("headline", dict(seed=42), 8),
            ("clients", dict(seed=42, sessions=True, cmds_per_tick=0,
                             client_rate=0.1, client_slots=2,
                             client_queue_cap=4), 16)):
        cfg = RaftConfig(**knobs)
        st, _ = run.run(cfg, state.init(cfg, g, device="cpu"), 37)
        st, groups = plant.plant_violations(cfg, st)
        out[name] = (cfg, st, groups)
    return out


def test_predicate_report_matches_the_reference(planted):
    for name, (cfg, st, groups) in planted.items():
        mine = check.predicate_report(st, cfg.log_cap)
        ref = jcheck.predicate_report(state.to_numpy(st), cfg.log_cap)
        assert list(mine) == list(ref), name
        for k in ref:
            assert np.array_equal(mine[k].numpy(), np.asarray(ref[k])), \
                (name, k)
        for fn, jfn in ((check.all_invariants, jcheck.all_invariants),
                        (check.tick_safety, jcheck.tick_safety)):
            ok = fn(st, cfg.log_cap).numpy()
            assert np.array_equal(ok, np.asarray(jfn(state.to_numpy(st),
                                                     cfg.log_cap)))
        assert sorted(np.flatnonzero(~ok).tolist()) \
            == sorted(groups.values()), name


def _log_grid(seed: int, g=64, k=3, cap=6):
    """Small random logs whose windows, terms and payloads collide often,
    so both checker predicates fail in some groups and hold in others."""
    r = np.random.default_rng(seed)
    snap = r.integers(0, 5, (g, k)).astype(np.int32)
    last = snap + r.integers(0, cap + 1, (g, k)).astype(np.int32)
    commit = np.minimum(last, snap + r.integers(0, cap + 1, (g, k)))
    return dict(snap_index=snap, last_index=last,
                commit=commit.astype(np.int32),
                log_term=r.integers(0, 2, (g, k, cap)).astype(np.int32),
                log_payload=r.integers(0, 2, (g, k, cap)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checker_predicates_match_the_reference(seed):
    d = _log_grid(seed)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    lm = inv.log_matching(t["last_index"], t["snap_index"], t["log_term"],
                          t["log_payload"], 6).numpy()
    jlm = jinv.log_matching(d["last_index"], d["snap_index"],
                            d["log_term"], d["log_payload"], 6)
    cd = inv.commit_durability(t["commit"], t["last_index"],
                               t["snap_index"], t["log_payload"], 6).numpy()
    jcd = jinv.commit_durability(d["commit"], d["last_index"],
                                 d["snap_index"], d["log_payload"], 6)
    assert np.array_equal(lm, jlm) and np.array_equal(cd, jcd)
    assert 0 < lm.sum() < lm.size and 0 < cd.sum() < cd.size


def test_config_hash_and_dict_match_the_reference():
    """The embedded config dict and its hash: the checked-in reproducer's
    config, and a config with every dial set."""
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "..",
                        "NEMESIS_repro_example.json")
    with open(path) as fh:
        example = json.load(fh)["config"]
    every = dict(
        n_groups=3, k=3, log_cap=10, max_entries_per_msg=3,
        heartbeat_every=3, election_min=12, election_range=7,
        compact_every=5, cmds_per_tick=0, sessions=True, seed=123,
        client_rate=0.25, client_slots=5, client_retry_backoff=6,
        client_queue_cap=7, drop_prob=0.01, crash_prob=0.02, crash_epoch=9,
        partition_prob=0.03, partition_epoch=11, reconfig_prob=0.04,
        reconfig_epoch=13, min_voters=2, transfer_prob=0.05,
        transfer_epoch=17, read_every=3, prevote=True, pack_bools=True,
        pack_ring=True, alias_wire=True, wire_hist=False,
        stream_groups=True, cohort_blocks=2, narrow_scalars=True,
        narrow_ring=True, narrow_mailbox=True, narrow_clients=True,
        donate_scan=True,
        nemesis=[list(c) for c in nemesis.program(
            nemesis.gray_mix(50)[0], nemesis.clock_skew(3, 9, amount=-4),
            nemesis.pressure_mix(40)[1])])
    assert set(every) == {f.name for f in dataclasses.fields(RaftConfig)}
    for knobs in (example, every, {}):
        cfg, jcfg = RaftConfig(**knobs), JaxConfig(**knobs)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert json.dumps(dataclasses.asdict(cfg), sort_keys=True) \
            == json.dumps(dataclasses.asdict(jcfg), sort_keys=True)
        assert config_hash(cfg) == jconfig_hash(jcfg)
    assert config_hash(RaftConfig(**every)) == config_hash(RaftConfig(
        **dict(every, pack_bools=False, stream_groups=False,
               narrow_ring=False)))


# ------------------------------------------------------------ bisection

GRAY = dict(BASE, nemesis=nemesis.gray_mix(32))


def _snapshot(st):
    return [t.clone() for _, t in trees.named_leaves(st)]


def test_plain_and_kernel_engines_agree_and_leave_their_input():
    cfg = RaftConfig(**GRAY)
    st0 = state.init(cfg, 8, device="cpu")
    before = _snapshot(st0)
    plain, kern = nsearch.plain_vs_kernel(cfg)
    assert bisect_divergence(plain, kern, st0, 32, chunk=8) is None
    assert trees.trees_equal(before, _snapshot(st0))


@pytest.mark.parametrize("engine", ["plain", "kernel"])
def test_an_injected_term_bump_is_named(engine):
    """A term bump injected into an engine is bisected to its tick and
    `.nodes.term`, with the message the reference would write; the
    State both engines start from is never written."""
    cfg = RaftConfig(**GRAY)
    st0 = state.init(cfg, 8, device="cpu")
    before = _snapshot(st0)
    eng = nsearch.plain_engine if engine == "plain" \
        else nsearch.kernel_engine
    clean, corrupt = nsearch.term_corruption_pair(13, engine=eng)(cfg)
    rep = bisect_divergence(clean, corrupt, st0, 32, chunk=8)
    assert rep["tick"] == 13 and rep["boundary"] == (8, 16)
    assert rep["leaf_report"].startswith(
        "first divergent leaf: .nodes.term — int32[8, 3]: 1/24 elements "
        "differ, first at [0,1]: np.int32(")
    assert trees.trees_equal(before, _snapshot(st0))
    # The same report through the reference's comparator.
    a = clean(clean(st0, 13, 0), 1, 13)
    b = corrupt(corrupt(st0, 13, 0), 1, 13)
    assert rep["leaf_report"] == jtrees.trees_equal_why(
        _numpy(a), _numpy(b))[1]


def test_a_nondeterministic_engine_is_refused():
    cfg = RaftConfig(**GRAY)
    plain = nsearch.plain_engine(cfg)

    def chunky(s, n, t):   # differs only when run a chunk at a time
        s = plain(s, n, t)
        if n > 1:
            s = s._replace(group_id=s.group_id + 1)
        return s

    with pytest.raises(AssertionError, match="not a deterministic"):
        bisect_divergence(plain, chunky, state.init(cfg, 2, device="cpu"),
                          8, chunk=4)
