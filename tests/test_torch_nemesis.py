"""The port's nemesis programs against the JAX package, tolerance 0, with
no XLA compile: the five seam evaluators (raft_tpu_torch.utils.trng
`nem_*`) against `raft_tpu.utils.jrng`'s on tests/test_nemesis.py's
coordinate grids (eager jnp), their refusal of a program with no clause
of their seam, the builders, program assembly, JSON form, hash and
description against `raft_tpu.nemesis.program`, and `RaftConfig`'s
acceptance of every program the reference accepts and refusal
(`ValueError`) of every malformed one; and, on the port alone, that each
clause of the all-kinds program fires in its universe."""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from raft_tpu import nemesis as jnem
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.utils import jrng
from raft_tpu.utils import rng as prng
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import state, step
from raft_tpu_torch.utils import trng

# tests/test_nemesis.py's base universe, its admission universe
# (`_admission_cfg`) and its all-kinds program
BASE = dict(seed=9, k=3, log_cap=8, compact_every=4, drop_prob=0.03,
            crash_prob=0.1, crash_epoch=24)
ADMISSION = dict(BASE, sessions=True, cmds_per_tick=0, client_rate=0.3,
                 client_slots=2, client_queue_cap=4)


def all_kinds(mod, ticks: int) -> tuple:
    """One clause of every kind, overlapping spans (test_nemesis.py's
    `_all_kinds_program`), built by `mod`'s builders."""
    return mod.program(
        mod.slow_follower(0, ticks, p=0.7, direction=3),
        mod.flaky_link(0, ticks, p=0.9, burst_epoch=8, burst_p=0.6),
        mod.wan_delay(0, ticks * 2 // 3, sites=2, p=0.4),
        mod.clock_skew(4, ticks - 8, amount=5, node_p=0.6),
        mod.crash_storm(8, ticks * 2 // 3, p=0.3, epoch=4),
        mod.partition_wave(10, ticks - 4, period=16, width=6, leak_p=0.8),
        mod.disk_full_follower(2, ticks - 2, p=0.8, epoch=8),
        mod.compaction_pressure(6, ticks * 3 // 4, p=0.5, epoch=4))


def observe(st) -> dict:
    """One tick's `sim.run.trace` observables of a port state (and its
    deadline draw count), as numpy."""
    out = {f: getattr(st.nodes, f).numpy()
           for f in ("term", "role", "voted_for", "leader_id", "last_index",
                     "commit", "applied", "digest", "snap_index",
                     "snap_term", "snap_voters", "reads_done", "rng_draws")}
    out["alive"] = st.alive_prev.numpy()
    return out


def port_trace(cfg, g, n_ticks):
    """(final State, {field: [T, G, K]}) of the port's per-tick tick."""
    st = state.init(cfg, g, device="cpu")
    rows = []
    for t in range(n_ticks):
        st = step.tick(cfg, st, t)
        rows.append(observe(st))
    return st, {f: np.stack([r[f] for r in rows]) for f in rows[0]}


def _np(x, shape):
    return np.broadcast_to(np.asarray(x), shape)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_evaluators_match_jrng_on_grids(k):
    """test_nemesis.py:48-85's grids (T=24, G=5, and k nodes), u32 grid
    coordinates as int64 tensors; plus a skew pair that sums to a
    negative extra, and the last ticks below 2**31."""
    seed, T, G = 9, 24, 5
    prog = jnem.program(
        *all_kinds(jnem, T),
        jnem.clock_skew(0, 2 ** 31 - 1, amount=-13, node_p=0.7),
        jnem.crash_storm(2 ** 31 - 50, 2 ** 31 - 1, p=0.6, epoch=3))
    jcfg = JaxConfig(**{**BASE, "k": k}, nemesis=prog)
    cfg = RaftConfig(**{**BASE, "k": k}, nemesis=prog)
    assert cfg.nemesis == jcfg.nemesis
    for lo in (0, 2 ** 31 - 64):
        tn = np.arange(lo, lo + T, dtype=np.uint32)[:, None, None, None]
        gn = np.arange(G, dtype=np.uint32)[None, :, None, None]
        an = np.arange(k, dtype=np.uint32)[None, None, :, None]
        bn = np.arange(k, dtype=np.uint32)[None, None, None, :]
        t, g, a, b = (torch.from_numpy(x.astype(np.int64))
                      for x in (tn, gn, an, bn))
        link = (T, G, k, k)
        node = (T, G, k, 1)
        for got, want, shape in (
                (trng.nem_link_ok(9, cfg.nem_link, g, t, a, b, k),
                 jrng.nem_link_ok(9, jcfg.nem_link, gn, tn, an, bn, k), link),
                (trng.nem_alive(9, cfg.nem_crash, g, a, t),
                 jrng.nem_alive(9, jcfg.nem_crash, gn, an, tn), node),
                (trng.nem_deadline_extra(9, cfg.nem_skew, g, a, t),
                 jrng.nem_deadline_extra(9, jcfg.nem_skew, gn, an, tn), node),
                (trng.nem_disk_full(9, cfg.nem_disk, g, a, t, k),
                 jrng.nem_disk_full(9, jcfg.nem_disk, gn, an, tn, k), node),
                (trng.nem_compact_block(9, cfg.nem_compact, g, a, t),
                 jrng.nem_compact_block(9, jcfg.nem_compact, gn, an, tn),
                 node)):
            np.testing.assert_array_equal(_np(got, shape), _np(want, shape))
    # A Python-int tick (the tick's own form) gives the tensor tick's rows.
    g, a = torch.arange(G)[:, None], torch.arange(k)[None, :]
    for ti in (3, 9, 17):
        np.testing.assert_array_equal(
            _np(trng.nem_alive(9, cfg.nem_crash, g, a, ti), (G, k)),
            [[prng.nem_alive(9, jcfg.nem_crash, gi, ai, ti)
              for ai in range(k)] for gi in range(G)])
        np.testing.assert_array_equal(
            _np(trng.nem_deadline_extra(9, cfg.nem_skew, g, a, ti), (G, k)),
            [[prng.nem_deadline_extra(9, jcfg.nem_skew, gi, ai, ti)
              for ai in range(k)] for gi in range(G)])


def test_evaluators_refuse_misfiltered_programs():
    crash_only = nemesis.program(nemesis.crash_storm(0, 8))
    with pytest.raises(ValueError, match="no link clause"):
        trng.nem_link_ok(1, crash_only, 0, 0, 0, 1, 3)
    with pytest.raises(ValueError, match="no timing clause"):
        trng.nem_deadline_extra(1, crash_only, 0, 0, 0)
    with pytest.raises(ValueError, match="no crash clause"):
        trng.nem_alive(1, nemesis.program(nemesis.wan_delay(0, 8)), 0, 0, 0)
    with pytest.raises(ValueError, match="no disk clause"):
        trng.nem_disk_full(1, crash_only, 0, 0, 0, 3)
    with pytest.raises(ValueError, match="no compaction clause"):
        trng.nem_compact_block(1, crash_only, 0, 0, 0)
    # A link program whose clauses are all static no-ops (a flaky link in
    # a 1-node group) is legal and passes everything, as in the reference.
    noop = nemesis.program(nemesis.flaky_link(0, 8))
    assert bool(trng.nem_link_ok(1, noop, 0, 0, 0, 0, 1))
    assert prng.nem_link_ok(1, noop, 0, 0, 0, 0, 1) is True


def test_builders_json_hash_and_describe_match_reference():
    for ticks in (32, 120, 600):
        prog = all_kinds(nemesis, ticks)
        want = all_kinds(jnem, ticks)
        assert prog == want and [c.cid for c in prog] == list(range(8))
        assert nemesis.program_hash(prog) == jnem.program_hash(want)
        assert nemesis.describe(prog) == jnem.describe(want)
        assert nemesis.to_json(prog) == jnem.to_json(want)
        assert nemesis.from_json(json.loads(json.dumps(
            nemesis.to_json(prog)))) == prog
        assert nemesis.from_json([list(c) for c in prog]) == prog
        for mix in ("gray_mix", "pressure_mix"):
            assert getattr(nemesis, mix)(ticks, 7) == \
                getattr(jnem, mix)(ticks, 7)
            assert nemesis.program_hash(getattr(nemesis, mix)(ticks)) == \
                jnem.program_hash(getattr(jnem, mix)(ticks))
    prog = all_kinds(nemesis, 32)
    assert nemesis.program(*prog[1:3]) == prog[1:3]   # cids kept
    assert nemesis.program_hash(prog[:2]) != nemesis.program_hash(prog)
    assert nemesis.describe(()) == jnem.describe(()) == "<empty>"
    with pytest.raises(ValueError, match="duplicate"):
        nemesis.program(prog[0], prog[0])
    for bad in (lambda m: m.slow_follower(0, 8, direction=0),
                lambda m: m.flaky_link(0, 8, burst_epoch=0),
                lambda m: m.wan_delay(0, 8, sites=1),
                lambda m: m.crash_storm(0, 8, epoch=0),
                lambda m: m.partition_wave(0, 8, width=-1),
                lambda m: m.disk_full_follower(0, 8, epoch=0),
                lambda m: m.compaction_pressure(0, 8, epoch=0),
                lambda m: m.clock_skew(9, 3)):
        for mod in (jnem, nemesis):
            with pytest.raises(ValueError):
                bad(mod)


def test_config_normalizes_and_splits_programs_by_seam():
    prog = all_kinds(nemesis, 32)
    cfg = RaftConfig(**BASE, nemesis=[list(c) for c in prog])
    jcfg = JaxConfig(**BASE, nemesis=[list(c) for c in prog])
    assert cfg.nemesis == jcfg.nemesis == prog
    assert all(type(c) is tuple for c in cfg.nemesis)
    for seam in ("nem_link", "nem_crash", "nem_skew", "nem_disk",
                 "nem_compact"):
        assert getattr(cfg, seam) == getattr(jcfg, seam), seam
    # A config rebuilt from its JSON dict is equal and hashes the same.
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert RaftConfig(**d) == cfg and hash(RaftConfig(**d)) == hash(cfg)


MALFORMED = [(1, 2, 3),                                  # not 8 fields
             (99, 0, 8, 0, 0, 0, 0, 0),                  # unknown kind
             (prng.NEM_SLOW, 9, 3, 0, 0, 3, 0, 0),       # t1 < t0
             (prng.NEM_SLOW, 0, 8, 0, 0, 0, 0, 0),       # direction mask 0
             (prng.NEM_STORM, 0, 8, 0, 0, 0, 0, 0),      # epoch < 1
             (prng.NEM_WAN, 0, 8, 0, 0, 1, 0, 0),        # < 2 sites
             (prng.NEM_WAVE, 0, 8, 0, 0, 8, -1, 0),      # b outside u32
             (prng.NEM_SKEW, 0, 8, 0, 0, 2 ** 31, 0, 0),  # a outside i32
             (prng.NEM_SLOW, 0, 8, 0, 0, 3, 0, -1),      # unassigned cid
             (prng.NEM_SLOW, 0, 8, 2 ** 32, 0, 3, 0, 0),  # group outside u32
             (prng.NEM_DISK, 0, 8, 0, 0, 2 ** 32, 0, 0)]  # a outside u32


@pytest.mark.parametrize("bad", MALFORMED, ids=lambda c: str(c))
def test_config_rejects_malformed_programs(bad):
    with pytest.raises(ValueError):
        JaxConfig(**BASE, nemesis=(bad,))
    with pytest.raises(ValueError):
        RaftConfig(**BASE, nemesis=(bad,))


def test_config_rejects_duplicate_cids():
    dup = ((prng.NEM_SLOW, 0, 8, 0, 0, 3, 0, 0),
           (prng.NEM_WAN, 0, 8, 0, 0, 2, 0, 0))
    with pytest.raises(ValueError, match="unique"):
        RaftConfig(**BASE, nemesis=dup)


@functools.cache
def _all_kinds_trace(cfg):
    """The port's per-tick observables of the all-kinds universe (120
    ticks, 8 groups: tests/test_nemesis.py's acceptance shape)."""
    return port_trace(cfg, 8, 120)[1]


@pytest.mark.parametrize("cid", range(8), ids=[
    "slow", "flaky", "wan", "skew", "storm", "wave", "disk", "compact"])
def test_each_clause_fires(cid):
    """Each clause, alone, masks something on the run's own coordinates:
    a link whose receiver is alive, a node the base schedule keeps up, a
    deadline draw taken, an alive node's appends or compaction. The
    compaction clause is held to more, in the pressure universe: a node
    ends a tick with compaction due, which only a block leaves."""
    cfg = RaftConfig(**BASE, nemesis=all_kinds(nemesis, 120))
    obs = _all_kinds_trace(cfg)
    c = cfg.nemesis[cid]
    seed, (n_t, n_g, k) = cfg.seed, obs["term"].shape
    t = torch.arange(n_t)[:, None, None]
    g = torch.arange(n_g)[None, :, None]
    i = torch.arange(k)[None, None, :]
    alive = torch.from_numpy(obs["alive"])
    if c[0] in prng.NEM_LINK_KINDS:
        src, dst = i[..., None], i[:, :, None, :]
        hit = (~trng.nem_link_ok(seed, (c,), g[..., None], t[..., None], src,
                                 dst, k) & (src != dst) & alive[:, :, None])
    elif c[0] == prng.NEM_STORM:
        hit = ~trng.nem_alive(seed, (c,), g, i, t) & trng.node_alive(
            seed, g, i, t, cfg.crash_u32, cfg.crash_epoch)
    elif c[0] == prng.NEM_SKEW:
        draws = torch.from_numpy(obs["rng_draws"])
        drew = draws > torch.cat([torch.ones_like(draws[:1]), draws[:-1]])
        hit = (trng.nem_deadline_extra(seed, (c,), g, i, t) != 0) & drew
    elif c[0] == prng.NEM_DISK:
        hit = trng.nem_disk_full(seed, (c,), g, i, t, k) & alive
    else:
        hit = trng.nem_compact_block(seed, (c,), g, i, t) & alive
        pcfg = RaftConfig(**ADMISSION, nemesis=nemesis.pressure_mix(48))
        st, held = state.init(pcfg, 16, device="cpu"), 0
        for tick in range(48):
            st = step.tick(pcfg, st, tick)
            held += int((st.nodes.commit - st.nodes.snap_index
                         >= pcfg.compact_every).sum())
        assert held > 0, "compaction was never held back"
    assert int(hit.sum()) > 0
