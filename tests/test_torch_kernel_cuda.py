"""The fused-chunk CUDA kernel against its plain PyTorch version on the
card: full State and Metrics bit-identical (tolerance 0), on steady,
faulted and command-free universes, on protocol-feature universes that
build every distinct outbox layout (no PreVote/TimeoutNow slots,
PreVote's alone, TimeoutNow's alone, both) and each voters-aware quorum
path (PreVote, membership change, reads, alone and together), on
scheduled-client universes (retrying sessions, the admission cap, with
PreVote and membership change), on the flight ring, on nemesis programs
(the gray mix, the storage-pressure mix under admission-capped clients,
one clause of every kind at k=3 and k=5, a 24-clause program), on shapes
past the old per-thread bounds (k=9, log_cap=128), and on states with
planted safety violations (where the kernel's
own safety fold must clear exactly the planted groups). The packed wire
codec kernels against plain `pack`/`unpack` on chip_smoke.py's four
packed universes at 1,000 groups, the histogram-free launch, the
aliased in-place launch, the narrow dials and the streamed pipeline.
Needs an NVIDIA GPU and nvcc; skips without CUDA.
Imports no JAX, so it runs on a card machine without it (skipping the
suite's JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

from __future__ import annotations

import dataclasses
import itertools

import pytest
import torch

from raft_tpu_torch import nemesis
from raft_tpu_torch.config import CONFIG_FLAG, RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.sim import kernel, run, state
from raft_tpu_torch.verify import plant

CONFIG4 = dict(seed=43, crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
               partition_epoch=64, drop_prob=0.02)
# The flagship entry's knobs: every fault class and every protocol
# feature (__graft_entry__.py).
FEATURE_MIX = dict(seed=1, drop_prob=0.05, crash_prob=0.2, crash_epoch=8,
                   partition_prob=0.2, partition_epoch=8, prevote=True,
                   read_every=8, reconfig_prob=0.3, reconfig_epoch=16,
                   transfer_prob=0.3, transfer_epoch=16)
# scripts/kernel_sweep.py's fault knobs, under single features and pairs
# of its ROWS at the headline width (k=5, L=32)
SWEEP_FAULTS = dict(crash_prob=0.15, crash_epoch=24, drop_prob=0.04)
# raft_tpu.clients.clients_64_cfg's knobs: retrying sessions under faults
CLIENTS_64 = dict(k=3, seed=29, log_cap=8, compact_every=4, sessions=True,
                  cmds_per_tick=0, client_rate=0.3, client_slots=3,
                  client_retry_backoff=5, drop_prob=0.05, crash_prob=0.2,
                  crash_epoch=16, partition_prob=0.2, partition_epoch=16)
# bench.py bench_clients' knobs at the published widths
BENCH_CLIENTS = dict(seed=47, sessions=True, cmds_per_tick=0,
                     client_rate=0.2, client_slots=4, client_retry_backoff=8,
                     crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
                     partition_epoch=64, drop_prob=0.02)


# tests/test_nemesis.py's base universe
NEM_BASE = dict(seed=9, k=3, log_cap=8, compact_every=4, drop_prob=0.03,
                crash_prob=0.1, crash_epoch=24)


def all_kinds(ticks: int) -> tuple:
    """One clause of every kind, overlapping spans (tests/test_nemesis.py)."""
    n = nemesis
    return n.program(
        n.slow_follower(0, ticks, p=0.7, direction=3),
        n.flaky_link(0, ticks, p=0.9, burst_epoch=8, burst_p=0.6),
        n.wan_delay(0, ticks * 2 // 3, sites=2, p=0.4),
        n.clock_skew(4, ticks - 8, amount=5, node_p=0.6),
        n.crash_storm(8, ticks * 2 // 3, p=0.3, epoch=4),
        n.partition_wave(10, ticks - 4, period=16, width=6, leak_p=0.8),
        n.disk_full_follower(2, ticks - 2, p=0.8, epoch=8),
        n.compaction_pressure(6, ticks * 3 // 4, p=0.5, epoch=4))


def bounded(n_clauses: int) -> tuple:
    """A program of n_clauses clauses (at most 64), the all-kinds ones
    repeated with shifted spans (fresh cids)."""
    clauses = [c._replace(t0=c.t0 + r, t1=c.t1 + r, cid=-1)
               for r in range(0, 64, 8) for c in all_kinds(90)]
    return nemesis.program(*clauses[:n_clauses])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def assert_same(cfg, g, leaves, plain):
    for a, b in zip(kernel.kfinish(cfg, leaves, g),
                    kernel.kfinish(cfg, plain, g)):
        for name, x, y in zip(a._fields, a, b):
            if x is None:
                continue
            for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert u is None or torch.equal(u, v), name


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(n_groups=300, k=3, seed=7, drop_prob=0.05, crash_prob=0.1,
         crash_epoch=16, partition_prob=0.2, partition_epoch=16, log_cap=8,
         compact_every=4),
    dict(n_groups=1000, **CONFIG4),
    # bench.py bench_election_rounds: no commands, crash 0.5/32
    dict(n_groups=500, seed=44, cmds_per_tick=0, crash_prob=0.5,
         crash_epoch=32),
    # bench.py bench_reads
    dict(n_groups=1000, seed=45, read_every=4),
    dict(n_groups=1000, **FEATURE_MIX),
    # tests/test_differential.py::test_differential_transfer_reconfig
    dict(n_groups=300, seed=61, transfer_prob=0.8, transfer_epoch=48,
         reconfig_prob=0.8, reconfig_epoch=40, crash_prob=0.15,
         crash_epoch=64),
    dict(n_groups=300, seed=70, prevote=True, partition_prob=0.2,
         partition_epoch=16, **SWEEP_FAULTS),
    dict(n_groups=300, seed=71, reconfig_prob=0.8, reconfig_epoch=16,
         **SWEEP_FAULTS),
    dict(n_groups=300, seed=72, read_every=4, reconfig_prob=0.8,
         reconfig_epoch=16, **SWEEP_FAULTS),
    dict(n_groups=300, seed=73, prevote=True, reconfig_prob=0.8,
         reconfig_epoch=16, partition_prob=0.2, partition_epoch=16,
         **SWEEP_FAULTS),
    dict(n_groups=300, **CLIENTS_64),
    dict(n_groups=300, **dict(CLIENTS_64, client_queue_cap=2)),
    dict(n_groups=3000, **BENCH_CLIENTS),
    dict(n_groups=300, **dict(CLIENTS_64, prevote=True, reconfig_prob=0.8,
                              reconfig_epoch=16)),
    # shapes past the kernel's old per-thread bounds (k <= 8, L <= 64)
    dict(n_groups=1000, k=9, **CONFIG4),
    dict(n_groups=1000, log_cap=128, compact_every=64, **CONFIG4),
], ids=["fault_mix", "config4", "election_rounds", "reads", "feature_mix",
        "transfer_reconfig", "prevote", "reconfig", "reads_reconfig",
        "prevote_reconfig", "clients", "clients_cap", "bench_clients",
        "clients_prevote_reconfig", "k9", "L128"])
def test_kernel_matches_plain_on_card(cuda, kw):
    cfg = RaftConfig(**kw)
    leaves, g = kernel.kinit(cfg, state.init(cfg, device=cuda))
    plain = leaves
    before = kernel.kstep.launches
    for at, n in ((0, 33), (33, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
    torch.cuda.synchronize()
    assert kernel.kstep.launches == before + 2
    assert_same(cfg, g, leaves, plain)
    nodes = kernel.kfinish(cfg, leaves, g)[0].nodes
    if cfg.reconfig_u32:
        assert bool((nodes.snap_voters != cfg.full_mask).any()
                    or ((nodes.log_payload & CONFIG_FLAG) != 0).any()), \
            "membership never changed"
    if cfg.read_every:
        assert kernel.kreads(cfg, leaves, g) > 0, "no read completed"
    if cfg.clients_u32:
        assert kernel.kacked(cfg, leaves, g) > 0, "no client op acked"
        assert kernel.kretries(cfg, leaves, g) > 0, "no client op retried"
    if cfg.client_queue_cap:
        clients = kernel.kfinish(cfg, leaves, g)[0].clients
        assert int(clients.shed.sum()) > 0, "no arrival shed"
    if cfg.prevote:
        assert int(nodes.term.max()) > 1, "no election"


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(n_groups=300, seed=7, k=3, log_cap=8,
                                     compact_every=4, drop_prob=0.05,
                                     crash_prob=0.1, crash_epoch=16),
                                dict(n_groups=1000, **BENCH_CLIENTS)],
                         ids=["fault_mix", "bench_clients"])
def test_kernel_flight_ring_matches_plain_on_card(cuda, kw):
    """The flight ring on the wire: the kernel's rings equal
    `recorder.run_recorded`'s across a wrap of the 64-slot ring and a
    launch boundary."""
    cfg = RaftConfig(**kw)
    g = cfg.n_groups
    leaves, _ = kernel.kinit(cfg, state.init(cfg, device=cuda),
                             flight=recorder.flight_init(g, device=cuda))
    plain = leaves
    for at, n in ((0, 50), (50, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
    torch.cuda.synchronize()
    assert_same(cfg, g, leaves, plain)
    fk, fp = kernel.kflight(cfg, leaves, g), kernel.kflight(cfg, plain, g)
    for name, x, y in zip(fk._fields, fk, fp):
        assert torch.equal(x, y), name
    rows = recorder.flight_rows(fk)
    assert len(rows) == recorder.RING and rows[-1]["tick"] == 89
    assert sum(r["elections"] for r in rows) > 0 and rows[-1]["msgs"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(n_groups=64, seed=42),
                                dict(n_groups=1000, **CONFIG4),
                                dict(n_groups=1000, **FEATURE_MIX),
                                dict(n_groups=1000, **BENCH_CLIENTS)],
                         ids=["headline", "config4", "feature_mix",
                              "bench_clients"])
def test_kernel_safety_fold_on_planted_violations(cuda, kw):
    cfg, t0 = RaftConfig(**kw), 37
    st, m = run.run(cfg, state.init(cfg, device=cuda), t0)
    st, planted = plant.plant_violations(cfg, st)
    leaves, g = kernel.kinit(cfg, st, m)
    out = kernel.kstep(cfg, leaves, t0, 3)
    plain = kernel.kstep_plain(cfg, leaves, t0, 3)
    assert_same(cfg, g, out, plain)
    _, mk = kernel.kfinish(cfg, out, g, m)
    unsafe = (~mk.safety.bool()).nonzero().flatten().tolist()
    assert unsafe == sorted(planted.values())
    assert sorted(planted) == sorted(plant.kinds(cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(n_groups=1000, **CONFIG4, nemesis=nemesis.gray_mix(73)),
    dict(n_groups=1000, seed=49, sessions=True, cmds_per_tick=0,
         client_rate=0.5, client_slots=4, client_retry_backoff=8,
         client_queue_cap=8, nemesis=nemesis.pressure_mix(73)),
    dict(n_groups=300, **NEM_BASE, nemesis=all_kinds(73)),
    dict(n_groups=300, seed=9, nemesis=all_kinds(73)),
    dict(n_groups=300, **NEM_BASE, nemesis=bounded(24)),
], ids=["gray_mix", "pressure", "all_kinds_k3", "all_kinds_k5",
        "clauses_24"])
def test_kernel_nemesis_matches_plain_on_card(cuda, kw):
    """State, Metrics and Flight at every chunk boundary."""
    cfg = RaftConfig(**kw)
    g = cfg.n_groups
    leaves, _ = kernel.kinit(cfg, state.init(cfg, device=cuda),
                             flight=recorder.flight_init(g, device=cuda))
    plain = leaves
    for at, n in ((0, 33), (33, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
        torch.cuda.synchronize()
        assert_same(cfg, g, leaves, plain)
        fk, fp = kernel.kflight(cfg, leaves, g), kernel.kflight(cfg, plain, g)
        for name, x, y in zip(fk._fields, fk, fp):
            assert torch.equal(x, y), name
    _, m = kernel.kfinish(cfg, leaves, g)
    assert run.unsafe_groups(m) == 0
    if cfg.client_queue_cap:
        clients = kernel.kfinish(cfg, leaves, g)[0].clients
        assert int(clients.shed.sum()) > 0, "no arrival shed"


def past_the_clause_bound(cfg: RaftConfig) -> tuple:
    """A program one clause longer than the longest whose clause table
    (and participation words) fit one block's shared memory beside one
    group of `cfg`."""
    def prog(n):
        return nemesis.program(*(nemesis.slow_follower(t, t + 1)
                                 for t in range(n)))

    room = kernel.SMEM_PER_BLOCK - 4 * kernel.shared_words_per_group(cfg)
    n = room // 33   # under the bound: 8 words a clause and its bit
    while kernel.shared_bytes(dataclasses.replace(cfg, nemesis=prog(n))) \
            <= kernel.SMEM_PER_BLOCK:
        n += 1
    return prog(n)


@pytest.mark.cuda
def test_kernel_refuses_a_program_past_its_clause_bound(cuda):
    """A program whose clause table does not fit one block's shared memory
    beside one group raises ValueError naming the bound, never runs on
    the plain tick; one clause fewer launches."""
    cfg = RaftConfig(**NEM_BASE)
    big = dataclasses.replace(cfg, nemesis=past_the_clause_bound(cfg))
    assert kernel.shared_bytes(big) > kernel.SMEM_PER_BLOCK
    leaves, _ = kernel.kinit(big, state.init(big, 8, device=cuda))
    before = kernel.kstep.launches
    with pytest.raises(ValueError, match="232448 B"):
        kernel.kstep(big, leaves, 0, 4)
    assert kernel.kstep.launches == before
    fits = dataclasses.replace(cfg, nemesis=big.nemesis[:-1])
    assert kernel.shared_bytes(fits) <= kernel.SMEM_PER_BLOCK
    leaves, _ = kernel.kinit(fits, state.init(fits, 8, device=cuda))
    out = kernel.kstep(fits, leaves, 0, 4)
    plain = kernel.kstep_plain(fits, leaves, 0, 4)
    torch.cuda.synchronize()
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])


@pytest.mark.cuda
def test_launch_plan_fills_the_sm(cuda):
    """The launcher's block shape: a tile of the next power of two >= k
    lanes per group, and groups per block and per SM that fit the card's
    shared memory."""
    for kw, lanes in ((dict(seed=42), 8),
                      (dict(k=3, log_cap=8, compact_every=4), 4),
                      (dict(k=9), 16),
                      (dict(k=30, log_cap=8, compact_every=4), 32)):
        cfg = RaftConfig(**kw)
        plan = kernel.launch_plan(cfg, 100_000)
        assert plan["lanes_per_group"] == lanes
        assert plan["threads_per_block"] == lanes * plan["groups_per_block"]
        assert plan["shared_bytes_per_block"] <= kernel.SMEM_PER_BLOCK
        assert plan["groups_per_sm"] == \
            plan["groups_per_block"] * plan["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_every_flag_set_builds(cuda):
    """All 64 feature flag sets compile (nvcc, sm_90a), not only the ones
    the universes above launch, and so does the codec."""
    sets = list(itertools.product((False, True), repeat=len(kernel.FEATURES)))
    reports = kernel.build(sets, codec=True)
    assert len(reports) == 65
    for flags in sets:
        assert "registers" in reports[flags], kernel.flag_name(flags)
    assert reports[kernel.CODEC].count("registers") == 2


PACK_WIRE = dict(pack_bools=True, pack_ring=True, alias_wire=True)
# chip_smoke.py phase (a)'s four universes at 1,000 groups
CODEC_UNIVERSES = {
    "headline": (dict(seed=42), False),
    "config4": (CONFIG4, False),
    "clients": (BENCH_CLIENTS, True),
    "nemesis": (dict(seed=48, crash_prob=0.1, crash_epoch=64,
                     drop_prob=0.02, nemesis=nemesis.gray_mix(73)), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CODEC_UNIVERSES))
def test_codec_kernels_match_plain_on_card(cuda, name):
    """The packed, aliased launch (unpack -> tick in place -> pack) equals
    kstep_plain at every chunk boundary, and at each boundary the codec
    kernels' words equal plain `unpack`/`pack`, with the sticky ring flags
    of a planted third of the groups ORed in."""
    kw, fl = CODEC_UNIVERSES[name]
    cfg = RaftConfig(n_groups=1000, **kw, **PACK_WIRE)
    flight = recorder.flight_init(1000, device=cuda) if fl else None
    leaves, g = kernel.kinit(cfg, state.init(cfg, device=cuda),
                             flight=flight)
    plain = tuple(x.clone() for x in leaves)
    before = (kernel.kstep.launches, kernel.pack_wire.launches,
              kernel.unpack_wire.launches)
    for at, n in ((0, 33), (33, 40)):
        wire_in = leaves[0]
        leaves = kernel.kstep(cfg, leaves, at, n)
        assert leaves[0] is wire_in
        plain = kernel.kstep_plain(cfg, plain, at, n)
        torch.cuda.synchronize()
        assert torch.equal(leaves[0], plain[0]) and \
            torch.equal(leaves[1], plain[1])
        work = kernel.unpack_wire(cfg, leaves[0])
        want, ov = kernel.unpack(cfg, leaves[0])
        assert torch.equal(work, want) and int(ov.sum()) == 0
        flags = leaves[0].clone()
        row = kernel._rest_at(cfg, kernel._ring_of(cfg, flags))[
            kernel.RING_BASE][0]
        flags[row, ::3] |= -(2 ** 31)
        got = kernel.pack_wire(cfg, work, flags)
        assert torch.equal(got, kernel.pack(cfg, want,
                                            kernel.ring_flags(cfg, flags)))
        assert torch.equal(kernel.pack_wire(cfg, work, flags, out=flags),
                           got)
    assert (kernel.kstep.launches, kernel.pack_wire.launches,
            kernel.unpack_wire.launches) == (before[0] + 2, before[1] + 6,
                                             before[2] + 4)
    assert_same(cfg, g, leaves, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(n_groups=1000, seed=42),
                                dict(n_groups=1000, **BENCH_CLIENTS)],
                         ids=["headline", "bench_clients"])
def test_histogram_free_launch_on_card(cuda, kw):
    """wire_hist=False launches with H = 0: acc keeps its two (three)
    counters, the kernel writes no histogram row, and the launch equals
    kstep_plain."""
    cfg = RaftConfig(**kw, wire_hist=False)
    leaves, g = kernel.kinit(cfg, state.init(cfg, device=cuda))
    plain = leaves
    for at, n in ((0, 33), (33, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
    torch.cuda.synchronize()
    assert leaves[1].shape == (3 if cfg.clients_u32 else 2,)
    assert int(leaves[1][0]) > 0   # elections counted
    assert torch.equal(leaves[0], plain[0])
    assert torch.equal(leaves[1], plain[1])


@pytest.mark.cuda
def test_aliased_launch_runs_in_place_on_card(cuda):
    """alias_wire without packing: the tick kernel runs in place on the
    input (no copy, no aliased restrict pointers) and returns it."""
    cfg = RaftConfig(n_groups=1000, alias_wire=True, **FEATURE_MIX)
    leaves, g = kernel.kinit(cfg, state.init(cfg, device=cuda))
    plain = tuple(x.clone() for x in leaves)
    ptrs = (leaves[0].data_ptr(), leaves[1].data_ptr())
    for at, n in ((0, 33), (33, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
    torch.cuda.synchronize()
    assert (leaves[0].data_ptr(), leaves[1].data_ptr()) == ptrs
    assert_same(cfg, g, leaves, plain)


@pytest.mark.cuda
def test_narrow_dials_on_card(cuda):
    """kinit widens a narrow State, the kernel computes wide, kfinish
    narrows it again: values equal the wide launch's, dtypes the spec's."""
    wide = RaftConfig(n_groups=1000, **BENCH_CLIENTS)
    cfg = RaftConfig(n_groups=1000, narrow_scalars=True, narrow_ring=True,
                     narrow_mailbox=True, narrow_clients=True,
                     donate_scan=True, **BENCH_CLIENTS)
    sn, mn = kernel.prun(cfg, state.init(cfg, device=cuda), 73)
    sw, mw = kernel.prun(wide, state.init(wide, device=cuda), 73)
    assert sn.nodes.term.dtype == torch.uint16
    assert sn.clients.last_lat.dtype == torch.int16
    assert not state.narrow_overflow(sn).any()
    for a, b in zip(state.to_numpy(state.widen_state(cfg, sn)).nodes,
                    state.to_numpy(sw).nodes):
        assert a is None or (a == b).all()
    assert all(torch.equal(a, b) for a, b in zip(mn, mw) if a is not None)


@pytest.mark.cuda
def test_streamed_matches_resident_on_card(cuda):
    """3,000 groups in three one-block windows through the card's
    pipeline (two copy streams, events), packed: equal to the resident
    launch, with the measured split filled in."""
    from raft_tpu_torch.parallel import cohort
    base = RaftConfig(n_groups=3000, **CONFIG4)
    cfg = RaftConfig(n_groups=3000, stream_groups=True, cohort_blocks=1,
                     pack_bools=True, pack_ring=True, **CONFIG4)
    st0 = state.init(base, device=cuda)
    res = kernel.prun(base, st0, 60)
    stats = {}
    out = cohort.prun_streamed(cfg, st0, 60, chunk_ticks=20, stats=stats)
    for a, b in zip(res, out):
        for x, y in zip(state.to_numpy(a), state.to_numpy(b)):
            if isinstance(x, tuple):
                assert all(u is None or (u == v).all() for u, v in zip(x, y))
            elif x is not None:
                assert (x == y).all()
    assert stats["cohorts"] == 3 and stats["launches"] == 9
    assert 0 < stats["overlap_efficiency_measured"] <= 1.0 + 1e-6
