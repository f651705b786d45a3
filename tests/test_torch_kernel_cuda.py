"""The fused-chunk CUDA kernel against its plain PyTorch version on the
card: full State and Metrics bit-identical (tolerance 0), on steady,
faulted and command-free universes, on protocol-feature universes that
build every distinct outbox layout (no PreVote/TimeoutNow slots,
PreVote's alone, TimeoutNow's alone, both) and each voters-aware quorum
path (PreVote, membership change, reads, alone and together), on
scheduled-client universes (retrying sessions, the admission cap, with
PreVote and membership change), on the flight ring, and on states with
planted safety violations (where the kernel's own safety fold must clear
exactly the planted groups). Needs an NVIDIA GPU and nvcc; skips without
CUDA.
Imports no JAX, so it runs on a card machine without it (skipping the
suite's JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

from __future__ import annotations

import itertools

import pytest
import torch

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
], ids=["fault_mix", "config4", "election_rounds", "reads", "feature_mix",
        "transfer_reconfig", "prevote", "reconfig", "reads_reconfig",
        "prevote_reconfig", "clients", "clients_cap", "bench_clients",
        "clients_prevote_reconfig"])
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
def test_every_flag_set_builds(cuda):
    """All 32 feature flag sets compile (nvcc, sm_90a), not only the ones
    the universes above launch."""
    sets = list(itertools.product((False, True), repeat=len(kernel.FEATURES)))
    reports = kernel.build(sets)
    assert len(reports) == 32
    for flags in sets:
        assert "registers" in reports[flags], kernel.flag_name(flags)
