"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives raft_tpu_torch's paths at full width: the batched Raft tick at
k=5, L=32, E=4 through the fused-chunk CUDA kernel
(raft_tpu_torch/csrc/fused_chunk.cu: each group's state in shared memory
for the whole launch, one lane per node), held bit-identical to the port's
plain PyTorch tick on each path's own inputs. Phases, each of which
raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernel from the checkout's sources for the 32 feature flag
   sets without nemesis and the two nemesis sets the runs launch (the
   card test builds all 64), and the codec kernels, one nvcc per build,
   all started together; print each build's registers, frame and spills
   (ptxas -v), and each run's shared memory per group and block shape
   from the launcher's occupancy query (lanes per group, groups and
   threads per block, shared bytes per block, blocks and groups per SM);
3. the safety fold: a headline state at 4,096 groups, a feature-mix
   state, a client-traffic state and a storage-pressure state at 1,000
   groups, each with one group planted per safety predicate (and per
   exactly-once clause); kernel and plain must agree and clear the
   safety bit in exactly the planted groups;
4. the plain tick over every run, in the same 200-tick chunks, kept as
   the reference at every chunk boundary: all three chunks of the
   pressure knee's top rung, the first chunk of the other runs (the
   plain tick is host-bound, about 20-40 s a chunk, and the earlier
   paths were held to it at full depth by the smoke runs that brought
   them up) and none of the knee's four lower rungs;
5. each run on the kernel, its launch counts set to 0 just before it
   and read just after. The main path: the headline (RaftConfig(seed=42),
   100,000 groups), config-4 (seed 43, crash 0.3/64, partition 0.2/64,
   drop 0.02; 50,000 groups) and election rounds (seed 44, no commands,
   crash 0.5/32; 10,000 groups). The protocol-feature path: reads
   (bench.py bench_reads: seed 45, read_every=4; 50,000 groups) and the
   feature mix (the flagship entry's knobs: every fault class, PreVote,
   reads, membership change and leadership transfer; 50,000 groups).
   The client path, with the flight ring on as bench.py's client
   segment records it: clients (bench.py bench_clients: seed 47, four
   retrying exactly-once sessions per group at rate 0.2 under the
   config-5 fault mix; 50,000 groups) and clients-cap (the same at rate
   0.5 behind an admission cap of 8; 10,000 groups). The nemesis path,
   flight ring on: nemesis (bench.py bench_nemesis: seed 48, crash
   0.1/64, drop 0.02, the gray mix; 50,000 groups), the five rungs of
   the pressure knee (bench.py bench_pressure: seed 49, four sessions
   behind a cap of 8 under the pressure mix, offered rates 0.05-0.5;
   20,000 groups each) and nemesis-all-kinds (one clause of every kind,
   tests/test_nemesis.py's program, seed 9; 10,000 groups). 600 ticks
   each in 3 x 200-tick launches;
6. every chunk boundary of phase 5 that phase 4 reached, against phase
   4 (full State, Metrics and, where recorded, Flight; max abs err 0),
   then the readouts:
   rounds/s, ms/tick, p50/p99 election latency, censoring, elections/s,
   reads/s, client ops/s, retries, p50/p99 ack latency, sheds, the
   exactly-once report, safety, and that each feature fired; each
   pressure rung against bench.py's SLO and the knee; for the all-kinds
   run, the kernel again with each clause dropped in turn, which must
   change the final state;
then the slice of the layout and residency dials, each path with its
launch counts set to 0 just before it and read just after:
(a) packed wire: the headline, config-4, clients and nemesis runs again
   with bench.py --pack-wire's dials (pack_bools, pack_ring, alias_wire),
   3 x 200-tick launches each through the codec kernels
   (raft_tpu_torch/csrc/wire_codec.cu); State, Metrics and Flight equal
   phase 5's at every chunk boundary, the codec kernels' words equal the
   plain `pack`/`unpack` of the same state, and the codec kernels are
   timed against their plain versions at the headline's 100,000 groups;
(b) wire_hist=False on the headline and clients: State, lanes and Flight
   equal phase 5's and the caller's histograms pass through;
(c) the four narrow dials and donate_scan on config-4 and clients:
   values equal phase 5's, dtypes follow the narrow spec, no latch;
(d) refusals: kfinish raises on a planted in-group term spread of 2^16
   under pack_ring and on a planted narrow overflow;
(e) memory: the peak of one headline kstep at 100,000 groups
   (torch.cuda.max_memory_allocated) under four dial sets beside the
   byte model's `hbm_bytes`, and the model's resident and streamed
   ceilings for this card and host;
(f) streamed: the headline at 1,000,000 groups for 200 ticks, packed,
   through parallel/cohort.py in ten windows of 100,352 groups
   (cohort_blocks=98), equal to the resident kernel run of the same
   million groups; rounds/s and the pipeline's h2d/compute/d2h/wall
   split and overlap efficiency;
(g) near the ceiling: one resident headline launch at 97% of the most
   groups `kernel.hbm_budget` (free memory less its margin) allows, the
   fleet's wire built a window at a time, then a fresh headline fleet of
   110% of that ceiling streamed as in (f) with its State never whole;
   in each, the first 100,000 groups equal the headline's first chunk;
7. a `kernels` JSON line: launches, times and bound of the fused chunk
   and the two codec kernels, and the same for each flag set's build by
   run (with each run's steady-state time: three launches more from its
   start, CUDA events), with the build's ptxas numbers and each run's
   block shape.

The last line is {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time

import torch

CHUNK, N_TICKS = 200, 600
GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# int32 CUDA-core rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost
# (NVIDIA Hopper architecture white paper).
INT32_OPS_PER_S = 64 * 132 * 1.98e9
MIX_OPS = 7          # mix32: 3 xors, 2 shifts, 2 multiplies
FOLD_OPS = MIX_OPS + 2   # one hash_u32 argument: multiply, add, mix32
# bench.py's pressure knee: offered rates, admission cap, SLO
# (bench.py:1200-1208)
PRESSURE_RATES = (0.05, 0.1, 0.2, 0.35, 0.5)
PRESSURE_ACK_SLO_TICKS, PRESSURE_SHED_SLO = 48, 0.05
# bench.py --pack-wire's dials for every segment (bench.py:1391-1421)
PACK_WIRE = dict(pack_bools=True, pack_ring=True, alias_wire=True)
NARROW = dict(narrow_scalars=True, narrow_ring=True, narrow_mailbox=True,
              narrow_clients=True, donate_scan=True)
STREAM_GROUPS, STREAM_BLOCKS = 1_000_000, 98


def config4(n_groups):
    from raft_tpu_torch.config import RaftConfig
    return RaftConfig(n_groups=n_groups, seed=43, crash_prob=0.3,
                      crash_epoch=64, partition_prob=0.2, partition_epoch=64,
                      drop_prob=0.02)


def feature_mix(n_groups):
    """__graft_entry__.py's flagship knobs: every fault class and every
    protocol feature."""
    from raft_tpu_torch.config import RaftConfig
    return RaftConfig(n_groups=n_groups, seed=1, drop_prob=0.05,
                      crash_prob=0.2, crash_epoch=8, partition_prob=0.2,
                      partition_epoch=8, prevote=True, read_every=8,
                      reconfig_prob=0.3, reconfig_epoch=16,
                      transfer_prob=0.3, transfer_epoch=16)


def bench_clients(n_groups, **kw):
    """bench.py bench_clients' knobs (bench.py:1108-1112): the config-5
    fault mix with four retrying exactly-once sessions per group."""
    from raft_tpu_torch.config import RaftConfig
    knobs = dict(n_groups=n_groups, seed=47, sessions=True, cmds_per_tick=0,
                 client_rate=0.2, client_slots=4, client_retry_backoff=8,
                 crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
                 partition_epoch=64, drop_prob=0.02)
    return RaftConfig(**dict(knobs, **kw))


def bench_nemesis(n_groups):
    """bench.py bench_nemesis' knobs (bench.py:916-917): light churn under
    the canonical gray-failure program."""
    from raft_tpu_torch import nemesis
    from raft_tpu_torch.config import RaftConfig
    return RaftConfig(n_groups=n_groups, seed=48, crash_prob=0.1,
                      crash_epoch=64, drop_prob=0.02,
                      nemesis=nemesis.gray_mix(N_TICKS))


def bench_pressure(n_groups, rate):
    """bench.py bench_pressure's knobs (bench.py:1248-1252) at one rung."""
    from raft_tpu_torch import nemesis
    from raft_tpu_torch.config import RaftConfig
    return RaftConfig(n_groups=n_groups, seed=49, sessions=True,
                      cmds_per_tick=0, client_rate=rate, client_slots=4,
                      client_retry_backoff=8, client_queue_cap=8,
                      nemesis=nemesis.pressure_mix(N_TICKS))


def all_kinds(ticks):
    """One clause of every kind, overlapping spans
    (tests/test_nemesis.py:29-42)."""
    from raft_tpu_torch import nemesis as n
    return n.program(
        n.slow_follower(0, ticks, p=0.7, direction=3),
        n.flaky_link(0, ticks, p=0.9, burst_epoch=8, burst_p=0.6),
        n.wan_delay(0, ticks * 2 // 3, sites=2, p=0.4),
        n.clock_skew(4, ticks - 8, amount=5, node_p=0.6),
        n.crash_storm(8, ticks * 2 // 3, p=0.3, epoch=4),
        n.partition_wave(10, ticks - 4, period=16, width=6, leak_p=0.8),
        n.disk_full_follower(2, ticks - 2, p=0.8, epoch=8),
        n.compaction_pressure(6, ticks * 3 // 4, p=0.5, epoch=4))


def gpu_line() -> str:
    out = subprocess.run(GPU_QUERY, check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every leaf of two (State, Metrics) pairs;
    raises if a leaf's shape or dtype differs."""
    worst = 0
    for x, y in zip(_leaves(a), _leaves(b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"leaf mismatch {x.shape}/{x.dtype} vs "
                                 f"{y.shape}/{y.dtype}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for v in tree:
        if v is not None:
            out.extend(_leaves(v))
    return out


def op_count(cfg, g, n_ticks, st0, st1, committed) -> float:
    """Integer operations the counter-based hashes of this run need (a
    floor of the tick's work), counted from this run's schedules and
    states: the crash and partition draws once per group per epoch (they
    hash (group, node, epoch) only), one drop draw per link the delivery
    filter reads (`live_links`), one fire draw per group per membership
    and transfer epoch and one target draw where it fires, the deadline
    draws taken, one payload hash per committed entry (fire-hose
    commands), one arrival draw per client slot per group-tick and one
    value hash per submit pulse (clients), one digest fold per applied
    entry, and the nemesis program's draws (`nem_ops`). A run starts at
    tick 0."""
    from raft_tpu_torch.utils import trng
    k, gid = cfg.k, st0.group_id

    def epochs(epoch):
        return -(-n_ticks // epoch)

    ops = 0.0
    if cfg.crash_u32:
        ops += k * 5 * FOLD_OPS * g * epochs(cfg.crash_epoch)
    if cfg.partition_u32:
        ops += (4 + k * 5) * FOLD_OPS * g * epochs(cfg.partition_epoch)
    if cfg.drop_u32:
        ops += 6 * FOLD_OPS * live_links(cfg, gid, n_ticks)
    for fires, u32, epoch in ((trng.reconfig_fires, cfg.reconfig_u32,
                               cfg.reconfig_epoch),
                              (trng.transfer_fires, cfg.transfer_u32,
                               cfg.transfer_epoch)):
        if u32:
            ep = torch.arange(epochs(epoch), device=gid.device)
            fired = int(fires(cfg.seed, gid[:, None], ep[None, :],
                              u32).sum())
            ops += 4 * FOLD_OPS * (g * epochs(epoch) + fired)
    draws = int((st1.nodes.rng_draws.to(torch.int64)
                 - st0.nodes.rng_draws.to(torch.int64)).sum())
    applied = int((st1.nodes.applied.to(torch.int64)
                   - st0.nodes.applied.to(torch.int64)).clamp(min=0).sum())
    ops += draws * 5 * FOLD_OPS + applied * (2 * MIX_OPS + 4)
    if cfg.cmds_per_tick:
        ops += committed * 5 * FOLD_OPS
    if cfg.clients_u32:
        ops += cfg.client_slots * g * n_ticks * 5 * FOLD_OPS
        ops += submit_pulses(st1.clients) * 5 * FOLD_OPS
    if cfg.nemesis:
        ops += nem_ops(cfg, gid, n_ticks, draws)
    return ops


def nem_ops(cfg, gid, n_ticks, draws) -> float:
    """The nemesis program's hash work in a run from tick 0: one
    participation draw per clause per group; a link draw on each link a
    link clause hits in a participating group inside its span (and the
    clause's target, site or side draws); per participating group and
    sub-epoch of the span, a crash draw per node (storms), a fire draw
    (disk) and a block draw per node (compaction); one skew draw per
    deadline draw and skew clause."""
    from raft_tpu_torch.utils import rng, trng
    k, g = cfg.k, gid.to(torch.int64)
    ops = len(cfg.nemesis) * g.numel() * 4 * FOLD_OPS
    for c in cfg.nemesis:
        kind, t0, t1, group_u32, _, a, _, cid = c
        part = trng.hash_u32(cfg.seed, rng.TAG_NEM_GROUP, cid, g) < group_u32
        n_part = int(part.sum())
        lo, hi = min(t0, n_ticks), min(t1, n_ticks)
        if kind in rng.NEM_LINK_KINDS:
            # The hit links change per tick (wave), per sub-epoch (flaky
            # bursts) or never (slow follower, WAN sites).
            key = {rng.NEM_SLOW: lambda t: 0, rng.NEM_WAN: lambda t: 0,
                   rng.NEM_FLAKY: lambda t: t // a}.get(kind, lambda t: t)
            memo, hits = {}, 0
            for t in range(lo, hi):
                if key(t) not in memo:
                    memo[key(t)] = int((link_hits(cfg, c, g, t)
                                        & part[:, None, None]).sum())
                hits += memo[key(t)]
            ops += hits * 7 * FOLD_OPS + n_part * k * 6 * FOLD_OPS
        elif kind == rng.NEM_SKEW:
            ops += draws * 5 * FOLD_OPS
        elif hi > lo:
            subs = (hi - 1) // a - lo // a + 1
            per = {rng.NEM_STORM: k * 6, rng.NEM_DISK: 5 + 4,
                   rng.NEM_COMPACT: k * 6}[kind]
            ops += n_part * subs * per * FOLD_OPS
    return ops


def link_hits(cfg, c, g, t):
    """[G, src, dst]: the links (src != dst) one link clause hits at tick
    t, before its per-link draw (the kernel's `nem_links`)."""
    from raft_tpu_torch.utils import rng, trng
    kind, _, _, _, _, a, b, cid = c
    k, seed = cfg.k, cfg.seed
    node = torch.arange(k, device=g.device)
    gg = g[:, None, None]
    src, dst = node[None, :, None], node[None, None, :]
    if kind == rng.NEM_SLOW:
        target = trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg) % k
        hit = (((a & 1) != 0) & (src == target)) | \
            (((a & 2) != 0) & (dst == target))
    elif kind == rng.NEM_FLAKY:
        s0 = trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, 0) % k
        d0 = (s0 + 1 + trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, 1)
              % max(k - 1, 1)) % k
        burst = trng.hash_u32(seed, rng.TAG_NEM_BURST, cid, gg, t // a) < b
        hit = (src == s0) & (dst == d0) & burst & (k > 1)
    elif kind == rng.NEM_WAN:
        hit = (trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, src) % a
               != trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, dst) % a)
    else:   # NEM_WAVE
        wave = (t + gg) % a < b
        hit = wave & ((trng.hash_u32(seed, rng.TAG_NEM_SIDE, cid, gg, t // a,
                                     src) & 1)
                      != (trng.hash_u32(seed, rng.TAG_NEM_SIDE, cid, gg,
                                        t // a, dst) & 1))
    return hit & (src != dst)


def submit_pulses(cl) -> int:
    """The submit pulses phase C consumed in a run from tick 0: every op
    started (done or in flight) and every retry raised a pulse, less the
    pulses the last tick raised for the tick after the run."""
    return int(sum(getattr(cl, f).to(torch.int64).sum()
                   for f in ("done", "inflight", "retries"))
               - cl.submit.to(torch.int64).sum())


def live_links(cfg, gid, n_ticks) -> int:
    """The (tick, group, src, dst) with src != dst whose receiver is alive
    and whose link is not cut: the links whose drop draw the delivery
    filter reads. Aliveness and cuts hold for a whole epoch, so each
    (crash epoch, partition epoch) pair is counted once and weighted by
    its ticks."""
    from raft_tpu_torch.utils import trng
    span, first = collections.Counter(), {}
    for t in range(n_ticks):
        key = (t // cfg.crash_epoch, t // cfg.partition_epoch)
        span[key] += 1
        first.setdefault(key, t)
    node = torch.arange(cfg.k, device=gid.device)
    g = gid.to(torch.int64)[:, None, None]
    src, dst = node[None, :, None], node[None, None, :]
    total = 0
    for key, t in first.items():
        alive = trng.node_alive(cfg.seed, g, dst, t, cfg.crash_u32,
                                cfg.crash_epoch)
        cut = trng.link_partitioned(cfg.seed, g, t, src, dst,
                                    cfg.partition_u32, cfg.partition_epoch)
        total += int((alive & ~cut & (src != dst)).sum()) * span[key]
    return total




def all_runs():
    """(label, cfg, groups, flight ring on, chunks of the plain reference)
    of every run. The main path:
    bench.py's headline, config-4 and election-rounds segments
    (bench.py:1484-1489; election rounds cut from 2,400 to 600 ticks).
    The protocol-feature path: bench.py's reads segment (bench.py:1490,
    600 ticks as there) and the flagship entry's feature mix. The client
    path: bench.py's client segment (bench.py:1088-1112 at :1491's
    50,000 groups, with its flight ring) and its admission-capped top
    rung (bench.py:1207-1208: rate 0.5, cap 8). The nemesis path, with
    the flight ring as bench.py records it: the gray-failure segment
    (bench.py:898 at :1492's 50,000 groups), the five rungs of the
    pressure knee (bench.py:1230 at :1497's 20,000 groups; the top rung
    holds the plain reference at every boundary) and the all-kinds
    program on the default protocol (10,000 groups)."""
    from raft_tpu_torch.config import RaftConfig
    pressure = tuple((f"pressure-{r}", bench_pressure(20_000, r), 20_000,
                      True, 3 if r == PRESSURE_RATES[-1] else 0)
                     for r in PRESSURE_RATES)
    return (("headline", RaftConfig(seed=42), 100_000, False, 1),
            ("config-4", config4(50_000), 50_000, False, 1),
            ("election-rounds", RaftConfig(seed=44, cmds_per_tick=0,
                                           crash_prob=0.5, crash_epoch=32),
             10_000, False, 1),
            ("reads", RaftConfig(seed=45, read_every=4), 50_000, False, 1),
            ("feature-mix", feature_mix(50_000), 50_000, False, 1),
            ("clients", bench_clients(50_000), 50_000, True, 1),
            ("clients-cap", bench_clients(10_000, client_rate=0.5,
                                          client_queue_cap=8), 10_000,
             True, 1),
            ("nemesis", bench_nemesis(50_000), 50_000, True, 1)) + \
        pressure + (("nemesis-all-kinds",
                     RaftConfig(seed=9, nemesis=all_kinds(N_TICKS)), 10_000,
                     False, 1),)


def ptxas_stats(report: str) -> dict:
    """Registers, stack frame, spill stores and loads (bytes) and static
    shared memory of one build's two kernels (without and with the
    flight ring), from its ptxas -v."""
    out = {}
    for part in report.split("Compiling entry function")[1:]:
        ring = "Lb1E" in part.split("'")[1]   # the FLIGHT template argument
        stats = {}
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pat, part)
            stats[key] = int(m.group(1)) if m else 0
        out["ring" if ring else "no_ring"] = stats
    return out


def ptxas_line(stats: dict) -> str:
    return " | ".join(
        f"{name}: {s['registers']} registers, {s['frame']} B frame, "
        f"{s['spill_stores']}/{s['spill_loads']} B spill stores/loads"
        for name, s in stats.items())


def planted_fold(kernel, run, state, plant, cfg, g, dev):
    """Kernel and plain over 3 ticks of a state with one group planted
    per safety predicate (and exactly-once clause): equal, and unsafe in
    exactly those groups."""
    st, m = run.run(cfg, state.init(cfg, g, device=dev), 37)
    st, planted = plant.plant_violations(cfg, st)
    leaves, g = kernel.kinit(cfg, st, m)
    a = kernel.kfinish(cfg, kernel.kstep(cfg, leaves, 37, 3), g, m)
    b = kernel.kfinish(cfg, kernel.kstep_plain(cfg, leaves, 37, 3), g, m)
    err = max_abs_err(a, b)
    unsafe = (~a[1].safety.bool()).nonzero().flatten().tolist()
    if err != 0 or unsafe != sorted(planted.values()):
        raise AssertionError(f"safety fold: max abs err {err}, unsafe "
                             f"groups {unsafe}, planted {planted}")
    return planted


def membership_changed(cfg, st) -> bool:
    from raft_tpu_torch.config import CONFIG_FLAG
    n = st.nodes
    return bool((n.snap_voters != cfg.full_mask).any()
                or ((n.log_payload & CONFIG_FLAG) != 0).any())


def finished(kernel, cfg, leaves, g):
    """(State, Metrics[, Flight]) of a wire pair."""
    out = kernel.kfinish(cfg, leaves, g)
    flight = kernel.kflight(cfg, leaves, g)
    return out if flight is None else out + (flight,)


def chunked(step, cfg, leaves, n_chunks=None):
    """Run `step` over the first `n_chunks` (default: all) CHUNK-tick
    chunks of N_TICKS: (the leaves after each chunk, each chunk's ms by
    CUDA events). An aliased launch writes over its input, so under
    alias_wire each chunk's leaves are kept as copies."""
    outs, ms = [], []
    for at in range(0, N_TICKS, CHUNK)[:n_chunks]:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        leaves = step(cfg, leaves, at, CHUNK)
        e1.record()
        torch.cuda.synchronize()
        outs.append(tuple(x.clone() for x in leaves) if cfg.alias_wire
                    else leaves)
        ms.append(e0.elapsed_time(e1))
    return outs, ms


def reset_counts(kernel):
    for fn in (kernel.kstep, kernel.pack_wire, kernel.unpack_wire):
        fn.launches = 0


def counts(kernel) -> dict:
    return {"fused_chunk": kernel.kstep.launches,
            "wire_pack": kernel.pack_wire.launches,
            "wire_unpack": kernel.unpack_wire.launches}


def expect_counts(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def words_err(a, b) -> int:
    """Largest |a - b| of two int32 tensors (their shapes must agree)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"tensor mismatch {tuple(a.shape)}/{a.dtype} "
                             f"vs {tuple(b.shape)}/{b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def time_ms(fn, reps=20) -> float:
    """Mean ms of `fn()` on the card over `reps` calls (CUDA events),
    after one call to warm up."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def near_ceiling(kernel, state, cohort, cfg, scfg, dev, head, n_head):
    """Phase (g): one resident launch of `cfg` at 97% of the resident
    ceiling that `kernel.hbm_budget` allows now, the fleet's wire built a
    window at a time; then `scfg` streamed past that ceiling (a fresh
    fleet of 110% of it, its State never whole). Each run's first
    `n_head` groups after CHUNK ticks must equal the headline's first
    chunk (`head`, its wire pair) at max abs err 0."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ceiling = kernel.hbm_ceiling_groups(cfg)
    g = ceiling * 97 // 100
    if not kernel.supported(cfg, g) or kernel.supported(cfg, ceiling + 1):
        raise AssertionError(f"(g) {g} groups against a ceiling of {ceiling}")
    step = kernel.window_groups(scfg)
    rows = kernel.working_words_per_group(cfg)
    wire, acc = torch.empty((rows, g), dtype=torch.int32, device=dev), None
    for s0 in range(0, g, step):
        s1 = min(s0 + step, g)
        (w, a), _ = kernel.kinit(cfg, state.init(cfg, s1 - s0, dev,
                                                 first_group=s0))
        wire[:, s0:s1] = w
        acc = a if acc is None else acc
        del w
    reset_counts(kernel)
    outs, ms = chunked(kernel.kstep, cfg, (wire, acc), 1)
    launches = {"resident": counts(kernel)["fused_chunk"]}
    peak = torch.cuda.max_memory_allocated() - before
    del wire, acc   # the input: room for the comparison's temporaries
    e = words_err(outs[0][0][:, :n_head], head[0])
    del outs
    if e or launches["resident"] != 1:
        raise AssertionError(f"(g) resident near the ceiling: first "
                             f"{n_head} groups max abs err {e}")
    print(f"[g] resident headline at {g} groups (97% of the ceiling "
          f"{ceiling}, budget {kernel.hbm_budget()} B free now): one "
          f"{CHUNK}-tick launch {ms[0]:.2f} ms, first {n_head} groups max "
          f"abs err 0; peak {peak} B allocated, hbm_bytes "
          f"{kernel.hbm_bytes(cfg, g)} B", flush=True)
    torch.cuda.empty_cache()
    gs = -(-ceiling * 11 // 10 // step) * step
    if not kernel.supported(scfg, gs, state_on_host=False):
        raise AssertionError(f"(g) {gs} streamed groups do not fit")
    t = time.time()
    hw = cohort.host_wire(scfg, None, device=dev, n_groups=gs)
    t_init = time.time() - t
    reset_counts(kernel)
    stats = {}
    cohort.stream_ticks(scfg, hw, 0, CHUNK, stats=stats)
    launches["streamed"] = counts(kernel)["fused_chunk"]
    n0 = hw.windows[0][1]
    st_s, m_s = kernel.kfinish(scfg, (hw.blocks[0].to(dev), hw.acc), n0)
    st_h, m_h = kernel.kfinish(cfg, head, n_head)
    e = max_abs_err(first_groups(state, st_s, m_s, n_head),
                    first_groups(state, st_h, m_h, n_head))
    if e or launches["streamed"] != len(hw.windows):
        raise AssertionError(f"(g) streamed past the ceiling: first "
                             f"{n_head} groups max abs err {e}")
    print(f"[g] streamed headline at {gs} groups (110% of the resident "
          f"ceiling, {len(hw.windows)} windows of {step}, "
          f"{kernel.host_bytes(scfg, gs, state_on_host=False)} B pinned, "
          f"host budget {kernel.host_budget()} B): first {n_head} groups max "
          f"abs err 0; host wire built in {t_init:.2f} s; compute "
          f"{stats['compute_s']:.4f} s, wall {stats['wall_s']:.4f} s, overlap "
          f"efficiency {stats['overlap_efficiency_measured']:.4f}", flush=True)
    del hw
    return {"resident_groups": g, "resident_ceiling": ceiling,
            "resident_ms": ms[0], "streamed_groups": gs,
            "streamed_wall_s": stats["wall_s"], "launches": launches}


def first_groups(state, st, m, n):
    """The first n groups of a State and of Metrics' per-group lanes."""
    lanes = ("committed", "leaderless", "safety", "client_acked",
             "client_retries")
    return (state._map_named(st, "", lambda _, a: a[:n]),
            tuple(getattr(m, f)[:n] for f in lanes
                  if getattr(m, f) is not None))


def dtypes_follow(state, cfg, st):
    """Raise unless every leaf the narrow spec names has its dtype."""
    spec, bad = state.narrow_spec(cfg), []
    state._map_named(st, "", lambda n, a: bad.append(n)
                     if n in spec and a.dtype != spec[n] else None)
    if bad or not spec:
        raise AssertionError(f"narrow dtypes off the spec: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from raft_tpu_torch.clients import workload
    from raft_tpu_torch.obs import recorder
    from raft_tpu_torch.sim import kernel, run, state
    from raft_tpu_torch.verify import plant

    dev = torch.device("cuda")
    t_start = time.time()

    # 1. the card
    card = gpu_line()
    print(f"[1] gpu: {card}", flush=True)

    # 2. build the flag sets without nemesis and those the runs launch with
    # it, in parallel
    runs = all_runs()
    flag_sets = [f + (False,) for f in itertools.product(
        (False, True), repeat=len(kernel.FEATURES) - 1)]
    flag_sets += sorted({kernel.features(cfg) for _, cfg, *_ in runs}
                        - set(flag_sets))
    t = time.time()
    reports = kernel.build(flag_sets, codec=True)
    print(f"[2] built fused_chunk.cu for {len(flag_sets)} flag sets and "
          f"wire_codec.cu in {time.time() - t:.1f} s", flush=True)
    ptxas = {kernel.flag_name(f): ptxas_stats(reports[f]) for f in flag_sets}
    for name, stats in ptxas.items():
        print(f"[2] {name}: {ptxas_line(stats)}", flush=True)
    plans = {}   # each run's block shape (the launcher's occupancy query)
    for label, cfg, g, fl, _ in runs:
        plans[label] = kernel.launch_plan(cfg, g, recorder.RING if fl else 0)
        print(f"[2] {label}: {kernel.shared_bytes(cfg)} B shared per group; "
              f"block shape {plans[label]}", flush=True)
    print("[2] wire_codec: " + " | ".join(
        ("unpack: " if "unpack" in part.split("'")[1] else "pack: ")
        + "; ".join(ln.strip() for ln in part.splitlines()
                    if "stack frame" in ln or "registers" in ln)
        for part in reports[kernel.CODEC].split(
            "Compiling entry function")[1:]), flush=True)

    # 3. the safety fold on planted violations
    # (the pressure knee's lowest rung: at the top one every client slot
    # is busy, and the exactly-once plant needs an idle one)
    by_label = {r[0]: r for r in runs}
    low = f"pressure-{PRESSURE_RATES[0]}"
    for label, cfg, g in (("headline", runs[0][1], 4096),
                          ("feature-mix", runs[4][1], 1000),
                          ("clients", runs[5][1], 1000),
                          (low, by_label[low][1], 1000)):
        planted = planted_fold(kernel, run, state, plant, cfg, g, dev)
        print(f"[3] {label}, planted violations {planted}: kernel == "
              f"plain, safety 0 in exactly those groups", flush=True)

    # 4. the plain reference of every run
    starts, plain = {}, {}

    def wire(label, cfg, g, fl):
        flight = recorder.flight_init(g, device=dev) if fl else None
        return kernel.kinit(cfg, starts[label], flight=flight)[0]

    for label, cfg, g, fl, n_plain in runs:
        starts[label] = state.init(cfg, g, device=dev)
        plain[label] = chunked(kernel.kstep_plain, cfg,
                               wire(label, cfg, g, fl), n_plain)
        print(f"[4] plain {label}, {g} groups, {n_plain * CHUNK} ticks: "
              f"chunk ms {[round(x, 1) for x in plain[label][1]]}",
              flush=True)

    # 5. every run on the kernel, its counts set to 0 just before it and
    # read just after
    main, launches = {}, {}
    for label, cfg, g, fl, _ in runs:
        leaves = wire(label, cfg, g, fl)
        kernel.kstep.launches = 0
        main[label] = chunked(kernel.kstep, cfg, leaves)
        launches[label] = kernel.kstep.launches
        if launches[label] != N_TICKS // CHUNK:
            raise AssertionError(f"{label} launched the kernel "
                                 f"{launches[label]} times")

    # 6. every chunk boundary against the plain tick, then the readouts
    err, n_cmp = 0, 0
    for label, cfg, g, _, _ in runs:
        for at, (k_out, p_out) in enumerate(zip(main[label][0],
                                                plain[label][0])):
            e = max_abs_err(finished(kernel, cfg, k_out, g),
                            finished(kernel, cfg, p_out, g))
            if e != 0:
                raise AssertionError(f"{label}: kernel != plain after "
                                     f"chunk {at} (max abs err {e})")
            err, n_cmp = max(err, e), n_cmp + 1
    n_launch = sum(launches.values())
    print(f"[6] {n_launch} launches {launches}; {n_cmp} chunk boundaries "
          f"bit-identical to the plain tick (max abs err {err})",
          flush=True)

    out = {}
    for label, cfg, g, _, _ in runs:
        st1, m = kernel.kfinish(cfg, main[label][0][-1], g)
        if run.unsafe_groups(m):
            raise AssertionError(f"{label}: safety bit dropped")
        out[label] = (st1, m, sum(main[label][1]) / 1e3)
    g_head = runs[0][2]
    st1, m, secs = out["headline"]
    rounds = run.total_rounds(m)
    if rounds <= 0:
        raise AssertionError("headline: nothing committed")
    chunk_ms = main["headline"][1]
    plain_ms = sum(plain["headline"][1]) / len(plain["headline"][1])
    print(f"[6] headline {g_head} groups, {N_TICKS} ticks: chunk ms "
          f"{[round(c, 2) for c in chunk_ms]}; {rounds} rounds, "
          f"{rounds / secs:.1f} rounds/s, {secs * 1e3 / N_TICKS:.3f} "
          f"ms/tick; plain {plain_ms / CHUNK:.2f} ms/tick", flush=True)

    st1, m, secs = out["config-4"]
    hist = m.hist.cpu().numpy()
    if hist.sum() <= 0:
        raise AssertionError("config-4: no elections recorded")
    print(f"[6] config-4 {runs[1][2]} groups, {N_TICKS} ticks: "
          f"{run.total_rounds(m) / secs:.1f} rounds/s, elections "
          f"{int(m.elections)}, p50 {run.latency_quantile(hist, 0.5)} "
          f"p99 {run.latency_quantile(hist, 0.99)} ticks, censored "
          f"p50/p99 {run.latency_censored(hist, 0.5)}/"
          f"{run.latency_censored(hist, 0.99)}, max_latency "
          f"{int(m.max_latency)}, safety all 1", flush=True)

    st1, m, secs = out["election-rounds"]
    if int(m.elections) <= 0:
        raise AssertionError("election rounds: no elections")
    print(f"[6] election rounds {runs[2][2]} groups, {N_TICKS} ticks: "
          f"{int(m.elections)} elections, {int(m.elections) / secs:.1f} "
          f"elections/s, safety all 1", flush=True)

    cfg, g = runs[3][1], runs[3][2]
    st1, m, secs = out["reads"]
    reads = kernel.kreads(cfg, main["reads"][0][-1], g)
    if reads <= 0:
        raise AssertionError("reads: no read completed")
    print(f"[6] reads {g} groups, {N_TICKS} ticks: chunk ms "
          f"{[round(c, 2) for c in main['reads'][1]]}; {reads} reads, "
          f"{reads / secs:.1f} reads/s, {run.total_rounds(m) / secs:.1f} "
          f"rounds/s, {secs * 1e3 / N_TICKS:.3f} ms/tick, safety all 1",
          flush=True)

    cfg, g = runs[4][1], runs[4][2]
    st1, m, secs = out["feature-mix"]
    hist = m.hist.cpu().numpy()
    reads = kernel.kreads(cfg, main["feature-mix"][0][-1], g)
    top_term = int(st1.nodes.term.max())
    if not membership_changed(cfg, st1) or reads <= 0 or top_term <= 2:
        raise AssertionError(
            f"feature mix: membership changed "
            f"{membership_changed(cfg, st1)}, reads {reads}, top term "
            f"{top_term}: a feature never fired")
    print(f"[6] feature mix {g} groups, {N_TICKS} ticks: chunk ms "
          f"{[round(c, 2) for c in main['feature-mix'][1]]}; "
          f"{run.total_rounds(m) / secs:.1f} rounds/s, elections "
          f"{int(m.elections)}, p50 {run.latency_quantile(hist, 0.5)} "
          f"p99 {run.latency_quantile(hist, 0.99)} ticks, censored "
          f"p50/p99 {run.latency_censored(hist, 0.5)}/"
          f"{run.latency_censored(hist, 0.99)}, {reads / secs:.1f} "
          f"reads/s, top term {top_term}, membership changed, safety "
          f"all 1", flush=True)

    for label, cfg, g, _, _ in runs[5:7]:
        st1, m, secs = out[label]
        leaves = main[label][0][-1]
        acked, retries = (kernel.kacked(cfg, leaves, g),
                          kernel.kretries(cfg, leaves, g))
        chist = m.client_hist.cpu().numpy()
        ok, why = workload.exactly_once_report(cfg, st1, m)
        shed = (int(st1.clients.shed.sum()) if st1.clients.shed is not None
                else None)
        rows = recorder.flight_rows(kernel.kflight(cfg, leaves, g))
        if not ok or acked <= 0 or retries <= 0 or shed == 0 \
                or len(rows) != recorder.RING:
            raise AssertionError(
                f"{label}: exactly-once {ok} ({why}), acked {acked}, "
                f"retries {retries}, shed {shed}, flight rows {len(rows)}")
        print(f"[6] {label} {g} groups, {N_TICKS} ticks: chunk ms "
              f"{[round(c, 2) for c in main[label][1]]}; {acked} ops "
              f"acked, {acked / secs:.1f} client ops/s, {retries} retries, "
              f"shed {shed}, ack p50 {run.latency_quantile(chist, 0.5)} "
              f"p99 {run.latency_quantile(chist, 0.99)} ticks, censored "
              f"p50/p99 {run.latency_censored(chist, 0.5)}/"
              f"{run.latency_censored(chist, 0.99)}, client_max_lat "
              f"{int(m.client_max_lat)}, {run.total_rounds(m) / secs:.1f} "
              f"rounds/s, {why}, flight ring {rows[0]['tick']}-"
              f"{rows[-1]['tick']}, safety all 1", flush=True)

    from raft_tpu_torch import nemesis
    cfg, g = by_label["nemesis"][1:3]
    st1, m, secs = out["nemesis"]
    hist = m.hist.cpu().numpy()
    rows = recorder.flight_rows(kernel.kflight(cfg, main["nemesis"][0][-1],
                                               g))
    if hist.sum() <= 0 or run.total_rounds(m) <= 0 \
            or len(rows) != recorder.RING:
        raise AssertionError(f"nemesis: elections {int(m.elections)}, "
                             f"rounds {run.total_rounds(m)}, flight rows "
                             f"{len(rows)}")
    print(f"[6] nemesis {g} groups, {N_TICKS} ticks, program "
          f"{nemesis.program_hash(cfg.nemesis)} "
          f"({nemesis.describe(cfg.nemesis)}): chunk ms "
          f"{[round(c, 2) for c in main['nemesis'][1]]}; "
          f"{run.total_rounds(m) / secs:.1f} rounds/s, elections "
          f"{int(m.elections)}, p50 {run.latency_quantile(hist, 0.5)} "
          f"p99 {run.latency_quantile(hist, 0.99)} ticks, censored "
          f"p50/p99 {run.latency_censored(hist, 0.5)}/"
          f"{run.latency_censored(hist, 0.99)}, max_latency "
          f"{int(m.max_latency)}, safety all 1", flush=True)

    knee = None
    for rate in PRESSURE_RATES:
        label = f"pressure-{rate}"
        cfg, g = by_label[label][1:3]
        st1, m, secs = out[label]
        acked = kernel.kacked(cfg, main[label][0][-1], g)
        cl = st1.clients
        shed = int(cl.shed.to(torch.int64).sum())
        admitted = sum(int(x.to(torch.int64).sum())
                       for x in (cl.done, cl.backlog, cl.inflight))
        shed_rate = shed / max(1, shed + admitted)
        chist = m.client_hist.cpu().numpy()
        p99 = run.latency_quantile(chist, 0.99)
        censored = run.latency_censored(chist, 0.99)
        ok, why = workload.exactly_once_report(cfg, st1, m)
        if not ok or acked <= 0 or (rate == PRESSURE_RATES[-1]
                                    and shed <= 0):
            raise AssertionError(f"{label}: exactly-once {ok} ({why}), "
                                 f"acked {acked}, shed {shed}")
        slo = (p99 <= PRESSURE_ACK_SLO_TICKS and not censored
               and shed_rate <= PRESSURE_SHED_SLO)
        if slo and (knee is None or acked / secs > knee[1]):
            knee = (rate, acked / secs, shed_rate)
        print(f"[6] {label} {g} groups, {N_TICKS} ticks, program "
              f"{nemesis.program_hash(cfg.nemesis)}: chunk ms "
              f"{[round(c, 2) for c in main[label][1]]}; {acked} ops "
              f"acked, {acked / secs:.1f} client ops/s, ack p99 {p99} "
              f"ticks, censored {censored}, shed {shed} (rate "
              f"{shed_rate:.4f}), {'meets' if slo else 'misses'} the SLO "
              f"(p99 <= {PRESSURE_ACK_SLO_TICKS}, shed <= "
              f"{PRESSURE_SHED_SLO}), {why}, safety all 1", flush=True)
    print(f"[6] pressure knee: " + (
        f"rate {knee[0]}, {knee[1]:.1f} client ops/s, shed rate "
        f"{knee[2]:.4f}" if knee else "no rung met the SLO"), flush=True)

    # The all-kinds run again on the kernel with each clause dropped in
    # turn (cids kept): each must change the final state. These launches
    # are outside the counted runs.
    label = "nemesis-all-kinds"
    cfg, g = by_label[label][1:3]
    full = main[label][0][-1]
    changed = []
    for c in cfg.nemesis:
        fewer = dataclasses.replace(
            cfg, nemesis=tuple(x for x in cfg.nemesis if x != c))
        leaves = kernel.kinit(fewer, state.init(fewer, g, device=dev))[0]
        leaves = chunked(kernel.kstep, fewer, leaves)[0][-1]
        if max_abs_err(finished(kernel, cfg, leaves, g),
                       finished(kernel, cfg, full, g)) == 0:
            raise AssertionError(f"{label}: dropping "
                                 f"{nemesis.describe((c,))} changed nothing")
        changed.append(nemesis.KIND_NAMES[c[0]])
    st1, m, secs = out[label]
    print(f"[6] {label} {g} groups, {N_TICKS} ticks, program "
          f"{nemesis.program_hash(cfg.nemesis)}: chunk ms "
          f"{[round(c, 2) for c in main[label][1]]}; "
          f"{run.total_rounds(m) / secs:.1f} rounds/s, elections "
          f"{int(m.elections)}; dropping any one clause changes the final "
          f"state ({', '.join(changed)}), safety all 1", flush=True)

    paths = {}   # launches of each path of the slice's dials

    # (a) the packed wire: bench.py --pack-wire's dials, each run held
    # to phase 5's at every chunk boundary, the codec's words to the
    # plain pack of the same state
    codec_err, codec_n = 0, {"wire_pack": 0, "wire_unpack": 0}
    for label in ("headline", "config-4", "clients", "nemesis"):
        _, cfg, g, fl, _ = by_label[label]
        pcfg = dataclasses.replace(cfg, **PACK_WIRE)
        reset_counts(kernel)
        outs, ms = chunked(kernel.kstep, pcfg, wire(label, pcfg, g, fl))
        final = kernel.kfinish(pcfg, outs[-1], g)
        got = counts(kernel)
        expect_counts(f"(a) {label}", got, {"fused_chunk": 3,
                                            "wire_pack": 4,
                                            "wire_unpack": 4})
        for k in codec_n:
            codec_n[k] += got[k]
        paths.setdefault("packed", 0)
        paths["packed"] += got["fused_chunk"]
        for at, (p_out, u_out) in enumerate(zip(outs, main[label][0])):
            e = max_abs_err(finished(kernel, pcfg, p_out, g),
                            finished(kernel, cfg, u_out, g))
            work = kernel.unpack_wire(pcfg, p_out[0])
            plain_work, ov = kernel.unpack(pcfg, p_out[0])
            c = max(words_err(work, plain_work), words_err(work, u_out[0]),
                    words_err(kernel.pack(pcfg, u_out[0]), p_out[0]),
                    words_err(kernel.pack_wire(pcfg, work, p_out[0]),
                              kernel.pack(pcfg, plain_work, ov)),
                    words_err(p_out[1], u_out[1]))
            if e or c or int(ov.sum()):
                raise AssertionError(f"(a) {label}: packed != unpacked "
                                     f"after chunk {at} (state {e}, codec "
                                     f"{c}, ring flags {int(ov.sum())})")
            codec_err = max(codec_err, c)
        if max_abs_err(final, kernel.kfinish(cfg, main[label][0][-1], g)):
            raise AssertionError(f"(a) {label}: final state differs")
        rows = kernel.wire_words_per_group(pcfg, recorder.RING if fl else 0)
        print(f"[a] {label} packed, {g} groups: {rows * 4} B/group at rest "
              f"(unpacked {main[label][0][0][0].shape[0] * 4}); ms per launch "
              f"{sum(ms) / len(ms):.2f} (unpacked, phase 5: "
              f"{sum(main[label][1]) / len(main[label][1]):.2f}); "
              f"launches {got}; 3 boundaries max abs err 0, codec words == "
              f"plain pack/unpack", flush=True)
    # the codec kernels and their plain versions, timed at the headline
    _, cfg, g, _, _ = runs[0]
    pcfg = dataclasses.replace(cfg, **PACK_WIRE)
    rest = kernel.pack(pcfg, main["headline"][0][-1][0])
    work = kernel.unpack_wire(pcfg, rest)
    codec = {
        "wire_unpack": dict(
            replaces="raft_tpu/sim/pkernel.py:1901",
            ms=time_ms(lambda: kernel.unpack_wire(pcfg, rest, work)),
            plain_ms=time_ms(lambda: kernel.unpack(pcfg, rest), 5),
            words=rest.shape[0] + work.shape[0]),
        "wire_pack": dict(
            replaces="raft_tpu/sim/pkernel.py:1847",
            ms=time_ms(lambda: kernel.pack_wire(pcfg, work, rest)),
            plain_ms=time_ms(lambda: kernel.pack(
                pcfg, work, kernel.ring_flags(pcfg, rest)), 5),
            words=rest.shape[0] + work.shape[0] + 1)}
    for name, c in codec.items():
        c["bound_ms"] = c["words"] * 4 * g / HBM_BYTES_PER_S * 1e3
        print(f"[a] {name} at {g} headline groups: {c['ms']:.4f} ms per "
              f"launch, plain {c['plain_ms']:.3f} ms, bound by bytes "
              f"{c['bound_ms']:.4f} ms ({c['words'] * 4} B/group)",
              flush=True)
    del rest, work

    # (b) wire_hist=False: State, lanes and Flight as phase 5's, the
    # caller's histograms passed through
    for label in ("headline", "clients"):
        _, cfg, g, fl, _ = by_label[label]
        hcfg = dataclasses.replace(cfg, wire_hist=False)
        reset_counts(kernel)
        outs, ms = chunked(kernel.kstep, hcfg, wire(label, hcfg, g, fl))
        got = counts(kernel)
        expect_counts(f"(b) {label}", got, {"fused_chunk": 3,
                                            "wire_pack": 0,
                                            "wire_unpack": 0})
        paths["no_hist"] = paths.get("no_hist", 0) + got["fused_chunk"]
        m5 = out[label][1]
        base = run.metrics_init(g, clients=cfg.clients_u32 != 0,
                                device=dev)._replace(
            hist=m5.hist, client_hist=m5.client_hist)
        for at, (h_out, u_out) in enumerate(zip(outs, main[label][0])):
            st_h, m_h = kernel.kfinish(hcfg, h_out, g, base)
            st_u, m_u = kernel.kfinish(cfg, u_out, g)
            want = m_u._replace(hist=base.hist, client_hist=base.client_hist)
            e = max(max_abs_err((st_h, m_h), (st_u, want)),
                    max_abs_err(kernel.kflight(hcfg, h_out, g) or (),
                                kernel.kflight(cfg, u_out, g) or ()))
            if e or h_out[1].shape[0] != (3 if cfg.clients_u32 else 2):
                raise AssertionError(f"(b) {label}: chunk {at} differs "
                                     f"(max abs err {e})")
        print(f"[b] {label} wire_hist=False, {g} groups: acc "
              f"{h_out[1].shape[0]} words; ms per launch "
              f"{sum(ms) / len(ms):.2f} (phase 5: "
              f"{sum(main[label][1]) / len(main[label][1]):.2f}); "
              f"3 boundaries max abs err 0, histograms passed through",
              flush=True)

    # (c) the narrow dials and donate_scan: values as phase 5's, dtypes
    # on the spec, no latch
    for label in ("config-4", "clients"):
        _, cfg, g, fl, _ = by_label[label]
        ncfg = dataclasses.replace(cfg, **NARROW)
        st0 = state.init(ncfg, g, device=dev)
        dtypes_follow(state, ncfg, st0)
        reset_counts(kernel)
        flight = recorder.flight_init(g, device=dev) if fl else None
        leaves = kernel.kinit(ncfg, st0, flight=flight)[0]
        outs, ms = chunked(kernel.kstep, ncfg, leaves)
        got = counts(kernel)
        expect_counts(f"(c) {label}", got, {"fused_chunk": 3,
                                            "wire_pack": 0,
                                            "wire_unpack": 0})
        paths["narrow"] = paths.get("narrow", 0) + got["fused_chunk"]
        for at, (n_out, u_out) in enumerate(zip(outs, main[label][0])):
            st_n, m_n = kernel.kfinish(ncfg, n_out, g)   # refuses a latch
            dtypes_follow(state, ncfg, st_n)
            st_u, m_u = kernel.kfinish(cfg, u_out, g)
            e = max(max_abs_err((state.widen_state(ncfg, st_n), m_n),
                                (st_u, m_u)),
                    max_abs_err(kernel.kflight(ncfg, n_out, g) or (),
                                kernel.kflight(cfg, u_out, g) or ()))
            if e or bool(state.narrow_overflow(st_n).any()):
                raise AssertionError(f"(c) {label}: chunk {at} differs "
                                     f"(max abs err {e})")
        print(f"[c] {label} narrow + donate_scan, {g} groups: "
              f"{len(state.narrow_spec(ncfg))} leaves narrow, ms per launch "
              f"{sum(ms) / len(ms):.2f}; 3 boundaries max abs err 0, "
              f"dtypes on the spec, no latch", flush=True)

    # (d) the refusals, on the card
    rcfg = dataclasses.replace(runs[0][1], pack_ring=True)
    st = state.init(rcfg, 1000, device=dev)
    lt = st.nodes.log_term.clone()
    lt[7, 2, 5] = 1 << 16
    leaves = kernel.kstep(rcfg, kernel.kinit(rcfg, st._replace(
        nodes=st.nodes._replace(log_term=lt)))[0], 0, 20)
    flagged = kernel.ring_flags(rcfg, leaves[0]).nonzero().flatten().tolist()
    try:
        kernel.kfinish(rcfg, leaves, 1000)
        raise AssertionError("(d) kfinish took a set ring-overflow flag")
    except ValueError as e:
        if "pack_ring" not in str(e) or flagged != [7]:
            raise
        ring_msg = str(e)
    ncfg = dataclasses.replace(runs[0][1], **NARROW)
    wide = state.widen_state(ncfg, state.init(ncfg, 1000, device=dev))
    term = wide.nodes.term.clone()
    term[11, 1] = 1 << 16
    leaves = kernel.kstep(ncfg, kernel.kinit(ncfg, wide._replace(
        nodes=wide.nodes._replace(term=term)))[0], 0, 20)
    try:
        kernel.kfinish(ncfg, leaves, 1000)
        raise AssertionError("(d) kfinish took a narrow overflow")
    except ValueError as e:
        if "narrow-dtype overflow latched in 1 group(s) (first: [11])" \
                not in str(e):
            raise
        narrow_msg = str(e)
    print(f"[d] refused on the card: {ring_msg[:60]}...; "
          f"{narrow_msg[:66]}...", flush=True)

    # (e) the memory of one headline kstep, beside the byte model
    cfg, g = runs[0][1], runs[0][2]
    memory = {}
    leaves = None   # nothing but the launch's own tensors may come and go
    for name, dials in (("off", {}),
                        ("pack", dict(pack_bools=True, pack_ring=True)),
                        ("pack+alias", PACK_WIRE),
                        ("pack+alias+no-hist", dict(PACK_WIRE,
                                                    wire_hist=False))):
        mcfg = dataclasses.replace(cfg, **dials)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        leaves = kernel.kinit(mcfg, starts["headline"])[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        leaves = kernel.kstep(mcfg, leaves, 0, CHUNK)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        model = kernel.hbm_bytes(mcfg, g)
        memory[name] = dict(measured=peak, model=model,
                            resident_ceiling=kernel.hbm_ceiling_groups(mcfg),
                            streamed_ceiling=kernel.streamed_ceiling_groups(
                                dataclasses.replace(
                                    mcfg, stream_groups=True,
                                    cohort_blocks=STREAM_BLOCKS)))
        leaves = None
        print(f"[e] {name}: peak {peak} B measured, {model} B modelled "
              f"(hbm_bytes; measured - model {peak - model} B, "
              f"{peak / g:.2f} vs {model / g:.2f} B/group); ceilings on "
              f"this card {memory[name]['resident_ceiling']} groups "
              f"resident, {memory[name]['streamed_ceiling']} streamed "
              f"(host {kernel.host_budget()} B, card "
              f"{kernel.hbm_budget()} B)", flush=True)
        if abs(peak - model) > 2 ** 20:
            raise AssertionError(f"(e) {name}: measured peak {peak} B, "
                                 f"model {model} B")

    # (f) the headline at a million groups streamed through the card in
    # windows of 100,352, against the resident run of the same groups
    cfg = runs[0][1]
    scfg = dataclasses.replace(cfg, pack_bools=True, pack_ring=True,
                               stream_groups=True,
                               cohort_blocks=STREAM_BLOCKS)
    st0 = state.init(cfg, STREAM_GROUPS, device=dev)
    torch.cuda.synchronize()
    t = time.time()
    outs, res_ms = chunked(kernel.kstep, cfg, kernel.kinit(cfg, st0)[0], 1)
    resident = kernel.kfinish(cfg, outs[0], STREAM_GROUPS)
    torch.cuda.synchronize()
    t_res = time.time() - t
    del outs
    from raft_tpu_torch.parallel import cohort
    reset_counts(kernel)
    stats = {}
    t = time.time()
    streamed = cohort.prun_streamed(scfg, st0, CHUNK, stats=stats,
                                    device=dev)
    torch.cuda.synchronize()
    t_str = time.time() - t
    got = counts(kernel)
    n_win = len(cohort.cohort_windows(scfg, STREAM_GROUPS))
    expect_counts("(f) streamed", got, {"fused_chunk": n_win,
                                        "wire_pack": 2 * n_win,
                                        "wire_unpack": 2 * n_win})
    paths["streamed"] = got["fused_chunk"]
    e = max_abs_err(resident, streamed)
    if e or n_win != -(-STREAM_GROUPS // kernel.window_groups(scfg)):
        raise AssertionError(f"(f) streamed != resident (max abs err {e}, "
                             f"{n_win} windows)")
    rounds = run.total_rounds(streamed[1])
    print(f"[f] streamed {STREAM_GROUPS} groups, {CHUNK} ticks, {n_win} "
          f"windows of {kernel.window_groups(scfg)}: max abs err 0 against "
          f"the resident run; {rounds} rounds, "
          f"{rounds / stats['wall_s']:.1f} rounds/s over the pipeline's "
          f"wall ({rounds / stats['compute_s']:.1f} over its launches); "
          f"h2d {stats['h2d_s']:.4f} s, compute {stats['compute_s']:.4f} s, "
          f"d2h {stats['d2h_s']:.4f} s, wall {stats['wall_s']:.4f} s, "
          f"overlap efficiency {stats['overlap_efficiency_measured']:.4f}; "
          f"prun_streamed {t_str:.2f} s end to end; the resident launch "
          f"{res_ms[0]:.2f} ms, kinit-kstep-kfinish {t_res:.2f} s; launches "
          f"{got}", flush=True)
    del st0, resident, streamed

    # (g) the headline near the resident ceiling (one launch), and
    # streamed past it: the first 100,000 groups are the headline's
    near = near_ceiling(kernel, state, cohort, cfg, scfg, dev,
                        main["headline"][0][0], g_head)
    paths["near_ceiling"] = near["launches"]["resident"]
    paths["streamed_past_ceiling"] = near["launches"]["streamed"]

    # 7. the kernel table: the headline's numbers at the top level, and
    # every run under the flag set it was built with
    def bound(label, cfg, g):
        st1, m, _ = out[label]
        ops = op_count(cfg, g, N_TICKS, starts[label], st1,
                       run.total_rounds(m))
        rows = main[label][0][-1][0].shape[0]   # wire rows, flight included
        by_bytes = 2 * rows * 4 * g / HBM_BYTES_PER_S * 1e3
        by_ops = ops / (N_TICKS // CHUNK) / INT32_OPS_PER_S * 1e3
        return by_bytes, by_ops

    per_run = {}
    for label, cfg, g, fl, _ in runs:
        by_bytes, by_ops = bound(label, cfg, g)
        p_ms = plain[label][1]
        leaves = wire(label, cfg, g, fl)   # steady state: the same input
        steady = time_ms(lambda: kernel.kstep(cfg, leaves, 0, CHUNK), 3)
        del leaves
        per_run[label] = {
            "groups": g, "launches": launches[label],
            "ms": sum(main[label][1]) / len(main[label][1]),
            "steady_ms": steady,
            "plain_ms": sum(p_ms) / len(p_ms) if p_ms else None,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "plan": plans[label]}
        print(f"[7] {label}: per {CHUNK}-tick launch "
              f"{per_run[label]['ms']:.2f} ms (phase 5), {steady:.2f} ms "
              f"(three more from one input); bound by bytes "
              f"{by_bytes:.4f} ms, by operations {by_ops:.4f} ms",
              flush=True)
    by_build = {}
    for label, cfg, *_ in runs:
        by_build.setdefault(kernel.flag_name(kernel.features(cfg)),
                            []).append(label)
    head = per_run["headline"]
    rec = {"name": "fused_chunk", "route": "cuda",
           "source": "raft_tpu_torch/csrc/fused_chunk.cu",
           "replaces": "raft_tpu/sim/pkernel.py:1950",
           "launches": n_launch, "max_abs_err": err,
           "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": None,
           "paths": paths,
           "instantiations": [
               {"flags": name, "launches": sum(launches[lb] for lb in labels),
                "ptxas": ptxas[name],
                "runs": {lb: per_run[lb] for lb in labels}}
               for name, labels in by_build.items()]}
    recs = [rec] + [
        {"name": name, "route": "cuda",
         "source": "raft_tpu_torch/csrc/wire_codec.cu",
         "replaces": c["replaces"], "launches": codec_n[name],
         "max_abs_err": codec_err, "ms": c["ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": "bytes", "library_ms": None}
        for name, c in codec.items()]
    print(f"[7] memory {json.dumps(memory)}", flush=True)
    print(f"[7] near the ceiling {json.dumps(near)}", flush=True)
    print(f"[7] total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": recs}))
    # The script drives one card, cuda:0.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
