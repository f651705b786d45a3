"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--obs-dir DIR]

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
(h) search and triage: a nemesis hunt (scripts/torch_nemesis_search.py's
   base universe, 1,024 groups x 64 ticks, budget 8) equal to the same
   hunt on the CPU; NEMESIS_repro_example.json replayed to its tick and
   leaf; `bisect_divergence` of the plain tick against the kernel
   (launches of 16 ticks and of one) over the hunt's best program and
   over bench_nemesis' knobs at 50,000 groups for 200 ticks, with no
   divergence; a term bump injected into a kernel engine at 50,000
   groups bisected to its tick and `.nodes.term`; the headline 200 ticks
   on the kernel, through `checkpoint.save`/`load`, and 200 more, equal
   to phase 5 at tick 400; `oracle_divergence` of the all-kinds program
   (8 groups, 4 on the CPU oracle, 120 ticks) with none;
(i) observability: the headline, config-4, election rounds, clients and
   nemesis again from phase 5's inputs through `kernel.krun` (3 x
   200-tick launches each), and phase (f)'s streamed headline through
   `cohort.prun_streamed`, under an `obs.trace` Tracer and a
   Heartbeat(every=1): exactly one chunk span per kernel launch (and one
   span per codec launch and per window's h2d, compute and d2h), each
   span's `device_ms` positive and their sum per run, with the heartbeat
   spans' host time between launches, the run's CUDA-event total (within
   2% + 1 ms), each heartbeat's `rounds_total` the wire's
   `kcommitted` at its tick (58,438,894 for the headline at 600), one
   `obs.manifest` record per run with its rates, card, power limit and
   `obs.roofline` stamp (phase (f)'s with the stream keys), the trace
   valid, `obs.history` reading the manifest back and
   `scripts/torch_bench_history.py --check` passing; an `obs` JSON line
   with the trace's path, its event count and each run's attainment.
   Files go to a temporary directory, removed at the end, or with
   `--obs-dir DIR` to DIR. The same Tracer also records phases 2-5 (the
   builds, the library loads, every plain and kernel chunk with the
   allocator's cudaMalloc, cudaFree and retry counts in its args) and
   every garbage collection into that trace; phases 6, (a)-(h) and (j)
   run untraced;
(j) the multi-device drivers (parallel/mesh.py, kmesh.py,
   stream_sched.py and cohort.py's sharded half), each run's launch
   counts set to 0 just before it and read just after, every comparison
   on the card: the mesh of every visible card runs the headline's first
   200-tick chunk (equal to phase 5's, `kglobal_sharded` equal to its
   counters); three shards on the one card run it in 2 x 100-tick
   launches; the clients run (flight ring on) over two shards; phase
   (f)'s packed million through `prun_streamed_sharded` over two shards
   (equal to (f)'s result, with its per-device split and overlap beside
   (f)'s); `kernel.supported` refuses two shards on the card that fit
   alone but not together; and a line says whether the two-card check
   of tests/test_torch_kernel_cuda.py could run (it needs two cards);
(k) the static audit and the stream-ordering hazard prover
   (raft_tpu_torch/analysis/, verify/hazards.py): (k1)
   `analysis.startup_audit("static")` before phase 2's builds (the
   contracts, the byte model and the lint; a drift fails the run);
   (k2) `contracts.kernel_plan_problems` over every run's launch shape
   and the streamed windows' (the launcher's block against the
   shared-memory model of each build loaded), which must be empty;
   (k3) phase (f)'s packed million streamed on one shard, and (j4)'s
   two shards on the card, again under `hazards.capture(observe=True)`
   (every stream, event, copy and launch recorded as it is made): each
   equal to (f)'s result at max abs err 0, its trace with zero hazards
   under `hazards.check_trace`, and a line of its event counts (h2d,
   launches, d2h, waits, record_streams, host syncs) and of its end to
   end seconds between the same run uncaptured before and after it; the
   observed runs' launches join the kernels line's counts;
7. a `kernels` JSON line: launches, times and bound of the fused chunk
   and the two codec kernels, and the same for each flag set's build by
   run (with each run's steady-state time: three launches more from its
   start, CUDA events), with the build's ptxas numbers and each run's
   block shape, and phase (j)'s launches and ms per sharded launch
   beside phase 5's of the same chunk. Every bound comes from
   `obs.roofline` (bytes from `analysis.bytemodel`, operations from
   `roofline.run_ops`); phase (e) also requires
   `bytemodel.byte_model_problems()` to be empty.

The last line is {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

CHUNK, N_TICKS = 200, 600
GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
# bench.py's pressure knee: offered rates, admission cap, SLO
# (bench.py:1200-1208)
PRESSURE_RATES = (0.05, 0.1, 0.2, 0.35, 0.5)
PRESSURE_ACK_SLO_TICKS, PRESSURE_SHED_SLO = 48, 0.05
# bench.py --pack-wire's dials for every segment (bench.py:1391-1421)
PACK_WIRE = dict(pack_bools=True, pack_ring=True, alias_wire=True)
NARROW = dict(narrow_scalars=True, narrow_ring=True, narrow_mailbox=True,
              narrow_clients=True, donate_scan=True)
STREAM_GROUPS, STREAM_BLOCKS = 1_000_000, 98
# Phase (h): the hunt's shape (scripts/torch_nemesis_search.py's base
# universe: groups, ticks, budget), the triage runs' groups and ticks at
# the published widths, the term bump (tick, group, node) and the oracle
# run (groups, oracle groups, ticks: tests/test_nemesis.py's)
HUNT = (1024, 64, 8)
TRIAGE_GROUPS, TRIAGE_TICKS = 50_000, 200
BUMP = (37, 12_345, 1)
ORACLE = (8, 4, 120)
ROOT = Path(__file__).resolve().parent


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


def chunked(step, cfg, leaves, n_chunks=None, engine="cuda"):
    """Run `step` over the first `n_chunks` (default: all) CHUNK-tick
    chunks of N_TICKS: (the leaves after each chunk, each chunk's ms by
    CUDA events). An aliased launch writes over its input, so under
    alias_wire each chunk's leaves are kept as copies. With a tracer
    installed each chunk is a chunk span of `engine`, outside the
    chunk's own events."""
    from raft_tpu_torch.obs import trace
    outs, ms = [], []
    for at in range(0, N_TICKS, CHUNK)[:n_chunks]:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        with trace.chunk_span(engine, at, CHUNK, leaves[0].device) as args:
            before = alloc_counts() if args is not None else None
            e0.record()
            leaves = step(cfg, leaves, at, CHUNK)
            e1.record()
            if args is not None:   # the allocator's work in this chunk
                args.update({k: v - before[k]
                             for k, v in alloc_counts().items()})
        torch.cuda.synchronize()
        outs.append(tuple(x.clone() for x in leaves) if cfg.alias_wire
                    else leaves)
        ms.append(e0.elapsed_time(e1))
    return outs, ms


def trace_gc(trace) -> None:
    """Record each garbage collection as a span on the installed tracer
    (a host pause the launches around it wait for)."""
    import gc
    import threading
    began = {}

    def on_gc(phase, info):
        tracer = trace.get_tracer()
        if tracer is None:
            return
        if phase == "start":
            began["us"] = tracer.now_us()
        elif "us" in began:
            t0 = began.pop("us")
            tracer.complete(f"gc gen{info['generation']}", t0,
                            tracer.now_us() - t0,
                            threading.get_ident() & 0x7FFFFFFF,
                            collected=info["collected"])

    gc.callbacks.append(on_gc)


def alloc_counts() -> dict:
    """The caching allocator's device allocations (cudaMalloc), frees
    (cudaFree) and retries after a failed allocation, so far."""
    s = torch.cuda.memory_stats()
    return {"cuda_mallocs": s.get("segment.all.allocated", 0),
            "cuda_frees": s.get("segment.all.freed", 0),
            "alloc_retries": s.get("num_alloc_retries", 0)}


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


def search_and_triage(dev, head_400, n_head, hunt=HUNT,
                      triage=(TRIAGE_GROUPS, TRIAGE_TICKS), bump=BUMP,
                      oracle=ORACLE):
    """Phase (h): the nemesis search and divergence triage on `dev`, each
    step raising on failure, its kernel launches counted by build:

    - a hunt with torch_nemesis_search.py's base universe, its corpus
      hashes, coverage keys and best score equal to the same hunt on the
      CPU;
    - NEMESIS_repro_example.json replayed: the same tick and leaf;
    - `bisect_divergence` of the plain tick against the kernel over the
      hunt's best program and over bench_nemesis' knobs at the published
      widths: no divergence;
    - a term bump injected into a kernel engine, bisected to its tick
      and `.nodes.term`;
    - the headline (`n_head` groups) 200 ticks on the kernel, through
      `checkpoint.save` and `load`, and 200 more: equal to `head_400`,
      phase 5's wire pair at the 400-tick boundary;
    - `oracle_divergence` of the all-kinds program: none.

    Returns {step: {build: launches}} and the steps' seconds."""
    import importlib.util

    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.nemesis import program_hash
    from raft_tpu_torch.nemesis import search as nsearch
    from raft_tpu_torch.obs.triage import bisect_divergence, oracle_divergence
    from raft_tpu_torch.sim import checkpoint, kernel, state

    spec = importlib.util.spec_from_file_location(
        "torch_nemesis_search", ROOT / "scripts" / "torch_nemesis_search.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    launches, secs = {}, {}

    def step(name, cfg, fn):
        kernel.kstep.launches = 0
        t = time.time()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.time() - t
        launches[name] = {kernel.flag_name(kernel.features(cfg)):
                          kernel.kstep.launches}
        return out

    g, ticks, budget = hunt
    base = script.base_config(0)
    res = step("hunt", base, lambda: nsearch.search(base, g, ticks, budget,
                                                    device=dev))
    ref = nsearch.search(base, g, ticks, budget, device="cpu")
    hashes = [[program_hash(p) for p in r["corpus"]] for r in (res, ref)]
    if hashes[0] != hashes[1] or res["coverage"] != ref["coverage"] \
            or res["best_score"] != ref["best_score"] \
            or res["violations"] != ref["violations"]:
        raise AssertionError(f"(h) the hunt on {dev} differs from the CPU's: "
                             f"{res['coverage']} vs {ref['coverage']}")
    print(f"[h] hunt {g} groups x {ticks} ticks, budget {budget}: corpus "
          f"{hashes[0]}, "
          f"{len(res['coverage'])} coverage keys, best score "
          f"{res['best_score']:.2f}, {len(res['violations'])} violations; "
          f"equal to the same hunt on the CPU; {secs['hunt']:.1f} s on the "
          f"card", flush=True)

    cfg, art = nsearch.load_reproducer(str(ROOT / "NEMESIS_repro_example.json"))
    inj = art["inject"]
    pair = nsearch.term_corruption_pair(inj["tick"], inj["group"],
                                        inj["node"], inj["bump"])
    rep = step("replay", cfg, lambda: nsearch.verify_reproducer(
        art, nsearch.divergence_repro(cfg, pair, art["n_groups"],
                                      art["n_ticks"], device=dev)))
    if rep["leaf_report"] != art["violation"]["leaf_report"]:
        raise AssertionError(f"(h) replay: {rep['leaf_report']}")
    print(f"[h] NEMESIS_repro_example.json replayed: tick {rep['tick']}, "
          f"{rep['leaf_report']}", flush=True)

    best = dataclasses.replace(base, nemesis=res["best"])
    rep = step("bisect_best", best, lambda: nsearch.divergence_repro(
        base, nsearch.plain_vs_kernel, g, ticks, device=dev)(res["best"]))
    if rep is not None:
        raise AssertionError(f"(h) kernel != plain under the hunt's best "
                             f"program: {rep}")
    g_tri, n_tri = triage
    nem = bench_nemesis(g_tri)
    st0 = state.init(nem, g_tri, device=dev)
    rep = step("bisect_nemesis", nem, lambda: bisect_divergence(
        *nsearch.plain_vs_kernel(nem), st0, n_tri))
    if rep is not None:
        raise AssertionError(f"(h) kernel != plain under bench_nemesis: {rep}")
    print(f"[h] bisect_divergence(plain, kernel): none over the hunt's best "
          f"program ({g} groups x {ticks} ticks, {secs['bisect_best']:.1f} "
          f"s) nor bench_nemesis' knobs ({g_tri} groups x {n_tri} ticks, "
          f"{secs['bisect_nemesis']:.1f} s)", flush=True)

    t_b, g_b, k_b = bump
    clean, corrupt = nsearch.term_corruption_pair(
        t_b, g_b, k_b, engine=nsearch.kernel_engine)(nem)
    rep = step("bump", nem, lambda: bisect_divergence(clean, corrupt, st0,
                                                      2 * t_b))
    if rep is None or rep["tick"] != t_b or nsearch._leaf_of(rep) \
            != ".nodes.term" or f"first at [{g_b},{k_b}]" \
            not in rep["leaf_report"]:
        raise AssertionError(f"(h) term bump at tick {t_b}: {rep}")
    print(f"[h] term bump in a kernel engine at tick {t_b}: bisected to tick "
          f"{rep['tick']} in chunk {rep['boundary']}, {rep['leaf_report']}",
          flush=True)
    del st0

    head = RaftConfig(seed=42)
    tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        def hop():
            leaves = kernel.kinit(head, state.init(head, n_head, device=dev))[0]
            st, m = kernel.kfinish(head, kernel.kstep(head, leaves, 0, CHUNK),
                                   n_head)
            path = Path(tmp) / "headline.npz"
            checkpoint.save(path, st, CHUNK, m, cfg=head)
            del st, m, leaves
            st, t, m = checkpoint.load(path, cfg=head, device=dev)
            leaves = kernel.kinit(head, st, m)[0]
            return kernel.kfinish(head, kernel.kstep(head, leaves, t, CHUNK),
                                  n_head, m), path.stat().st_size
        resumed, size = step("checkpoint", head, hop)
    finally:
        shutil.rmtree(tmp)
    e = max_abs_err(resumed, kernel.kfinish(head, head_400, n_head))
    if e:
        raise AssertionError(f"(h) checkpoint hop: max abs err {e}")
    print(f"[h] headline {n_head} groups: {CHUNK} ticks, checkpoint.save "
          f"({size} B), load, {CHUNK} more: max abs err 0 against phase 5 "
          f"at tick {2 * CHUNK}; {secs['checkpoint']:.1f} s", flush=True)
    del resumed

    g_o, g_oo, n_o = oracle
    kinds = dataclasses.replace(script.base_config(9), nemesis=all_kinds(n_o))
    rep = step("oracle", kinds, lambda: oracle_divergence(
        kinds, g_o, n_o, oracle_groups=g_oo, device=dev))
    if rep is not None:
        raise AssertionError(f"(h) oracle divergence: {rep}")
    print(f"[h] oracle_divergence, all-kinds program, {g_o} groups ({g_oo} "
          f"on the oracle) x {n_o} ticks: none; {secs['oracle']:.1f} s",
          flush=True)
    return launches, secs


# Phase (i): the runs traced on the card and the manifest segment each
# records under (bench.py's names; the history trends the first four).
OBS_RUNS = (("headline", "throughput"), ("config-4", "config-4 fault run"),
            ("election-rounds", "election-rounds"),
            ("clients", "client-slo fault mix"),
            ("nemesis", "nemesis gray mix"))
HEADLINE_ROUNDS = 58_438_894   # every chip run since the first


def near(a, total) -> bool:
    """A run's chunk spans' device time plus its heartbeats' host time
    (the card idles while the host reads the lanes) against the run's
    CUDA-event total: within 2% + 1 ms."""
    return abs(a - total) <= 0.02 * total + 1.0


def spans_of(events, prefix) -> list:
    """The complete spans whose names start with `prefix`."""
    return [e for e in events
            if e["ph"] == "X" and e["name"].startswith(prefix)]


def span_ms(events, prefix) -> list:
    """The host durations (ms) of those spans."""
    return [round(e["dur"] / 1e3, 2) for e in spans_of(events, prefix)]


def observability(dev, power_w, obs_dir, tracer, by_label, wire, main,
                  run_ops):
    """Phase (i): the main path's runs again from phase 5's inputs under a
    tracer and a `Heartbeat(every=1)`, through the package's drivers
    (`kernel.krun`, `cohort.prun_streamed`), each with an `emit_manifest`
    record; then the trace validated, the manifest read back by
    `obs.history` and gated by `scripts/torch_bench_history.py --check`.
    Files go to `obs_dir`, or to a temporary directory removed at the
    end. Returns the report printed on the `obs` line."""
    from raft_tpu_torch import nemesis
    from raft_tpu_torch.config import LAYOUT_FIELDS
    from raft_tpu_torch.obs import history, manifest, recorder, roofline
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.parallel import cohort
    from raft_tpu_torch.sim import kernel, run, state

    keep = obs_dir is not None
    d = Path(obs_dir) if keep else Path(tempfile.mkdtemp(
        prefix="chip_smoke_obs_"))
    d.mkdir(parents=True, exist_ok=True)
    paths = {k: d / name for k, name in (("trace", "trace.json"),
                                         ("heartbeat", "heartbeat.jsonl"),
                                         ("manifest", "manifest.jsonl"))}
    for p in paths.values():
        p.unlink(missing_ok=True)
    device = f"cuda:{torch.cuda.get_device_name(0)}"

    def dials(cfg):
        return {**{k: getattr(cfg, k) for k in LAYOUT_FIELDS},
                "nemesis_program_hash": nemesis.program_hash(cfg.nemesis),
                "nemesis_clauses": nemesis.to_json(cfg.nemesis),
                **roofline.narrow_segment_fields(cfg)}

    def beats(pred):
        return [b for b in map(json.loads,
                               paths["heartbeat"].read_text().splitlines())
                if pred(b["label"])]

    report = {}
    trace.set_tracer(tracer)
    trace.set_heartbeat(trace.Heartbeat(str(paths["heartbeat"]), every=1))
    try:
        for label, segment in OBS_RUNS:
            _, cfg, g, fl, _ = by_label[label]
            leaves = wire(label, cfg, g, fl)
            reset_counts(kernel)
            n0 = len(tracer.events)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            with trace.span(f"obs {label}", trace.CAT_SEGMENT, groups=g):
                e0.record()
                leaves = kernel.krun(cfg, leaves, 0, N_TICKS, CHUNK,
                                     label=label)
                e1.record()
                torch.cuda.synchronize()
            total = e0.elapsed_time(e1)
            chunks = spans_of(tracer.events[n0:], "chunk cuda ")
            dev_ms = [e["args"]["device_ms"] for e in chunks]
            host_ms = [e["dur"] / 1e3 for e in chunks]
            beat_ms = sum(e["dur"] / 1e3 for e in spans_of(
                tracer.events[n0:], "heartbeat "))
            n = N_TICKS // CHUNK
            if not (len(chunks) == kernel.kstep.launches == n
                    and min(dev_ms) > 0
                    and near(sum(dev_ms) + beat_ms, total)):
                raise AssertionError(
                    f"(i) {label}: {len(chunks)} chunk spans for "
                    f"{kernel.kstep.launches} launches, device ms {dev_ms} "
                    f"and {beat_ms:.3f} ms of heartbeats against a total "
                    f"of {total:.3f}")
            last = main[label][0][-1]
            if words_err(leaves[0], last[0]) or words_err(leaves[1], last[1]):
                raise AssertionError(f"(i) {label}: the traced run differs "
                                     f"from phase 5's")
            got = [(b["tick"], b["rounds_total"]) for b in
                   beats(lambda x, lb=label: x == lb)]
            want = [(CHUNK * (i + 1),
                     kernel.kcommitted(cfg, main[label][0][i], g))
                    for i in range(n)]
            if got != want or (label == "headline"
                               and got[-1][1] != HEADLINE_ROUNDS):
                raise AssertionError(f"(i) {label}: heartbeats {got}, "
                                     f"kcommitted {want}")
            st1, m = kernel.kfinish(cfg, leaves, g)
            secs = sum(dev_ms) / 1e3
            rates = {"rounds_per_sec": run.total_rounds(m) / secs}
            if label == "election-rounds":
                rates["elections_per_sec"] = int(m.elections) / secs
            if cfg.clients_u32:
                rates["client_ops_per_sec"] = kernel.kacked(cfg, leaves,
                                                            g) / secs
            stamp = roofline.segment_fields(
                cfg, g, "cuda", ticks=N_TICKS, timed_wall_s=secs,
                chunk_ticks=CHUNK, ring=recorder.RING if fl else 0,
                ops=run_ops(label) / N_TICKS)
            manifest.emit_manifest(
                segment, cfg, str(paths["manifest"]), device=device,
                power_limit_w=power_w, engine="cuda-fused-chunk",
                n_groups=g, ticks=N_TICKS, chunk_device_ms=dev_ms,
                chunk_host_ms=host_ms, timed_wall_s=secs,
                trace_path=str(paths["trace"]), **rates, **stamp,
                **dials(cfg), **roofline.stream_segment_fields(cfg))
            enq = [e["args"]["enqueue_ms"] for e in chunks]
            report[label] = {"device_ms": [round(x, 3) for x in dev_ms],
                             "host_ms": [round(x, 3) for x in host_ms],
                             "enqueue_ms": [round(x, 3) for x in enq],
                             "attainment_pct": stamp["attainment_pct"],
                             "bound": stamp["bound"]}
            print(f"[i] {label} {g} groups: {n} chunk spans, device ms "
                  f"{report[label]['device_ms']} (sum {sum(dev_ms):.2f}, "
                  f"with the heartbeats' {beat_ms:.2f}, against the run's "
                  f"events {total:.2f}), host ms "
                  f"{report[label]['host_ms']}, enqueue ms "
                  f"{report[label]['enqueue_ms']}, allocation spans ms "
                  f"{span_ms(tracer.events[n0:], 'kstep alloc')}; "
                  f"{n} heartbeats equal "
                  f"kcommitted at ticks 200/400/600; "
                  f"{', '.join(f'{k} {v:.1f}' for k, v in rates.items())}; "
                  f"attainment {stamp['attainment_pct']}% of the "
                  f"{stamp['bound']} bound", flush=True)
            del leaves, st1, m

        # phase (f)'s streamed headline, ten windows
        cfg = by_label["headline"][1]
        scfg = dataclasses.replace(cfg, pack_bools=True, pack_ring=True,
                                   stream_groups=True,
                                   cohort_blocks=STREAM_BLOCKS)
        st0 = state.init(cfg, STREAM_GROUPS, device=dev)
        reset_counts(kernel)
        n0, stats = len(tracer.events), {}
        with trace.span("obs streamed", trace.CAT_SEGMENT,
                        groups=STREAM_GROUPS):
            st1, m = cohort.prun_streamed(scfg, st0, CHUNK, stats=stats,
                                          device=dev)
            torch.cuda.synchronize()
        ev = tracer.events[n0:]
        spans = {k: spans_of(ev, k)
                 for k in ("chunk cuda ", "wire_pack cuda", "wire_unpack cuda",
                           "h2d c", "compute c", "d2h c", "heartbeat ")}
        beat_ms = sum(e["dur"] / 1e3 for e in spans["heartbeat "])
        got = counts(kernel)
        n_win = len(cohort.cohort_windows(scfg, STREAM_GROUPS))
        dev_ms = [e["args"]["device_ms"] for e in spans["chunk cuda "]]
        hb = beats(lambda x: x.startswith(cohort.ENGINE + ":c"))
        rounds = run.total_rounds(m)
        if not (len(spans["chunk cuda "]) == got["fused_chunk"] == n_win
                and len(spans["wire_pack cuda"]) == got["wire_pack"]
                == 2 * n_win
                and len(spans["wire_unpack cuda"]) == got["wire_unpack"]
                == 2 * n_win
                and all(len(spans[k]) == n_win
                        for k in ("h2d c", "compute c", "d2h c"))
                and min(dev_ms) > 0
                and near(sum(dev_ms) + beat_ms, 1e3 * stats["compute_s"])
                and len(hb) == n_win
                and sum(b["rounds_total"] for b in hb) == rounds
                and all(b["tick"] == CHUNK for b in hb)):
            raise AssertionError(
                f"(i) streamed: spans "
                f"{ {k: len(v) for k, v in spans.items()} }, launches {got}, "
                f"device ms sum {sum(dev_ms):.3f} and "
                f"{beat_ms:.3f} ms of heartbeats against "
                f"{1e3 * stats['compute_s']:.3f}, {len(hb)} heartbeats "
                f"summing {sum(b['rounds_total'] for b in hb)} of {rounds}")
        secs = sum(dev_ms) / 1e3
        stamp = roofline.segment_fields(
            scfg, STREAM_GROUPS, "cuda-streamed", ticks=CHUNK,
            timed_wall_s=secs, chunk_ticks=CHUNK,
            ops=roofline.run_ops(scfg, STREAM_GROUPS, CHUNK, st0, st1,
                                 rounds) / CHUNK)
        manifest.emit_manifest(
            "throughput streamed", scfg, str(paths["manifest"]),
            device=device, power_limit_w=power_w, engine=cohort.ENGINE,
            n_groups=STREAM_GROUPS, ticks=CHUNK,
            rounds_per_sec=rounds / stats["wall_s"],
            launch_rounds_per_sec=rounds / secs, chunk_device_ms=dev_ms,
            pipeline={k: stats[k] for k in ("h2d_s", "compute_s", "d2h_s",
                                            "wall_s")},
            timed_wall_s=stats["wall_s"], trace_path=str(paths["trace"]),
            **stamp, **dials(scfg),
            **roofline.stream_segment_fields(
                scfg, measured=stats["overlap_efficiency_measured"],
                chunk_ticks=CHUNK))
        report["streamed"] = {"attainment_pct": stamp["attainment_pct"],
                              "bound": stamp["bound"],
                              "overlap": stats["overlap_efficiency_measured"]}
        print(f"[i] streamed {STREAM_GROUPS} groups, {n_win} windows: "
              f"{len(spans['chunk cuda '])} chunk spans, "
              f"{len(spans['wire_unpack cuda'])} + "
              f"{len(spans['wire_pack cuda'])} codec spans, {n_win} h2d / "
              f"compute / d2h spans on the stream lanes; launches {got}; "
              f"device ms sum {sum(dev_ms):.2f}, with the heartbeats' "
              f"{beat_ms:.2f}, against the pipeline's compute "
              f"{1e3 * stats['compute_s']:.2f}; {n_win} heartbeats "
              f"summing {rounds} rounds; overlap "
              f"{stats['overlap_efficiency_measured']:.4f} (traced); "
              f"attainment {stamp['attainment_pct']}% of the "
              f"{stamp['bound']} bound", flush=True)
        del st0, st1, m
    finally:
        trace.set_tracer(None)
        trace.set_heartbeat(None)

    tracer.save(str(paths["trace"]))
    problems = trace.validate_trace(json.loads(paths["trace"].read_text()))
    records = [json.loads(x) for x in
               paths["manifest"].read_text().splitlines()]
    segments = [r["segment"] for r in records]
    bad = [r["segment"] for r in records if any(
        r.get(k) is None for k in ("config_hash", "device", "power_limit_w",
                                   "predicted_rounds_per_sec",
                                   "attainment_pct", "bound"))
        or r["bound"] not in ("bytes", "operations")]
    streamed = records[-1]
    if problems or bad or segments != [s for _, s in OBS_RUNS] + [
            "throughput streamed"] or not streamed["stream_groups"] or any(
            streamed.get(k) is None for k in (
                "cohort_blocks", "overlap_efficiency_predicted",
                "overlap_efficiency_measured")):
        raise AssertionError(f"(i) trace problems {problems[:3]}, records "
                             f"missing their stamp {bad}, segments "
                             f"{segments}")
    rows = history.load_history(str(paths["manifest"]))
    rated = [r for r in records if history.rate_of(r)]
    if sorted(r["value"] for r in rows) != sorted(
            r[history.rate_of(r)[0]] for r in rated):
        raise AssertionError(f"(i) history read {len(rows)} rows from "
                             f"{len(rated)} rate-bearing records")
    gate = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_bench_history.py"),
         "--manifest", str(paths["manifest"]), "--check"],
        capture_output=True, text=True, timeout=120)
    if gate.returncode != 0:
        raise AssertionError(f"(i) torch_bench_history.py --check: rc "
                             f"{gate.returncode}\n{gate.stderr}")
    n_spans = len(tracer.events)
    print(f"[i] trace {paths['trace']}: {n_spans} events, schema valid; "
          f"manifest {len(records)} records, {len(rows)} history rows; "
          f"torch_bench_history.py --check rc 0"
          + ("" if keep else " (directory removed)"), flush=True)
    if not keep:
        shutil.rmtree(d)
    return {"trace_path": str(paths["trace"]), "kept": keep,
            "spans": n_spans, "runs": report}


def to_host(tree):
    """A (State, Metrics[, Flight]) tree copied to host memory."""
    from raft_tpu_torch.sim import state
    return tuple(state._map_named(t, "", lambda _, a: a.cpu()) for t in tree)


def trees_err_on(dev, got, host_ref) -> int:
    """max_abs_err of `got` (on `dev`) against a host copy, compared on
    `dev` one leaf at a time."""
    worst = 0
    for x, y in zip(_leaves(got), _leaves(host_ref)):
        worst = max(worst, words_err(x.to(torch.int64),
                                     y.to(dev).to(torch.int64)))
    return worst


def multi_device(dev, by_label, starts, main, f_out):
    """Phase (j): the multi-device drivers (parallel/mesh.py, kmesh.py,
    stream_sched.py, cohort.py's sharded half) on the card, each run's
    launch counts set to 0 just before it and read just after, every
    comparison on the card at max abs err 0:

    - (j1) the mesh of every visible card (`make_mesh()`) runs the
      headline's first chunk (`kinit_sharded`, one `kstep_sharded` of
      200 ticks, `kfinish_sharded`): equal to phase 5's first chunk, and
      `kglobal_sharded` equal to its `kcommitted`, `kelections`, `khist`,
      longest streak and safety;
    - (j2) three shards on the one card (`[cuda:0] * 3`, 33,334 / 33,334
      / 33,332 groups) run it in 2 x 100-tick launches
      (`prun_sharded`): equal to phase 5's first chunk;
    - (j3) the clients run (50,000 groups, flight ring on) over two
      shards, one 200-tick launch: equal to phase 5's first chunk,
      Flight included;
    - (j4) phase (f)'s packed million through `prun_streamed_sharded`
      over two shards on the card: equal to (f)'s result; its rounds/s,
      per-device split and overlap beside (f)'s;
    - (j5) `kernel.supported` refuses two shards on the card whose
      launches together exceed its budget though each alone fits, and
      prints the resident ceiling over two cards of that budget (the
      first card gathers and finishes the whole fleet);
    - (j6) the two-card check (each launch on its tensor's card, the
      plan cache by card: tests/test_torch_kernel_cuda.py) runs only
      with two cards: one line says whether it could.

    Returns {"launches": {run: {kernel: n}}, "ms": {run: ms per sharded
    launch}, "single_ms": phase 5's ms of the same first chunk}."""
    from raft_tpu_torch.obs import recorder
    from raft_tpu_torch.parallel import cohort, kmesh
    from raft_tpu_torch.parallel.mesh import make_mesh, placement
    from raft_tpu_torch.sim import kernel, run, state

    report = {"launches": {}, "ms": {}, "new_segments_retries": []}

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in "ab"]

    def segments():
        stats = torch.cuda.memory_stats(dev)
        return stats["segment.all.allocated"], stats["num_alloc_retries"]

    def sharded(cfg, st, mesh, ticks, chunk, flight=None):
        """kinit_sharded, kstep_sharded launches of `chunk` ticks timed by
        CUDA events on the current stream (which waits for every
        shard), then (shards, ms per launch); the caching allocator's
        new segments and retries in each launch go to `report`."""
        shards, g = kmesh.kinit_sharded(cfg, st, mesh, flight=flight)
        ms, new = [], []
        for at in range(0, ticks, chunk):
            e0, e1 = events()
            before = segments()
            e0.record()
            shards = kmesh.kstep_sharded(cfg, shards, at, chunk, mesh)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            new.append([b - a for a, b in zip(before, segments())])
        report["new_segments_retries"].append(new)
        return shards, g, ms

    # (j1) the mesh of every visible card
    _, cfg, g, _, _ = by_label["headline"]
    head = main["headline"][0][0]
    mesh = make_mesh()
    st0 = starts["headline"]
    reset_counts(kernel)
    shards, g1, ms = sharded(cfg, st0, mesh, CHUNK, CHUNK)
    report["launches"]["j1"] = counts(kernel)
    gm = kmesh.kglobal_sharded(cfg, shards, g1, mesh)
    e = max_abs_err(kmesh.kfinish_sharded(cfg, shards, g1),
                    kernel.kfinish(cfg, head, g))
    hist = kernel.khist(cfg, head, g)
    longest = int(kernel.kfinish(cfg, head, g)[1].max_latency)
    safe = int((kernel.klane(cfg, head, g, "safety")[0] == 0).sum())
    if e or int(gm.rounds) != kernel.kcommitted(cfg, head, g) \
            or int(gm.elections) != kernel.kelections(cfg, head, g) \
            or not (gm.hist.cpu().numpy() == hist).all() \
            or int(gm.max_latency) != longest or int(gm.unsafe) != safe \
            or report["launches"]["j1"]["fused_chunk"] != len(mesh):
        raise AssertionError(f"(j1) mesh of {len(mesh)} card(s): max abs "
                             f"err {e}, counters {gm.rounds} rounds, "
                             f"launches {report['launches']['j1']}")
    report["ms"]["j1"] = ms
    report["single_ms"] = main["headline"][1][0]
    print(f"[j1] headline {g} groups over the mesh of every visible card "
          f"({[str(d) for d in mesh]}): one {CHUNK}-tick sharded launch "
          f"{ms[0]:.2f} ms (phase 5's chunk: {report['single_ms']:.2f} ms); "
          f"State and Metrics max abs err 0; kglobal_sharded {int(gm.rounds)}"
          f" rounds, {int(gm.elections)} elections, longest streak "
          f"{int(gm.max_latency)}, {int(gm.unsafe)} unsafe: equal to "
          f"kcommitted/kelections/khist", flush=True)
    del shards

    # (j2) three shards on the one card, 2 x 100-tick launches
    mesh = (dev,) * 3
    reset_counts(kernel)
    shards, g2, ms = sharded(cfg, st0, mesh, CHUNK, CHUNK // 2)
    report["launches"]["j2"] = counts(kernel)
    e = max_abs_err(kmesh.kfinish_sharded(cfg, shards, g2),
                    kernel.kfinish(cfg, head, g))
    if e or report["launches"]["j2"]["fused_chunk"] != 6:
        raise AssertionError(f"(j2) three shards on one card: max abs err "
                             f"{e}, launches {report['launches']['j2']}")
    report["ms"]["j2"] = ms
    print(f"[j2] headline over three shards on one card "
          f"({[s1 - s0 for _, s0, s1 in placement(g, mesh)]} groups, a "
          f"stream each): 2 x {CHUNK // 2}-tick sharded launches "
          f"{[round(x, 2) for x in ms]} ms (sum {sum(ms):.2f}; phase 5's "
          f"{CHUNK}-tick chunk {report['single_ms']:.2f}); max abs err 0; "
          f"allocator's new segments, retries by launch "
          f"{report['new_segments_retries'][-1]}", flush=True)
    del shards

    # (j3) the clients run, flight ring on, over two shards
    _, ccfg, gc, fl, _ = by_label["clients"]
    cst, flight = starts["clients"], recorder.flight_init(gc, device=dev)
    mesh = (dev,) * 2
    reset_counts(kernel)
    shards, g3, ms = sharded(ccfg, cst, mesh, CHUNK, CHUNK, flight)
    report["launches"]["j3"] = counts(kernel)
    whole = kmesh.gather(ccfg, shards, dev)
    ref = main["clients"][0][0]
    e = max(max_abs_err(kernel.kfinish(ccfg, whole, g3),
                        kernel.kfinish(ccfg, ref, gc)),
            max_abs_err(kernel.kflight(ccfg, whole, g3),
                        kernel.kflight(ccfg, ref, gc)))
    if e or report["launches"]["j3"]["fused_chunk"] != 2:
        raise AssertionError(f"(j3) clients over two shards: max abs err "
                             f"{e}, launches {report['launches']['j3']}")
    report["ms"]["j3"] = ms
    print(f"[j3] clients {gc} groups over two shards on one card, flight "
          f"ring on: one {CHUNK}-tick sharded launch {ms[0]:.2f} ms (phase "
          f"5's chunk {main['clients'][1][0]:.2f}); State, Metrics and "
          f"Flight max abs err 0", flush=True)
    del shards, whole, flight

    # (j4) phase (f)'s packed million streamed over two shards
    f_ref, f_stats = f_out
    scfg = dataclasses.replace(cfg, pack_bools=True, pack_ring=True,
                               stream_groups=True,
                               cohort_blocks=STREAM_BLOCKS)
    st0 = state.init(cfg, STREAM_GROUPS, device=dev)
    reset_counts(kernel)
    stats = {}
    out = cohort.prun_streamed_sharded(scfg, st0, CHUNK, mesh, stats=stats)
    torch.cuda.synchronize()
    report["launches"]["j4"] = counts(kernel)
    del st0
    e = trees_err_on(dev, out, f_ref)
    n_win = len(cohort.cohort_windows(scfg, STREAM_GROUPS, 2))
    slices = report["launches"]["j4"]["fused_chunk"]
    if e or stats["cohorts"] != n_win or slices != stats["launches"]:
        raise AssertionError(f"(j4) the streamed million over two shards: "
                             f"max abs err {e}, launches "
                             f"{report['launches']['j4']}, stats {stats}")
    rounds = run.total_rounds(out[1])
    report["ms"]["j4"] = 1e3 * stats["compute_s"] / (slices // 2)
    per = stats["per_device"]
    per_dev = stats["overlap_efficiency_per_device_measured"]
    print(f"[j4] streamed {STREAM_GROUPS} groups over two shards on one "
          f"card, {n_win} windows of {kernel.window_groups(scfg, 2)} "
          f"({slices} launches): max abs err 0 against (f); "
          f"{rounds / stats['wall_s']:.1f} rounds/s over the wall "
          f"((f): {rounds / f_stats['wall_s']:.1f}); per device h2d/"
          f"compute/d2h s " + "; ".join(
              f"shard {r['shard']} {r['h2d_s']:.4f}/{r['compute_s']:.4f}/"
              f"{r['d2h_s']:.4f}" for r in per)
          + f" ((f): {f_stats['h2d_s']:.4f}/{f_stats['compute_s']:.4f}/"
          f"{f_stats['d2h_s']:.4f}); wall {stats['wall_s']:.4f} s ((f): "
          f"{f_stats['wall_s']:.4f}); overlap "
          f"{stats['overlap_efficiency_measured']:.4f} ((f): "
          f"{f_stats['overlap_efficiency_measured']:.4f}), per device "
          f"{[round(x, 4) for x in per_dev]}", flush=True)
    del out

    # (j5) two shards on one card share its budget
    card = torch.device("cuda", 0)
    budget = kernel.hbm_budget(card)
    top = kernel.hbm_ceiling_groups(cfg, hbm=budget)
    g5 = 2 * (top * 3 // 4)
    if not kernel.supported(cfg, g5 // 2, hbm=budget) or kernel.supported(
            cfg, g5, mesh=(card,) * 2):
        raise AssertionError(f"(j5) {g5} groups in two shards on one card "
                             f"of {budget} B: supported is wrong")
    need = kernel.mesh_hbm_bytes(cfg, g5, (card,) * 2)[card]
    two = kernel.mesh_ceiling_groups(cfg, (card, torch.device("cuda", 1)),
                                     hbm=budget)
    print(f"[j5] supported: two shards of {g5 // 2} groups on one card "
          f"need {need} B together, more than its budget {budget} B, though "
          f"each alone fits ({kernel.hbm_bytes(cfg, g5 // 2)} B): refused; "
          f"over two cards of that budget the resident ceiling is {two} "
          f"groups (one card's launch: {top}; the first card gathers and "
          f"finishes the whole fleet)", flush=True)

    # (j6) the two-card check
    n_cards = torch.cuda.device_count()
    print(f"[j6] the two-card check (launches on their tensor's card, the "
          f"plan cache by card) " + ("can run" if n_cards >= 2 else
                                     "did not run") +
          f": {n_cards} card(s) visible", flush=True)
    return report


def audit_on_card(dev, runs, f_out):
    """Phase (k2) and (k3): the launcher's block shape against the
    shared-memory model (`contracts.kernel_plan_problems`) for every run
    and the streamed windows, then phase (f)'s packed million streamed on
    one shard and over two shards of the card under an observed capture
    (`hazards.capture(observe=True)`), each held to (f)'s result at max
    abs err 0 with a hazard-free trace, each between the same run
    uncaptured before and after it. Returns {"launches": {run: {kernel:
    n}}, "events": {run: counts}, "seconds": {run: (uncaptured before,
    observed, uncaptured after)}}."""
    from raft_tpu_torch.analysis import contracts
    from raft_tpu_torch.obs import recorder
    from raft_tpu_torch.parallel import cohort
    from raft_tpu_torch.sim import kernel, state
    from raft_tpu_torch.verify import hazards

    cfg = runs[0][1]
    scfg = dataclasses.replace(cfg, pack_bools=True, pack_ring=True,
                               stream_groups=True,
                               cohort_blocks=STREAM_BLOCKS)
    plan_runs = [(label, c, g, recorder.RING if fl else 0)
                 for label, c, g, fl, _ in runs]
    plan_runs += [("streamed window", scfg, kernel.window_groups(scfg), 0),
                  ("streamed shard slice", scfg,
                   kernel.window_groups(scfg, 2) // 2, 0)]
    problems = contracts.kernel_plan_problems(plan_runs)
    if problems:
        raise AssertionError(f"(k2) kernel plans: {problems}")
    builds = {kernel.flag_name(kernel.features(c)) for _, c, _, _ in
              plan_runs}
    print(f"[k2] kernel_plan_problems over {len(plan_runs)} launch shapes "
          f"of {len(builds)} builds: none (groups per block x shared bytes "
          f"per group + the clause table == the block's shared bytes <= "
          f"{kernel.SMEM_PER_BLOCK})", flush=True)

    f_ref, _ = f_out
    st0 = state.init(cfg, STREAM_GROUPS, device=dev)
    report = {"launches": {}, "events": {}, "seconds": {}}
    for label, mesh in (("f", None), ("j4", (dev, dev))):
        def streamed():
            out = (cohort.prun_streamed(scfg, st0, CHUNK, device=dev)
                   if mesh is None else
                   cohort.prun_streamed_sharded(scfg, st0, CHUNK, mesh))
            torch.cuda.synchronize()
            return out

        # the same run uncaptured before and after, for the capture's
        # cost: the first of the three may pay one-time host costs (the
        # pinned store's allocation, a candidate), so the observed run
        # is timed against the one after it (their launches are outside
        # the counted ones)
        t = time.time()
        out = streamed()
        first = time.time() - t
        e = trees_err_on(dev, out, f_ref)
        del out
        events = []
        reset_counts(kernel)
        t = time.time()
        with hazards.capture(events, observe=True):
            out = streamed()
        secs = time.time() - t
        got = counts(kernel)
        e = max(e, trees_err_on(dev, out, f_ref))
        del out
        t = time.time()
        out = streamed()
        bare = time.time() - t
        e = max(e, trees_err_on(dev, out, f_ref))
        del out
        found = hazards.check_trace(events, STREAM_GROUPS)
        n = hazards.counts(events)
        if e or found or n["launches"] != got["fused_chunk"] \
                or n["h2d"] != n["d2h"] or not n["launches"]:
            raise AssertionError(
                f"(k3) observed ({label}): max abs err {e}, hazards "
                f"{[str(h) for h in found[:5]]}, events {n}, launches "
                f"{got}")
        report["launches"][label] = got
        report["events"][label] = n
        report["seconds"][label] = (first, secs, bare)
        print(f"[k3] ({label}) {STREAM_GROUPS} groups streamed "
              + ("on one shard" if mesh is None else
                 "over two shards of the card")
              + f" under an observed capture: max abs err 0 against (f)'s "
              f"uncaptured run; 0 hazards in {len(events)} events; h2d "
              f"{n['h2d']}, launches {n['launches']}, d2h {n['d2h']}, "
              f"waits {n['waits']}, record_streams {n['record_streams']}, "
              f"host syncs {n['host_syncs']}; kernel launches {got}; "
              f"{secs:.2f} s end to end, uncaptured {first:.2f} s before "
              f"it and {bare:.2f} s after it", flush=True)
    del st0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--obs-dir", default=None,
                    help="keep phase (i)'s trace, heartbeat and manifest "
                         "in this directory (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from raft_tpu_torch.analysis import bytemodel
    from raft_tpu_torch.clients import workload
    from raft_tpu_torch.obs import recorder, roofline, trace
    from raft_tpu_torch.sim import kernel, run, state
    from raft_tpu_torch.verify import plant

    dev = torch.device("cuda")
    t_start = time.time()
    # One trace of the build, the plain reference and the kernel runs of
    # phases 2-5, and of phase (i); phases (a)-(h) run untraced (a chunk
    # span waits for its launch, which would change the streamed
    # pipeline's overlap).
    tracer = trace.Tracer()
    trace.set_tracer(tracer)
    trace_gc(trace)

    # 1. the card
    card = gpu_line()
    power_w = float(card.split(",")[-1].split()[0])
    print(f"[1] gpu: {card}", flush=True)

    # (k1) the static audit, before any build: no number off a drifted
    # layout
    from raft_tpu_torch import analysis
    t = time.time()
    analysis.startup_audit(
        "static", log=lambda m: print(f"[k1] {m} ({time.time() - t:.1f} s, "
                                      f"before the builds)", flush=True))

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
        with trace.span(f"plain {label}", trace.CAT_SEGMENT, groups=g):
            plain[label] = chunked(kernel.kstep_plain, cfg,
                                   wire(label, cfg, g, fl), n_plain,
                                   engine="plain")
        print(f"[4] plain {label}, {g} groups, {n_plain * CHUNK} ticks: "
              f"chunk ms {[round(x, 1) for x in plain[label][1]]}",
              flush=True)

    # 5. every run on the kernel, its counts set to 0 just before it and
    # read just after
    main, launches = {}, {}
    for label, cfg, g, fl, _ in runs:
        leaves = wire(label, cfg, g, fl)
        kernel.kstep.launches = 0
        n0 = len(tracer.events)
        with trace.span(f"kernel {label}", trace.CAT_SEGMENT, groups=g):
            main[label] = chunked(kernel.kstep, cfg, leaves)
        launches[label] = kernel.kstep.launches
        ev = tracer.events[n0:]
        chunks = spans_of(ev, "chunk cuda ")
        print(f"[5] {label} traced: device ms "
              f"{[round(e['args']['device_ms'], 2) for e in chunks]}, "
              f"enqueue ms "
              f"{[round(e['args']['enqueue_ms'], 2) for e in chunks]}, "
              f"cudaMallocs {[e['args']['cuda_mallocs'] for e in chunks]}, "
              f"allocation spans ms {span_ms(ev, 'kstep alloc')}, garbage "
              f"collections ms {span_ms(ev, 'gc ')}", flush=True)
        if launches[label] != N_TICKS // CHUNK:
            raise AssertionError(f"{label} launched the kernel "
                                 f"{launches[label]} times")

    trace.set_tracer(None)   # phases 6 and (a)-(h) run untraced

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
    ops = {}

    def run_ops(label):
        """The hash operations of a run of phase 5 (obs.roofline), once."""
        if label not in ops:
            _, cfg, g, _, _ = by_label[label]
            st1, m, _ = out[label]
            ops[label] = roofline.run_ops(cfg, g, N_TICKS, starts[label],
                                          st1, run.total_rounds(m))
        return ops[label]

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
            plain_ms=time_ms(lambda: kernel.unpack(pcfg, rest), 5)),
        "wire_pack": dict(
            replaces="raft_tpu/sim/pkernel.py:1847",
            ms=time_ms(lambda: kernel.pack_wire(pcfg, work, rest)),
            plain_ms=time_ms(lambda: kernel.pack(
                pcfg, work, kernel.ring_flags(pcfg, rest)), 5))}
    for name, b in roofline.codec_roofline(pcfg, g).items():
        c = codec[name]
        c["bound_ms"] = b["bound_ms"]
        print(f"[a] {name} at {g} headline groups: {c['ms']:.4f} ms per "
              f"launch, plain {c['plain_ms']:.3f} ms, bound by bytes "
              f"{c['bound_ms']:.4f} ms ({b['bytes'] // g} B/group, "
              f"obs.roofline)", flush=True)
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

    # (e) the memory of one headline kstep, beside the byte model, and
    # the byte model reconciled (analysis.bytemodel)
    problems = bytemodel.byte_model_problems()
    if problems:
        raise AssertionError("(e) byte model: " + "; ".join(problems))
    print(f"[e] analysis.bytemodel: wire and resident bytes reconciled on "
          f"{len(bytemodel.audit_cfgs())} layouts, flight ring on and off; "
          f"pins {bytemodel.WIRE_PINS} B/group", flush=True)
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
    f_out = (to_host(streamed), stats)   # phase (j4)'s reference
    del st0, resident, streamed

    # (g) the headline near the resident ceiling (one launch), and
    # streamed past it: the first 100,000 groups are the headline's
    near = near_ceiling(kernel, state, cohort, cfg, scfg, dev,
                        main["headline"][0][0], g_head)
    paths["near_ceiling"] = near["launches"]["resident"]
    paths["streamed_past_ceiling"] = near["launches"]["streamed"]

    # (h) search and triage on the card, each step's launches counted
    t = time.time()
    h_launches, h_secs = search_and_triage(dev, main["headline"][0][1],
                                           g_head)
    want = {"bisect_best": -(-HUNT[1] // 16),
            "bisect_nemesis": -(-TRIAGE_TICKS // 16), "checkpoint": 2}
    got = {k: sum(v.values()) for k, v in h_launches.items()}
    if any(got[k] != n for k, n in want.items()) or got["bump"] <= 0:
        raise AssertionError(f"(h) launches {h_launches}")
    per_build = collections.Counter()
    for v in h_launches.values():
        per_build.update(v)
    paths["search_triage"] = sum(per_build.values())
    print(f"[h] search and triage: {time.time() - t:.1f} s (steps "
          f"{ {k: round(v, 1) for k, v in h_secs.items()} }); kernel "
          f"launches by step {got}, by build {dict(per_build)}", flush=True)

    # (i) observability on the card: the main path traced, with its
    # heartbeat, manifest and history
    obs = observability(dev, power_w, args.obs_dir, tracer, by_label, wire,
                        main, run_ops)
    print(json.dumps({"obs": obs}), flush=True)

    # (j) the multi-device drivers: the mesh of every card, shards on
    # one card, the sharded streamed million, the per-card budget
    t = time.time()
    sharded = multi_device(dev, by_label, starts, main, f_out)
    paths["sharded"] = sum(sharded["launches"][k]["fused_chunk"]
                           for k in ("j1", "j2", "j3", "j4"))
    print(f"[j] multi-device drivers: {time.time() - t:.1f} s; launches "
          f"{sharded['launches']}", flush=True)

    # (k) the launch plans, and the streamed runs again under an observed
    # capture, proven free of stream-ordering hazards
    t = time.time()
    observed = audit_on_card(dev, runs, f_out)
    del f_out
    paths["observed"] = sum(v["fused_chunk"]
                            for v in observed["launches"].values())
    print(f"[k] launch plans and observed streams: {time.time() - t:.1f} s "
          f"({card}); launches {observed['launches']}", flush=True)

    # 7. the kernel table: the headline's numbers at the top level, and
    # every run under the flag set it was built with
    per_run = {}
    for label, cfg, g, fl, _ in runs:
        r = roofline.roofline(cfg, g, "cuda", CHUNK, recorder.RING if fl
                              else 0, ops=run_ops(label) / N_TICKS)
        by_bytes = r["hbm_s_per_tick"] * CHUNK * 1e3
        by_ops = r["ops_s_per_tick"] * CHUNK * 1e3
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
              f"{by_bytes:.4f} ms, by operations {by_ops:.4f} ms "
              f"(obs.roofline)", flush=True)
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
           "sharded": {"launches": sharded["launches"],
                       "ms_per_launch": sharded["ms"],
                       "single_device_ms": sharded["single_ms"],
                       "new_segments_retries":
                           sharded["new_segments_retries"]},
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
         "bound_ms": c["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "paths": {"packed": codec_n[name],
                   "sharded_streamed": sharded["launches"]["j4"][name],
                   "observed": sum(v[name] for v in
                                   observed["launches"].values())}}
        for name, c in codec.items()]
    print(f"[7] memory {json.dumps(memory)}", flush=True)
    print(f"[7] near the ceiling {json.dumps(near)}", flush=True)
    print(f"[7] total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
