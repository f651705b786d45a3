"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives raft_tpu_torch's paths at full width: the batched Raft tick at
k=5, L=32, E=4 through the fused-chunk CUDA kernel
(raft_tpu_torch/csrc/fused_chunk.cu), held bit-identical to the port's
plain PyTorch tick on each path's own inputs. Phases, each of which
raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernel from the checkout's sources for all sixteen feature
   flag sets (the runs launch three), one nvcc per set, all started
   together; print each build's registers, frame and spills (ptxas -v);
3. the safety fold: a headline state at 4,096 groups and a feature-mix
   state at 1,000 groups, each with one group planted per safety
   predicate; kernel and plain must agree and clear the safety bit in
   exactly the planted groups;
4. the plain tick over every run, in the same 200-tick chunks, kept as
   the reference at every chunk boundary;
5. each run on the kernel, its launch counts set to 0 just before it
   and read just after. The main path: the headline (RaftConfig(seed=42),
   100,000 groups), config-4 (seed 43, crash 0.3/64, partition 0.2/64,
   drop 0.02; 50,000 groups) and election rounds (seed 44, no commands,
   crash 0.5/32; 10,000 groups). The protocol-feature path: reads
   (bench.py bench_reads: seed 45, read_every=4; 50,000 groups) and the
   feature mix (the flagship entry's knobs: every fault class, PreVote,
   reads, membership change and leadership transfer; 50,000 groups).
   600 ticks each in 3 x 200-tick launches;
6. every chunk boundary of phase 5 against phase 4 (full State and
   Metrics, max abs err 0), then the readouts: rounds/s, ms/tick,
   p50/p99 election latency, censoring, elections/s, reads/s, safety,
   and that each feature fired;
7. a `kernels` JSON line: launches, times and bound, and the same for
   each flag set's build by run.

The last line is {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import collections
import itertools
import json
import subprocess
import sys
import time

import torch

GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# int32 CUDA-core rate: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost
# (NVIDIA Hopper architecture white paper).
INT32_OPS_PER_S = 64 * 132 * 1.98e9
MIX_OPS = 7          # mix32: 3 xors, 2 shifts, 2 multiplies
FOLD_OPS = MIX_OPS + 2   # one hash_u32 argument: multiply, add, mix32


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
    draws taken, one payload hash per committed entry and one digest
    fold per applied entry. A run starts at tick 0."""
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
    ops += draws * 5 * FOLD_OPS + committed * 5 * FOLD_OPS
    ops += applied * (2 * MIX_OPS + 4)
    return ops


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


CHUNK, N_TICKS = 200, 600


def all_runs():
    """(label, cfg, groups) of every run. The main path: bench.py's
    headline, config-4 and election-rounds segments (bench.py:1484-1489;
    election rounds cut from 2,400 to 600 ticks). The protocol-feature
    path: bench.py's reads segment (bench.py:1490, 600 ticks as there)
    and the flagship entry's feature mix."""
    from raft_tpu_torch.config import RaftConfig
    return (("headline", RaftConfig(seed=42), 100_000),
            ("config-4", config4(50_000), 50_000),
            ("election-rounds", RaftConfig(seed=44, cmds_per_tick=0,
                                           crash_prob=0.5, crash_epoch=32),
             10_000),
            ("reads", RaftConfig(seed=45, read_every=4), 50_000),
            ("feature-mix", feature_mix(50_000), 50_000))


def ptxas_lines(report: str) -> str:
    """The frame, spill and register lines of one build's ptxas -v."""
    return "; ".join(ln.strip() for ln in report.splitlines()
                     if "stack frame" in ln or "registers" in ln)


def planted_fold(kernel, run, state, plant, cfg, g, dev):
    """Kernel and plain over 3 ticks of a state with one group planted
    per safety predicate: equal, and unsafe in exactly those groups."""
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


def chunked(step, cfg, leaves):
    """Run `step` over N_TICKS in CHUNK-tick calls: (the leaves after
    each chunk, each chunk's ms by CUDA events)."""
    outs, ms = [], []
    for at in range(0, N_TICKS, CHUNK):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        leaves = step(cfg, leaves, at, CHUNK)
        e1.record()
        torch.cuda.synchronize()
        outs.append(leaves)
        ms.append(e0.elapsed_time(e1))
    return outs, ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from raft_tpu_torch.sim import kernel, run, state
    from raft_tpu_torch.verify import plant

    dev = torch.device("cuda")
    t_start = time.time()

    # 1. the card
    card = gpu_line()
    print(f"[1] gpu: {card}", flush=True)

    # 2. build every flag set, in parallel
    runs = all_runs()
    flag_sets = list(itertools.product((False, True),
                                       repeat=len(kernel.FEATURES)))
    t = time.time()
    reports = kernel.build(flag_sets)
    print(f"[2] built fused_chunk.cu for {len(flag_sets)} flag sets in "
          f"{time.time() - t:.1f} s", flush=True)
    for flags in flag_sets:
        print(f"[2] {kernel.flag_name(flags)}: "
              f"{ptxas_lines(reports[flags])}", flush=True)

    # 3. the safety fold on planted violations
    for label, cfg, g in (("headline", runs[0][1], 4096),
                          ("feature-mix", runs[4][1], 1000)):
        planted = planted_fold(kernel, run, state, plant, cfg, g, dev)
        print(f"[3] {label}, planted violations {planted}: kernel == "
              f"plain, safety 0 in exactly those groups", flush=True)

    # 4. the plain reference of every run
    starts, plain = {}, {}
    for label, cfg, g in runs:
        starts[label] = state.init(cfg, g, device=dev)
        leaves, _ = kernel.kinit(cfg, starts[label])
        plain[label] = chunked(kernel.kstep_plain, cfg, leaves)
        print(f"[4] plain {label}, {g} groups, {N_TICKS} ticks: chunk ms "
              f"{[round(x, 1) for x in plain[label][1]]}", flush=True)

    # 5. every run on the kernel, its counts set to 0 just before it and
    # read just after
    main, launches = {}, {}
    for label, cfg, g in runs:
        leaves, _ = kernel.kinit(cfg, starts[label])
        kernel.kstep.launches = 0
        main[label] = chunked(kernel.kstep, cfg, leaves)
        launches[label] = kernel.kstep.launches
        if launches[label] != N_TICKS // CHUNK:
            raise AssertionError(f"{label} launched the kernel "
                                 f"{launches[label]} times")

    # 6. every chunk boundary against the plain tick, then the readouts
    err = 0
    for label, cfg, g in runs:
        for at, (k_out, p_out) in enumerate(zip(main[label][0],
                                                plain[label][0])):
            e = max_abs_err(kernel.kfinish(cfg, k_out, g),
                            kernel.kfinish(cfg, p_out, g))
            if e != 0:
                raise AssertionError(f"{label}: kernel != plain after "
                                     f"chunk {at} (max abs err {e})")
            err = max(err, e)
    n_launch = sum(launches.values())
    print(f"[6] {n_launch} launches {launches}; every chunk boundary "
          f"bit-identical to the plain tick (max abs err {err})",
          flush=True)

    out = {}
    for label, cfg, g in runs:
        st1, m = kernel.kfinish(cfg, main[label][0][-1], g)
        if run.unsafe_groups(m):
            raise AssertionError(f"{label}: safety bit dropped")
        out[label] = (st1, m, sum(main[label][1]) / 1e3)
    cfg, g_head = runs[0][1], runs[0][2]
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

    # 7. the kernel table: the headline's numbers at the top level, and
    # every run under the flag set it was built with
    def bound(label, cfg, g):
        st1, m, _ = out[label]
        ops = op_count(cfg, g, N_TICKS, starts[label], st1,
                       run.total_rounds(m))
        by_bytes = 2 * kernel._wire_rows(cfg)[1] * 4 * g \
            / HBM_BYTES_PER_S * 1e3
        by_ops = ops / (N_TICKS // CHUNK) / INT32_OPS_PER_S * 1e3
        return by_bytes, by_ops

    per_run = {}
    for label, cfg, g in runs:
        by_bytes, by_ops = bound(label, cfg, g)
        per_run[label] = {
            "groups": g, "launches": launches[label],
            "ms": sum(main[label][1]) / len(main[label][1]),
            "plain_ms": sum(plain[label][1]) / len(plain[label][1]),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        print(f"[7] {label}: per {CHUNK}-tick launch "
              f"{per_run[label]['ms']:.2f} ms; bound by bytes "
              f"{by_bytes:.4f} ms, by operations {by_ops:.4f} ms",
              flush=True)
    by_build = {}
    for label, cfg, _ in runs:
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
           "instantiations": [
               {"flags": name, "launches": sum(launches[lb] for lb in labels),
                "runs": {lb: per_run[lb] for lb in labels}}
               for name, labels in by_build.items()]}
    print(f"[7] total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [rec]}))
    # The script drives one card, cuda:0.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
