"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives raft_tpu_torch's main path at full width: the batched Raft tick
at k=5, L=32, E=4 through the fused-chunk CUDA kernel
(raft_tpu_torch/csrc/fused_chunk.cu), held bit-identical to the port's
plain PyTorch tick on the main path's own inputs. Phases, each of which
raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build the kernel from the checkout's sources (nvcc at first use);
3. the safety fold: a headline state at 4,096 groups with one group
   planted per safety predicate; kernel and plain must agree and clear
   the safety bit in exactly the planted groups;
4. the plain tick over the main path's runs, in the same 200-tick
   chunks, kept as the reference at every chunk boundary;
5. the main path on the kernel, launch counts from 0: the headline
   (RaftConfig(seed=42), 100,000 groups), config-4 (seed 43, crash
   0.3/64, partition 0.2/64, drop 0.02; 50,000 groups) and election
   rounds (seed 44, no commands, crash 0.5/32; 10,000 groups), 600
   ticks each in 3 x 200-tick launches;
6. every chunk boundary of phase 5 against phase 4 (full State and
   Metrics, max abs err 0), then the readouts: rounds/s, ms/tick,
   p50/p99 election latency, censoring, elections/s, safety;
7. a `kernels` JSON line: launches on the main path, times, bound.

The last line is {"ok": true, "device": {...}}. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

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
    floor of the tick's work): the fault schedule draws, the deadline
    draws taken, one payload hash per committed entry, one digest fold
    per applied entry, all counted from this run's states."""
    k = cfg.k
    words = 0
    if cfg.crash_u32:
        words += k * 5
    if cfg.partition_u32:
        words += 4 + k * 5
    if cfg.drop_u32:
        words += k * (k - 1) * 6
    ops = float(words) * FOLD_OPS * g * n_ticks
    draws = int((st1.nodes.rng_draws.to(torch.int64)
                 - st0.nodes.rng_draws.to(torch.int64)).sum())
    applied = int((st1.nodes.applied.to(torch.int64)
                   - st0.nodes.applied.to(torch.int64)).clamp(min=0).sum())
    ops += draws * 5 * FOLD_OPS + committed * 5 * FOLD_OPS
    ops += applied * (2 * MIX_OPS + 4)
    return ops


CHUNK, N_TICKS = 200, 600


def main_path_runs():
    """(label, cfg, groups) of the main path: bench.py's headline,
    config-4 and election-rounds segments (bench.py:1484-1489; election
    rounds cut from 2,400 to 600 ticks)."""
    from raft_tpu_torch.config import RaftConfig
    return (("headline", RaftConfig(seed=42), 100_000),
            ("config-4", config4(50_000), 50_000),
            ("election-rounds", RaftConfig(seed=44, cmds_per_tick=0,
                                           crash_prob=0.5, crash_epoch=32),
             10_000))


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

    # 2. build
    t = time.time()
    kernel.load()
    print(f"[2] built fused_chunk.cu in {time.time() - t:.1f} s", flush=True)

    # 3. the safety fold on planted violations
    runs = main_path_runs()
    cfg = runs[0][1]
    st, m = run.run(cfg, state.init(cfg, 4096, device=dev), 37)
    st, planted = plant.plant_violations(cfg, st)
    leaves, g = kernel.kinit(cfg, st, m)
    a = kernel.kfinish(cfg, kernel.kstep(cfg, leaves, 37, 3), g, m)
    b = kernel.kfinish(cfg, kernel.kstep_plain(cfg, leaves, 37, 3), g, m)
    err = max_abs_err(a, b)
    unsafe = (~a[1].safety.bool()).nonzero().flatten().tolist()
    if err != 0 or unsafe != sorted(planted.values()):
        raise AssertionError(f"safety fold: max abs err {err}, unsafe "
                             f"groups {unsafe}, planted {planted}")
    print(f"[3] planted violations {planted}: kernel == plain, safety 0 in "
          f"exactly those groups", flush=True)

    # 4. the plain reference of every main-path run
    starts, plain = {}, {}
    for label, cfg, g in runs:
        starts[label] = state.init(cfg, g, device=dev)
        leaves, _ = kernel.kinit(cfg, starts[label])
        plain[label] = chunked(kernel.kstep_plain, cfg, leaves)
        print(f"[4] plain {label}, {g} groups, {N_TICKS} ticks: chunk ms "
              f"{[round(x, 1) for x in plain[label][1]]}", flush=True)

    # 5. the main path, launches counted from 0
    kernel.kstep.launches = 0
    main = {}
    for label, cfg, g in runs:
        leaves, _ = kernel.kinit(cfg, starts[label])
        main[label] = chunked(kernel.kstep, cfg, leaves)
    launches = kernel.kstep.launches
    if launches != len(runs) * N_TICKS // CHUNK:
        raise AssertionError(f"the main path launched the kernel "
                             f"{launches} times")

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
    print(f"[6] {launches} launches; every chunk boundary bit-identical "
          f"to the plain tick (max abs err {err})", flush=True)

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
    ops = op_count(cfg, g_head, N_TICKS, starts["headline"], st1, rounds)
    bound_bytes_ms = 2 * kernel._wire_rows(cfg)[1] * 4 * g_head \
        / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / (N_TICKS // CHUNK) / INT32_OPS_PER_S * 1e3

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

    # 7. the kernel table
    rec = {"name": "fused_chunk", "route": "cuda",
           "source": "raft_tpu_torch/csrc/fused_chunk.cu",
           "replaces": "raft_tpu/sim/pkernel.py:1950",
           "launches": launches, "max_abs_err": err,
           "ms": sum(chunk_ms) / len(chunk_ms), "plain_ms": plain_ms,
           "bound_ms": max(bound_bytes_ms, bound_ops_ms),
           "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations"),
           "library_ms": None}
    print(f"[7] per {CHUNK}-tick headline launch: bound by bytes "
          f"{bound_bytes_ms:.4f} ms, by operations {bound_ops_ms:.4f} ms; "
          f"total {time.time() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
