"""Kernel feature-mix sweep of the PyTorch/CUDA port: each universe
simulated by the fused-chunk CUDA kernel (`raft_tpu_torch.sim.kernel`)
and by the plain PyTorch run loop (`sim.run.run`) from the same State,
which must end bit-identical on the full State and the full Metrics
(committed, leaderless, elections, latency histogram, longest streak,
safety; the client lanes and histogram with clients). Any divergence
prints the universe and its first divergent leaf, and exits 1.

Universes (the JAX package's `scripts/kernel_sweep.py`, field for
field): k cycles {3, 4, 5} and L cycles {16, 32} across a six-row
pairwise covering array over the five feature and fault factors
(PreVote x membership change x leadership transfer x scheduled reads x
partition): every pair of factors shows all four on/off combinations
somewhere in the sweep, asserted at start. Every universe carries
baseline crash and drop churn, so elections, truncations and the
fast-backup path run. Universe n has seed `--seed` + n.

Axes:
  --clients   open-loop exactly-once session traffic in every universe
              (and the exactly-once report on the plain run's end);
  --packed    the kernel on the packed, aliased wire (pack_bools,
              pack_ring, alias_wire: the codec kernels at every launch
              boundary);
  --nemesis   the nemesis cells instead of the matrix: the gray mix,
              disk-full alone, compaction pressure alone, and the
              pressure mix under bounded-admission clients, each the CPU
              oracle against the plain tick (`obs.triage.
              oracle_divergence`) and then the plain tick against the
              kernel, over >= 120 ticks;
  --stream    the kernel half through `parallel/cohort.py`
              (`prun_streamed`, cohort_blocks=1, two launches a window);
  --devices N the kernel half over N shards (`parallel/kmesh.py`
              `prun_sharded`, or with --stream `prun_streamed_sharded`):
              one shard a card on the visible cards when there are N,
              else all N shards on the first card, a stream each.

On the card (the default device, `cuda`; rc 2 without one):
    python3 scripts/torch_kernel_sweep.py [--clients] [--groups 1024]
On the CPU the same plumbing runs with the plain engine in the
kernel's place (no kernel runs there):
    python3 scripts/torch_kernel_sweep.py --device cpu --groups 4 --ticks 16
The JAX package's --interpret has no counterpart: a CUDA kernel has no
interpret mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from raft_tpu_torch.config import RaftConfig  # noqa: E402

# Factor order: (prevote, reconfig, transfer, reads, partition); a
# six-row pairwise covering array over five boolean factors
# (`_check_pairwise` at start).
FACTORS = ("prevote", "reconfig", "transfer", "reads", "partition")
ROWS = (
    (0, 0, 0, 0, 0),
    (1, 1, 1, 1, 1),
    (1, 1, 0, 0, 1),
    (1, 0, 1, 1, 0),
    (0, 1, 1, 0, 0),
    (0, 0, 0, 1, 1),
)


def _check_pairwise(rows):
    for i, j in itertools.combinations(range(len(FACTORS)), 2):
        seen = {(r[i], r[j]) for r in rows}
        if len(seen) != 4:
            raise AssertionError(
                f"covering array broken: factors {FACTORS[i]} x "
                f"{FACTORS[j]} only hit {sorted(seen)}")


def sweep_configs(base_seed: int, clients: bool = False,
                  packed: bool = False):
    """The six sweep universes: k in {3, 4, 5} and L in {16, 32} cycling
    across the covering array's rows, seeds from `base_seed`. `clients`
    swaps the scheduled commands for retrying exactly-once sessions;
    `packed` puts the kernel on the packed, aliased wire."""
    ks = (3, 4, 5)
    ls = (16, 32)
    cl = {}
    if clients:
        cl = dict(sessions=True, cmds_per_tick=0, client_rate=0.25,
                  client_slots=3, client_retry_backoff=6)
    if packed:
        cl.update(pack_bools=True, pack_ring=True, alias_wire=True)
    for n, row in enumerate(ROWS):
        prevote, reconfig, transfer, reads, partition = row
        yield RaftConfig(
            seed=base_seed + n,
            k=ks[n % 3],
            log_cap=ls[n % 2],
            prevote=bool(prevote),
            reconfig_prob=0.8 if reconfig else 0.0, reconfig_epoch=16,
            transfer_prob=0.7 if transfer else 0.0, transfer_epoch=24,
            read_every=4 if reads else 0,
            partition_prob=0.2 if partition else 0.0, partition_epoch=16,
            crash_prob=0.15, crash_epoch=24, drop_prob=0.04,
            **cl,
        )


def universe_name(n: int, clients: bool = False, packed: bool = False,
                  stream: bool = False) -> str:
    """The features of universe n, as the sweep prints them."""
    name = "+".join(f for f, on in zip(FACTORS, ROWS[n]) if on) \
        or "faults-only"
    for on, tag in ((clients, "clients"), (packed, "packed"),
                    (stream, "streamed")):
        if on:
            name += "+" + tag
    return name


def shard_mesh(device, devices: int) -> tuple:
    """N shards: one a card on the visible cards when there are N,
    else all on `device` (the CPU's shards are all "cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= devices:
        return tuple(torch.device("cuda", i) for i in range(devices))
    return (device,) * devices


def plain_run(cfg: RaftConfig, n_groups: int, ticks: int, device):
    """(State, Metrics) of the plain run loop after `ticks` ticks from a
    fresh `state.init` of `n_groups` groups on `device`."""
    from raft_tpu_torch.sim import run, state

    st0 = state.init(cfg, n_groups, device=device)
    return run.run(cfg, st0, ticks, 0, run.metrics_init(
        n_groups, clients=cfg.clients_u32 != 0, device=device))


def kernel_run(cfg: RaftConfig, n_groups: int, ticks: int, device,
               devices: int = 1, stream: bool = False):
    """(State, Metrics) of the kernel path from the same `state.init`:
    `kernel.prun`, or over `devices` shards `kmesh.prun_sharded`, or with
    `stream` the cohort pipeline; on the device (or the first shard's)
    it ran on."""
    from raft_tpu_torch.parallel import cohort, kmesh
    from raft_tpu_torch.sim import kernel, state

    st0 = state.init(cfg, n_groups, device=device)
    mesh = shard_mesh(device, devices) if devices > 1 else None
    if stream:
        scfg = dataclasses.replace(cfg, stream_groups=True, cohort_blocks=1)
        chunk = max(1, ticks // 2)
        if mesh is not None:
            return cohort.prun_streamed_sharded(scfg, st0, ticks, mesh,
                                                chunk_ticks=chunk)
        return cohort.prun_streamed(scfg, st0, ticks, chunk_ticks=chunk,
                                    device=device)
    if mesh is not None:
        return kmesh.prun_sharded(cfg, st0, ticks, mesh)
    return kernel.prun(cfg, st0, ticks)


def engines(cfg: RaftConfig, n_groups: int, ticks: int, device,
            devices: int = 1, stream: bool = False):
    """(plain, kernel): the (State, Metrics) the plain run loop and the
    kernel path reach from the same `state.init` on `device` after
    `ticks` ticks from tick 0."""
    return (plain_run(cfg, n_groups, ticks, device),
            kernel_run(cfg, n_groups, ticks, device, devices, stream))


def reference_on_cpu(cfg: RaftConfig, n_groups: int, ticks: int,
                     oracle: bool = False):
    """A universe's reference half on the CPU, for a worker process
    beside the card's launches: (State, Metrics) of the plain run loop
    as numpy trees, and with `oracle` the CPU oracle's first divergence
    from the plain tick over the first min(8, G) groups (None: lockstep),
    and the seconds it took."""
    from raft_tpu_torch.obs.triage import oracle_divergence
    from raft_tpu_torch.sim import state

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    div = (oracle_divergence(cfg, n_groups, ticks,
                             oracle_groups=min(8, n_groups), device="cpu")
           if oracle else None)
    st, m = plain_run(cfg, n_groups, ticks, "cpu")
    return (state.to_numpy(st), state.to_numpy(m), div,
            time.perf_counter() - t0)


def run_universe(cfg: RaftConfig, n_groups: int, ticks: int, device,
                 devices: int = 1, stream: bool = False):
    """(ok, detail, seconds, unsafe) of one universe: the kernel path
    against the plain run loop on the full State and Metrics (and, with
    clients, the exactly-once report on the plain run's end). `unsafe`
    counts the groups whose per-tick safety bit dropped."""
    from raft_tpu_torch.clients.workload import exactly_once_report
    from raft_tpu_torch.sim import state
    from raft_tpu_torch.sim.run import Metrics, unsafe_groups
    from raft_tpu_torch.utils.trees import trees_equal_why

    t0 = time.perf_counter()
    (stx, mx), (stp, mp) = engines(cfg, n_groups, ticks, device, devices,
                                   stream)
    s_ok, s_why = trees_equal_why(state.to_numpy(stx), state.to_numpy(stp))
    m_ok, m_why = trees_equal_why(state.to_numpy(mx), state.to_numpy(mp),
                                  names=list(Metrics._fields))
    unsafe = unsafe_groups(mx)
    eo_ok, eo_why = True, ""
    if cfg.clients_u32:
        eo_ok, eo_why = exactly_once_report(cfg, stx, mx)
    dt = time.perf_counter() - t0
    if s_ok and m_ok and eo_ok:
        detail = "bit-identical (state + metrics incl. histogram + safety bit)"
        if cfg.clients_u32:
            detail += (f"; {eo_why}; {int(stx.clients.retries.sum())} "
                       f"duplicate-risk retries")
        return True, detail, dt, unsafe
    return (False, f"state: {s_why or 'ok'}; metrics: {m_why or 'ok'}; "
            f"exactly-once: {eo_why or 'ok'}", dt, unsafe)


def nemesis_configs(base_seed: int, ticks: int):
    """[(name, cfg), ...]: the JAX package's four nemesis cells over a
    faulted k=3, L=8 universe at `base_seed`, their programs spanning
    `ticks` ticks, at least 120 (the acceptance gate's soak)."""
    from raft_tpu_torch import nemesis

    ticks = max(ticks, 120)
    base = dict(seed=base_seed, k=3, log_cap=8, compact_every=4,
                drop_prob=0.03, crash_prob=0.1, crash_epoch=24)
    admission = dict(sessions=True, cmds_per_tick=0, client_rate=0.3,
                     client_slots=2, client_queue_cap=4)
    return [
        ("gray-mix", RaftConfig(**base, nemesis=nemesis.gray_mix(ticks))),
        ("disk-full", RaftConfig(**base, nemesis=nemesis.program(
            nemesis.disk_full_follower(0, ticks, p=0.8, epoch=8)))),
        ("compaction", RaftConfig(**base, nemesis=nemesis.program(
            nemesis.compaction_pressure(0, ticks, p=0.5, epoch=8)))),
        ("pressure-mix+admission",
         RaftConfig(**base, **admission,
                    nemesis=nemesis.pressure_mix(ticks))),
    ]


def nemesis_cell(base_seed: int, n_groups: int, ticks: int, device,
                 devices: int = 1) -> int:
    """The --nemesis cells: per cell the CPU oracle against the plain
    tick, lockstep per node per tick on the first min(8, G) groups, then
    the plain tick against the kernel (sharded with --devices) on the
    full State and Metrics. Returns 1 on any divergence or safety
    violation, else 0."""
    from raft_tpu_torch import nemesis
    from raft_tpu_torch.obs.triage import oracle_divergence

    ticks = max(ticks, 120)
    rc = 0
    cells = nemesis_configs(base_seed, ticks)
    for name, cfg in cells:
        print(f"[nemesis:{name}] program "
              f"{nemesis.program_hash(cfg.nemesis)}: "
              f"{nemesis.describe(cfg.nemesis)}", flush=True)
        t0 = time.perf_counter()
        g_oracle = min(8, n_groups)
        div = oracle_divergence(cfg, n_groups, ticks, oracle_groups=g_oracle,
                                device=device)
        if div is not None:
            print(f"[nemesis:{name}] ORACLE vs PLAIN DIVERGED at "
                  f"t={div['tick']} group={div['group']} node={div['node']} "
                  f"field={div['field']}: cpu={div['cpu']} "
                  f"batched={div['batched']}", flush=True)
            rc = 1
            continue
        print(f"[nemesis:{name}] oracle == plain per node per tick "
              f"({g_oracle} groups x {ticks} ticks)", flush=True)
        ok, detail, _, unsafe = run_universe(cfg, n_groups, ticks, device,
                                             devices)
        tag = "ok" if ok else "DIVERGED"
        safe_tag = "ok" if unsafe == 0 else f"VIOLATED({unsafe} groups)"
        print(f"[nemesis:{name}] plain vs kernel: {tag} safety={safe_tag} "
              f"- {detail} ({time.perf_counter() - t0:.1f}s total)",
              flush=True)
        if not (ok and unsafe == 0):
            rc = 1
    if rc == 0:
        print(f"[nemesis] {len(cells)} programs bit-identical on "
              f"oracle/plain/kernel over {n_groups} groups x {ticks} ticks",
              file=sys.stderr)
    return rc


def fits(cfg: RaftConfig, n_groups: int, device, devices: int) -> bool:
    """The kernel takes the universe: its shape, and on a card the run
    within the card's budget (`kernel.supported`)."""
    from raft_tpu_torch.sim import kernel
    if torch.device(device).type != "cuda":
        return kernel.shape_supported(cfg)
    mesh = shard_mesh(device, devices) if devices > 1 else None
    return kernel.supported(cfg, n_groups, mesh=mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--seed", type=int, default=1000,
                    help="base seed; universe n uses seed + n")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel, on the card) or cpu (the "
                    "plain engine in the kernel's place)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the kernel half over this many shards")
    ap.add_argument("--clients", action="store_true",
                    help="exactly-once session traffic in every universe")
    ap.add_argument("--packed", action="store_true",
                    help="the kernel on the packed, aliased wire")
    ap.add_argument("--nemesis", action="store_true",
                    help="the nemesis cells instead of the matrix")
    ap.add_argument("--stream", action="store_true",
                    help="the kernel half through the cohort pipeline")
    args = ap.parse_args(argv)
    _check_pairwise(ROWS)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_kernel_sweep: CUDA is not available (pass --device "
              "cpu for the plain engine's smoke)", file=sys.stderr)
        return 2

    # The contract audit first: a verdict over a drifted wire layout
    # would be about the wrong program.
    from raft_tpu_torch import analysis
    analysis.startup_audit("static", log=lambda s: print(s, file=sys.stderr))

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu: the plain engine in the kernel's place")
    print(f"device: {kind}; {args.groups} groups x {args.ticks} ticks per "
          f"universe" + (f"; kernel over {args.devices} shards "
                         f"{[str(d) for d in shard_mesh(device, args.devices)]}"
                         if args.devices > 1 else ""),
          file=sys.stderr, flush=True)
    if args.nemesis:
        return nemesis_cell(args.seed, args.groups, args.ticks, device,
                            args.devices)

    failures = violations = swept = 0
    for n, cfg in enumerate(sweep_configs(args.seed, args.clients,
                                          args.packed)):
        feats = universe_name(n, args.clients, args.packed, args.stream)
        if not fits(cfg, args.groups, device, args.devices):
            print(f"[{n}] k={cfg.k} L={cfg.log_cap} {feats}: UNSUPPORTED "
                  f"shape (skipped)", flush=True)
            continue
        ok, detail, dt, unsafe = run_universe(cfg, args.groups, args.ticks,
                                              device, args.devices,
                                              args.stream)
        tag = "ok" if ok else "DIVERGED"
        safe_tag = "ok" if unsafe == 0 else f"VIOLATED({unsafe} groups)"
        print(f"[{n}] seed={cfg.seed} k={cfg.k} L={cfg.log_cap} {feats}: "
              f"{tag} safety={safe_tag} - {detail} ({dt:.1f}s)", flush=True)
        failures += 0 if ok else 1
        violations += 0 if unsafe == 0 else 1
        swept += 1
    if failures or violations:
        print(f"{failures} universe(s) DIVERGED, {violations} with safety "
              f"violations", file=sys.stderr)
        return 1
    print(f"sweep clean: every universe bit-identical; per-tick safety bit "
          f"held across all {swept} universes ({args.groups} groups x "
          f"{args.ticks} ticks each"
          + (f", kernel over {args.devices} shards)" if args.devices > 1
             else ")"), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
