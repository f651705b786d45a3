"""Multi-device sweep of the sharded fused-chunk kernel (the PyTorch port's
counterpart of scripts/multichip_sweep.py): a G x devices grid of
`raft_tpu_torch.parallel.kmesh` runs, written as one JSON file.

    python3 scripts/torch_multichip_sweep.py [--quick] [--out FILE]
        [--ticks N] [--gate-ticks N] [--pack] [--alias] [--no-hist]
        [--shards-per-card N] [--streamed-gate G]

Grid: G in {200K, 500K, 1M} headline groups (RaftConfig(seed=42), k=5,
L=32) x devices in {1, 4, 8}; `--quick` takes G = 10,240 only. Per cell:

- the byte model first (`kernel.supported` over the cell's mesh, every
  card's shards within its budget); a cell it refuses is recorded as
  `unsupported` with each device's modeled bytes;
- a cell that needs more cards than are visible is recorded as
  `unavailable`, with the model's per-device bytes and ceilings, and is
  not run. `--shards-per-card N` runs such a cell as N shards on each
  visible card instead (needing ceil(devices / N) cards), labelled so in
  the cell (`shards_per_card`), never under the plain device count;
- the gate: `kmesh.prun_sharded` over `--gate-ticks` ticks, its full
  State and Metrics equal to the single-device `kernel.prun` (where one
  card holds the fleet), `kglobal_sharded` equal to the host's counters,
  and a clean safety fold;
- the timing: two 200-tick warm-up launches, then `--ticks` ticks in
  200-tick `kstep_sharded` launches, host clock with every card
  synchronised; rounds/s from `kglobal_sharded`'s int64 rounds; beside
  it the host's time to queue those launches and the caching
  allocator's new device segments (cudaMalloc calls) and retries over
  them (`torch.cuda.memory_stats`), which show a host stall that the
  wall alone does not place.

A cell is promoted only when the gate passed. `--streamed-gate G` also
holds `cohort.prun_streamed_sharded` of G groups (State on the host)
over every visible card to the one-card kernel, State and Metrics, and
keeps its measured copy/compute split; it fails the script if unequal.
The file also carries the card's name and power limit (nvidia-smi) and
the byte model's predictions. Needs CUDA: without a card the script
exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable as `python3 scripts/...`

from raft_tpu_torch.config import LAYOUT_FIELDS, RaftConfig  # noqa: E402
from raft_tpu_torch.parallel import cohort, groups, kmesh  # noqa: E402
from raft_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from raft_tpu_torch.sim import kernel, run, state  # noqa: E402

G_LIST = (200_000, 500_000, 1_000_000)
QUICK_G = (10_240,)
D_LIST = (1, 4, 8)
CHUNK = 200


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cards(n: int) -> list:
    return [torch.device("cuda", i) for i in range(n)]


def model(cfg, g: int, n: int) -> dict:
    """The byte model of `g` groups over `n` distinct cards, each given
    the first card's budget: each card's bytes (the first holds the whole
    fleet's gather and finish) and the resident ceiling."""
    budget = kernel.hbm_budget()
    return {"hbm_bytes_by_device": {
                str(k): v for k, v in kernel.mesh_hbm_bytes(
                    cfg, g, cards(n)).items()},
            "hbm_ceiling_groups": kernel.mesh_ceiling_groups(
                cfg, cards(n), hbm=budget),
            "hbm_budget_bytes": budget}


def equal(a, b) -> bool:
    """Two trees of tensors (State, Metrics, tuples of them) equal leaf
    by leaf, compared on the first's device."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if a is None or b is None:
        return a is None and b is None
    return all(equal(x, y) for x, y in zip(a, b))


def gate(cfg, g: int, ticks: int, mesh) -> dict:
    st0 = state.init(cfg, g, device=mesh[0])
    shards, _ = kmesh.kinit_sharded(cfg, st0, mesh)
    shards = kmesh.kstep_sharded(cfg, shards, 0, ticks, mesh)
    gm = kmesh.kglobal_sharded(cfg, shards, g, mesh)
    st_sh, m_sh = kmesh.kfinish_sharded(cfg, shards, g)
    del shards
    out = {"gate_ticks": ticks,
           "counters_equal": bool(
               int(gm.rounds) == run.total_rounds(m_sh)
               and int(gm.elections) == int(m_sh.elections)
               and torch.equal(gm.hist.to(m_sh.hist.device), m_sh.hist)
               and int(gm.max_latency) == int(m_sh.max_latency)),
           "unsafe_groups": int(gm.unsafe)}
    if kernel.supported(cfg, g):
        out["vs_kernel_1dev"] = equal((st_sh, m_sh),
                                      kernel.prun(cfg, st0, ticks))
    out["state_identical"] = out.get("vs_kernel_1dev")
    return out


def timed(cfg, g: int, ticks: int, mesh) -> dict:
    shards, _ = kmesh.kinit_sharded(cfg, state.init(cfg, g,
                                                    device=mesh[0]), mesh)
    for at in (0, CHUNK):
        shards = kmesh.kstep_sharded(cfg, shards, at, CHUNK, mesh)
    base = int(kmesh.kglobal_sharded(cfg, shards, g, mesh).rounds)
    n = max(1, ticks // CHUNK)
    used = sorted(set(mesh), key=str)

    def allocator(key):
        return sum(torch.cuda.memory_stats(d).get(key, 0) for d in used)

    mallocs, retries = (allocator("segment.all.allocated"),
                        allocator("num_alloc_retries"))
    tic = time.perf_counter()
    for c in range(n):
        shards = kmesh.kstep_sharded(cfg, shards, (c + 2) * CHUNK, CHUNK,
                                     mesh)
    queued = time.perf_counter() - tic
    for d in used:
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - tic
    gm = kmesh.kglobal_sharded(cfg, shards, g, mesh)
    return {"timed_ticks": n * CHUNK, "timed_wall_s": wall,
            "timed_enqueue_s": queued,
            "timed_cuda_mallocs": allocator("segment.all.allocated") - mallocs,
            "timed_alloc_retries": allocator("num_alloc_retries") - retries,
            "rounds": int(gm.rounds) - base,
            "rounds_per_sec": (int(gm.rounds) - base) / wall,
            "timed_unsafe_groups": int(gm.unsafe)}


def streamed_gate(cfg, g: int, ticks: int, mesh) -> dict:
    """`cohort.prun_streamed_sharded` of `g` groups whose State lies on
    the host, over `mesh`, against the single-device kernel
    (`kernel.prun`) on the first card: full State and Metrics equal (the
    reference's `streamed_sharded_gate`), with the run's measured split."""
    scfg = dataclasses.replace(cfg, stream_groups=True)
    st0 = state.init(cfg, g, device="cpu")
    stats = {}
    tic = time.perf_counter()
    got = cohort.prun_streamed_sharded(scfg, st0, ticks, mesh, stats=stats)
    wall = time.perf_counter() - tic
    want = kernel.prun(cfg, groups.take(st0, None, None, 0, g, mesh[0])[0],
                       ticks)
    return {"groups": g, "mesh": [str(x) for x in mesh], "ticks": ticks,
            "cohort_blocks": scfg.cohort_blocks,
            "equal_to_kernel_1dev": equal(got, want), "run_wall_s": wall,
            "stats": stats}


def cell(cfg, g: int, d: int, args, n_cards: int) -> dict:
    out = {"groups": g, "devices": d, "promoted": False,
           "model": model(cfg, g, d)}
    if d > n_cards and not args.shards_per_card:
        out["status"] = f"unavailable: {n_cards} card(s) visible"
        return out
    per = args.shards_per_card if d > n_cards else 1
    cards = math.ceil(d / per)
    if cards > n_cards:
        out["status"] = (f"unavailable: {cards} card(s) needed at "
                         f"{per} shards a card, {n_cards} visible")
        return out
    mesh = make_mesh(devices=[torch.device("cuda", i // per)
                              for i in range(d)])
    out.update(shards_per_card=per, cards=cards,
               mesh=[str(x) for x in mesh])
    if not kernel.supported(cfg, g, mesh=mesh):
        out["status"] = "unsupported"
        out["hbm_bytes_by_device"] = {
            str(k): v for k, v in kernel.mesh_hbm_bytes(cfg, g,
                                                        mesh).items()}
        return out
    try:
        out.update(gate(cfg, g, args.gate_ticks, mesh))
        out.update(timed(cfg, g, args.ticks, mesh))
        out["safety_ok"] = (out["unsafe_groups"] == 0
                            and out["timed_unsafe_groups"] == 0)
        out["promoted"] = bool(out["state_identical"] and out["safety_ok"]
                               and out["counters_equal"])
        out["status"] = "ok"
    except (RuntimeError, ValueError) as e:
        out["status"] = f"error: {type(e).__name__}: {e}"
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="torch_multichip.json")
    ap.add_argument("--ticks", type=int, default=600,
                    help="timed ticks per cell")
    ap.add_argument("--gate-ticks", type=int, default=200)
    ap.add_argument("--quick", action="store_true",
                    help=f"G = {QUICK_G[0]:,} only")
    ap.add_argument("--pack", action="store_true",
                    help="pack the wire (pack_bools + pack_ring)")
    ap.add_argument("--alias", action="store_true", help="alias_wire")
    ap.add_argument("--no-hist", action="store_true", help="wire_hist off")
    ap.add_argument("--streamed-gate", type=int, default=0, metavar="G",
                    help="also hold prun_streamed_sharded of G groups "
                         "over every visible card (N shards a card with "
                         "--shards-per-card N) to the one-card kernel")
    ap.add_argument("--shards-per-card", type=int, default=0,
                    help="run a cell past the visible cards as this many "
                         "shards on each card (labelled so)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("torch_multichip_sweep: CUDA is not available")
        return 2
    cfg = RaftConfig(seed=42, pack_bools=args.pack, pack_ring=args.pack,
                     alias_wire=args.alias, wire_hist=not args.no_hist)
    n_cards = torch.cuda.device_count()
    card = card_line()
    log(f"{card}; {n_cards} card(s) visible")
    grid = []
    for g in (QUICK_G if args.quick else G_LIST):
        for d in D_LIST:
            grid.append(cell(cfg, g, d, args, n_cards))
            log(f"  [{g} groups x {d} devices] {grid[-1]['status']}"
                + (f", {grid[-1]['rounds_per_sec']:.1f} rounds/s"
                   if "rounds_per_sec" in grid[-1] else ""))
    if args.streamed_gate:
        smesh = make_mesh(devices=[
            torch.device("cuda", i) for i in range(n_cards)
            for _ in range(max(1, args.shards_per_card))])
        sg = streamed_gate(cfg, args.streamed_gate, args.gate_ticks, smesh)
        log(f"  [streamed {sg['groups']} groups over {sg['mesh']}] equal "
            f"to one card's kernel: {sg['equal_to_kernel_1dev']}, "
            f"{sg['run_wall_s']:.3f} s, overlap "
            f"{sg['stats']['overlap_efficiency_measured']:.4f}")
    scfg = dataclasses.replace(cfg, stream_groups=True)
    report = {
        "card": card, "device_count": n_cards,
        "dials": {k: getattr(cfg, k) for k in LAYOUT_FIELDS},
        "chunk_ticks": CHUNK, "grid": grid,
        "predicted": {d: {"hbm_ceiling_groups": kernel.mesh_ceiling_groups(
            cfg, cards(d), hbm=kernel.hbm_budget()),
            "streamed_ceiling_groups":
            kernel.streamed_ceiling_groups(scfg, n_devices=d)}
            for d in D_LIST}}
    if args.streamed_gate:
        report["streamed_sharded_gate"] = sg
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    log(f"wrote {args.out}")
    bad = [c for c in grid if c["status"].startswith("error")
           or (c["status"] == "ok" and not c["promoted"])]
    if args.streamed_gate and not sg["equal_to_kernel_1dev"]:
        bad.append(sg)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
