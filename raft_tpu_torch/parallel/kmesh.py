"""The fused-chunk kernel with the groups axis sharded over a mesh (the
JAX package's `raft_tpu/parallel/kmesh.py`).

Raft groups never talk to each other, so the kernel's multi-device story
is `mesh.run_sharded`'s: cut the groups axis into the mesh's spans
(`mesh.placement`), run the unchanged single-device launch per shard,
reduce the counters at the boundary. A shard is the `(wire, acc)` pair
`kernel.kinit` makes of its span, on its device; `kstep_sharded` runs one
`kernel.kstep` per shard (under the packing dials with its codec
launches) on the shard's stream (`shard_stream`): the card's current
stream when the shard is alone on its card, as a one-card run's, else a
stream of its own, so shards sharing a card overlap as shards on
separate cards do, and no launch waits on another. Each launch carries
a chunk span of engine `cuda-sharded-{n}dev` (`plain-sharded-{n}dev`
for shards on the CPU, which run the plain version).

Streams: a shard on a stream of its own has its launch queued there
after everything the caller queued on the device's current stream (its
inputs), and the current stream waits for it before the call returns,
so the caller sees ordinary tensors. A tensor used on a stream it was
not allocated on is marked with `record_stream`, so the caching
allocator cannot hand its memory out again before that stream is done:
the inputs on the shard's stream, the outputs on the caller's. A shard
alone on its card needs none of this: its launches and its memory stay
on the one stream, as a one-card run's do.

`kglobal_sharded` reduces the counters of the shards' wires (committed
and safety lanes, `acc`'s election count, histogram and longest streak)
on the mesh's first device: the same values as the single-device
`kcommitted`, `kelections` and `khist`. `kfinish_sharded` either gathers
the shards there (`gather`: the wires side by side, the accumulators
reduced) and calls `kernel.kfinish`, so that device holds the whole
fleet at the run's end, or (`shards_out`, `finish_shards`) decodes each
shard on its own device, as the JAX package's sharded `kfinish` keeps
its State sharded: only the Metrics come together on the first device,
the per-group lanes joined and the accumulators reduced.
`kernel.mesh_hbm_bytes` budgets each way.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.recorder import Flight
from raft_tpu_torch.parallel import groups
from raft_tpu_torch.parallel.mesh import (GlobalMetrics, as_shards,
                                          make_mesh, placement,
                                          reduce_counters)
from raft_tpu_torch.sim import kernel, streams
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.run import HIST_SIZE, Metrics
from raft_tpu_torch.sim.state import I32

# Mesh-reduced verdict counters off the kernel wire: the fields of
# mesh.GlobalMetrics.
GlobalKMetrics = GlobalMetrics


def faulted_64_cfg(**overrides) -> RaftConfig:
    """The JAX package's shared sharded-differential universe: 64 faulted
    k=3, L=8 groups (crash, partition, drop); `overrides` layers dials on
    top."""
    cfg = RaftConfig(n_groups=64, k=3, seed=23, drop_prob=0.05,
                     crash_prob=0.2, crash_epoch=16,
                     partition_prob=0.2, partition_epoch=16,
                     log_cap=8, compact_every=4)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def sharded_engine(n_devices: int, device) -> str:
    """The engine string of a sharded launch: `cuda-sharded-{n}dev` on a
    card (obs.roofline classes it as the kernel), else
    `plain-sharded-{n}dev`."""
    kind = "cuda" if torch.device(device).type == "cuda" else "plain"
    return f"{kind}-sharded-{n_devices}dev"


def shard_stream(mesh, j: int):
    """The CUDA stream of shard `j` of `mesh`: the card's current stream
    when no other shard of the mesh shares the card, else the shard's
    own (`_own_stream`)."""
    mesh = make_mesh(devices=mesh)
    dev = mesh[j]
    if mesh.count(dev) == 1:
        return streams.cuda.current_stream(dev)
    return streams.cuda.own_stream(dev, j)


def kinit_sharded(cfg: RaftConfig, st, mesh, metrics: Metrics | None = None,
                  flight: Flight | None = None):
    """`kernel.kinit` of each shard on its device. `st` is a whole State
    or its shards (`mesh.as_shards`); `metrics` and `flight`, whole, are
    cut to the shards' spans. Returns (shards, g): one (wire, acc) pair
    per shard."""
    shards = as_shards(st, mesh)
    g = sum(s.alive_prev.shape[0] for s in shards)
    out = []
    for sh, (dev, s0, s1) in zip(shards, placement(g, mesh)):
        _, m, f = groups.take(None, metrics, flight, s0, s1, dev)
        out.append(kernel.kinit(cfg, sh, m, f)[0])
    return out, g


def kstep_sharded(cfg: RaftConfig, shards, t0: int, n_ticks: int, mesh):
    """One `kernel.kstep` per shard, `n_ticks` ticks from tick `t0`, on
    the shard's stream (`shard_stream`); one of its own is ordered after
    the device's current stream and before it again on return. Returns
    the shards after the ticks (under `alias_wire`, the input pairs
    written over: the inputs are consumed, as with `kstep`). Shard j
    lies on `mesh[j]`."""
    cs = streams.cuda
    mesh = make_mesh(devices=mesh)
    own = []
    out = []
    for j, leaves in enumerate(shards):
        dev = mesh[j]
        engine = sharded_engine(len(mesh), dev)
        side = shard_stream(mesh, j) if dev.type == "cuda" else None
        if side is None or side == cs.current_stream(dev):
            with trace.chunk_span(engine, t0, n_ticks, dev, shard=j):
                out.append(cs.kstep(cfg, leaves, t0, n_ticks))
            continue
        own.append(j)
        cs.wait_stream(side, cs.current_stream(dev))
        with cs.use(side):
            with trace.chunk_span(engine, t0, n_ticks, dev, shard=j):
                res = cs.kstep(cfg, leaves, t0, n_ticks)
        for a in leaves:
            cs.record_stream(a, side)
        out.append(res)
    for j in own:
        main = cs.current_stream(mesh[j])
        cs.wait_stream(main, shard_stream(mesh, j))
        for a in out[j]:
            cs.record_stream(a, main)
    cs.join([a for res in out for a in res])   # the caller's reads
    return out


def _acc_of(cfg: RaftConfig, acc: torch.Tensor):
    """(hist, elections, longest streak) of an accumulator; the
    histogram all zeros under wire_hist=False (nothing was tracked)."""
    h = kernel._hist_size(cfg, acc)
    hist = (acc[:h] if h else
            torch.zeros(HIST_SIZE, dtype=I32, device=acc.device))
    return hist, acc[h], acc[h + 1]


def kglobal_sharded(cfg: RaftConfig, shards, g: int, mesh) -> GlobalKMetrics:
    """The shards' verdict counters reduced on the mesh's first device:
    rounds (the committed lanes' int64 sum), elections, the histogram,
    the longest streak (max) and the groups whose safety bit dropped.
    Group state never leaves its device; five scalars and one `[H]` row
    do."""
    held = sum(w.shape[1] for w, _ in shards)
    if held != g:
        raise ValueError(f"the shards hold {held} groups, not {g}")
    streams.cuda.join([a for sh in shards for a in sh])
    parts = []
    for leaves in shards:
        n = leaves[0].shape[1]
        hist, elections, longest = _acc_of(cfg, leaves[1])
        lane = functools.partial(kernel.klane, cfg, leaves, n)
        parts.append((lane("committed").to(torch.int64).sum(), elections,
                      hist, longest,
                      (1 - lane("safety")).to(torch.int64).sum()))
    return reduce_counters(parts, mesh[0])


def reduce_acc(cfg: RaftConfig, accs: list, device) -> torch.Tensor:
    """Shards' accumulators as one, on `device`: histograms and election
    counts summed, the longest streak and ack latency their max."""
    stacked = torch.stack([a.to(device) for a in accs])
    acc = stacked.sum(dim=0, dtype=I32)
    h = kernel._hist_size(cfg, stacked[0])
    maxed = [h + 1] + ([2 * h + 2] if cfg.clients_u32 else [])
    acc[maxed] = stacked[:, maxed].amax(dim=0)
    return acc


def gather(cfg: RaftConfig, shards, device):
    """The shards as one wire pair on `device`: the wires side by side in
    group order, the accumulators reduced (`reduce_acc`). The wires are
    written into one new wire there, a shard on another device through a
    copy of its wire on `device`, one at a time; one shard already there
    is its own wire."""
    streams.cuda.join([a for sh in shards for a in sh])
    acc = reduce_acc(cfg, [a for _, a in shards], device)
    wires = [w for w, _ in shards]
    if len(wires) == 1 and wires[0].device == device:
        return wires[0], acc
    whole = torch.empty((wires[0].shape[0], sum(w.shape[1] for w in wires)),
                        dtype=I32, device=device)
    at = 0
    for w in wires:
        whole[:, at:at + w.shape[1]].copy_(w.to(device))
        at += w.shape[1]
    return whole, acc


def finish_shards(cfg: RaftConfig, shards: list,
                  metrics_base: Metrics | None = None,
                  flight: bool = False):
    """Each shard's `kernel.kfinish` (and `kflight`) on its own device:
    (State shards, Metrics, Flight shards or None). The Metrics lie on
    the first shard's device, its per-group lanes the shards' joined in
    group order and the rest read off the shards' accumulators reduced
    there (`reduce_acc`), with `metrics_base` folded in: the bits the
    gathered `kfinish` gives. Consumes `shards`: each wire pair is
    dropped once it is decoded."""
    streams.cuda.join([a for sh in shards for a in sh])
    dev0 = shards[0][0].device
    acc = reduce_acc(cfg, [a for _, a in shards], dev0)
    states, lanes, flights = [], [], []
    while shards:
        leaves = shards.pop(0)
        n = leaves[0].shape[1]
        st, m = kernel.kfinish(cfg, leaves, n)
        states.append(st)
        lanes.append(m)
        if flight:
            flights.append(kernel.kflight(cfg, leaves, n))
        del leaves
    per = {f: torch.cat([getattr(m, f).to(dev0) for m in lanes])
           for f in groups.PER_GROUP if getattr(lanes[0], f) is not None}
    m = kernel.kmetrics(cfg, per, acc, metrics_base)
    return states, m, (flights if flight else None)


def kfinish_sharded(cfg: RaftConfig, shards, g: int,
                    metrics_base: Metrics | None = None,
                    shards_out: bool = False):
    """`kernel.kfinish` of the shards gathered on the first shard's
    device (`gather`): the whole (State, Metrics) there; with
    `shards_out`, (the State shards, each on its device, Metrics on the
    first: `finish_shards`)."""
    if shards_out:
        return finish_shards(cfg, list(shards), metrics_base)[:2]
    return kernel.kfinish(cfg, gather(cfg, shards, shards[0][0].device), g,
                          metrics_base)


@trace.spanned("kmesh prun")
def prun_sharded(cfg: RaftConfig, st, n_ticks: int, mesh, t0: int = 0,
                 metrics: Metrics | None = None, flight: Flight | None = None,
                 chunk_ticks: int | None = None):
    """Drop-in for `kernel.prun` with the groups axis sharded over `mesh`:
    the same (State, Metrics[, Flight]), the same bits. `st` is a whole
    State or its shards (`mesh.shard_state`, `checkpoint.load(mesh=)`).
    A whole State comes back whole on the mesh's first device, with the
    whole Flight; shards come back as shards, each State and Flight
    shard decoded on its own device (`finish_shards`), the Metrics one
    value on the first device. The ticks run in `kstep_sharded` launches
    of `chunk_ticks` (default: one launch). Refuses a latched narrow
    state, and on a card a run `kernel.supported` does not fit: the
    kernel's shape, on each card the launches of every shard it holds
    within its budget, and the run's end: on the first card the whole
    fleet's gather and finish, or with shards out each card's finish of
    its own (`kernel.mesh_hbm_bytes`). Spans (`obs.trace`, no-ops unless
    a tracer is installed): `kmesh prun` over the call, with `kmesh cut`,
    `kmesh kinit`, each shard's chunk spans, then `kmesh gather` (whole
    State in) and `kmesh finish` inside."""
    with trace.span("kmesh cut"):
        mesh = make_mesh(devices=mesh)
        shards_out = not isinstance(st, state_mod.State)
        shards = as_shards(st, mesh)
        for sh in shards:
            state_mod.check_narrow_overflow(cfg, sh)
        g = sum(s.alive_prev.shape[0] for s in shards)
        ring = 0 if flight is None else flight.tick.shape[0]
        if any(d.type == "cuda" for d in mesh) and not kernel.supported(
                cfg, g, ring, mesh=mesh, shards_out=shards_out):
            raise ValueError(
                "kmesh: " + ("" if kernel.shape_supported(cfg) else
                             f"{kernel.shape_refusal(cfg)}; ")
                + f"the shards' launches need "
                f"{kernel.mesh_hbm_bytes(cfg, g, mesh, ring, shards_out)} B "
                f"by device, more than a card's budget")
    with trace.span("kmesh kinit"):
        leaves, g = kinit_sharded(cfg, shards, mesh, metrics, flight)
    del shards
    chunk = chunk_ticks or n_ticks
    at, end = int(t0), int(t0) + int(n_ticks)
    while at < end:
        step = min(chunk, end - at)
        leaves = kstep_sharded(cfg, leaves, at, step, mesh)
        at += step
    if shards_out:
        with trace.span("kmesh finish"):
            st2, m2, f2 = finish_shards(cfg, leaves, metrics,
                                        flight is not None)
        return (st2, m2) if flight is None else (st2, m2, f2)
    with trace.span("kmesh gather"):
        whole = gather(cfg, leaves, mesh[0])
    del leaves   # the first device now holds the fleet: free the shards
    with trace.span("kmesh finish"):
        st2, m2 = kernel.kfinish(cfg, whole, g, metrics)
        f2 = None if flight is None else kernel.kflight(cfg, whole, g)
    return (st2, m2) if flight is None else (st2, m2, f2)
