"""Cohort paging: the fleet's wire at rest lives in host memory, and
windows of `cfg.cohort_blocks` 1,024-group blocks stream through the
card under the unchanged kernels (the JAX package's
`raft_tpu/parallel/cohort.py` `host_wire`, `cohort_windows`,
`stream_ticks`, `prun_streamed`, and, over a mesh,
`stream_ticks_sharded` and `prun_streamed_sharded`).

      host memory  [w0 | w1 | w2 | ...]       one wire at rest per group,
                        |        ^            window-major: one contiguous
                  h2d of i+1     |            [P, window] block per window
                        v   d2h of i-1        (and device)
      card         [ prev | current | next ]  O(cohort_blocks)
                              |
                    kstep(s) on the current window

While window i's launches run on the compute stream, window i+1's
host-to-card copy and window i-1's card-to-host copy run on two copy
streams, ordered with CUDA events (window i-1's copy back is queued
before window i's launches); the host waits for that copy before it
allocates the next window, so the card holds at most
`kernel._stream_windows(cfg)` windows at rest (`kernel.cohort_hbm_bytes`)
whatever the fleet's size, and the group ceiling is the host's
(`kernel.streamed_ceiling_groups`). A window is a column slice of the
[P, G] wire, strided in a [P, G] host tensor, so the host store keeps
each window's block contiguous and every copy is one plain transfer.

Over a mesh (`prun_streamed_sharded`), the windows step by the global
window of `kernel.stream_blocks_per_device(cfg, n)` blocks per device and
each splits into whole per-device block slices
(`stream_sched.device_slices`), each slice its own contiguous block of
the one host store (window-major, then device). Every shard runs the
same pipeline over its slices, with its own compute and copy streams
(`stream_sched.lanes`) and its own accumulators, and the host queues
window i of every shard before it waits for any: `stream_sched`'s
`put_window` and `drain_window` move each window's slices. The
launches' engine is `cuda-streamed-sharded-{n}dev`, and the heartbeat
beats once per device and window (`{engine}:c{i}:d{j}`).

Bit-identity is by construction: groups never talk to each other, a
window's launches are the same `kernel.kstep` on the same rows (the
group id rides the wire, so a group's draws are the same wherever it
sits), and each shard's accumulators (`acc`) are one tensor every window
adds into with integer atomics, exact in any order; the shards'
accumulators reduce at the end as `kmesh.gather` reduces them. `kinit`
and `kfinish` run per window slice on the card, so the whole fleet's
working wire never exists there either.

Observability (obs/trace.py): every launch of a window carries a chunk
span with the window's index (`cohort`), a heartbeat record follows each
window's last launch (label `cuda-streamed:c<i>`), and, with a tracer
installed, each window's h2d copy, launches and d2h copy are placed on
the timeline at their device times, one lane per stream (and shard), so
the overlap shows. A chunk span waits for its launch to end before the
host goes on, so while tracing the card idles while the host queues the
next window; window i+1's prefetch and window i-1's copy back still run
beside window i's launches.

CPU tensors (`device="cpu"`, or a mesh of `"cpu"` devices) run the same
windows through the plain versions, synchronously.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.recorder import Flight
from raft_tpu_torch.parallel import groups, kmesh, stream_sched
from raft_tpu_torch.parallel.mesh import make_mesh
from raft_tpu_torch.sim import kernel, streams
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.run import Metrics
from raft_tpu_torch.sim.state import I32, State

# The engine string of a streamed window's launches (its heartbeat label).
ENGINE = "cuda-streamed"


def sharded_engine(n_devices: int) -> str:
    """The engine string of the pipeline over `n_devices` shards:
    `cuda-streamed-sharded-{n}dev` (obs.roofline classes it as the
    kernel); one device keeps `ENGINE`."""
    return ENGINE if n_devices == 1 else f"{ENGINE}-sharded-{n_devices}dev"


@dataclasses.dataclass
class HostWire:
    """The fleet's wire at rest in host memory: `blocks[b]` is the
    contiguous int32 [P, s1 - s0] block of groups `windows[b]`, one per
    window and shard (`owner[b]`), views of one host buffer (pinned when
    the devices are cards); `parts[i]` lists window i's blocks, in shard
    order; `accs[j]` is shard j's accumulators on `mesh[j]`. One device:
    a block per window, `windows` the cohort windows."""

    windows: list
    blocks: list
    accs: list
    g: int
    ring: int
    mesh: tuple
    owner: list
    parts: list

    @property
    def device(self) -> torch.device:
        return self.mesh[0]

    @property
    def acc(self) -> torch.Tensor:
        """The accumulators of a host wire on one device (over a mesh,
        `finish` reduces the shards')."""
        if len(self.mesh) != 1:
            raise ValueError("a sharded host wire has one acc per shard")
        return self.accs[0]


def cohort_windows(cfg: RaftConfig, g: int, n_devices: int = 1) -> list:
    """[(s0, s1), ...]: the group ranges of the windows, `cohort_blocks`
    blocks of 1,024 groups each, the last taking the remainder. Over
    `n_devices`, the JAX package's global step: `stream_blocks_per_device`
    blocks per device (`kernel.window_groups(cfg, n)`), each window split
    by `stream_sched.device_slices`. Real groups only: the reference's
    pad to whole blocks on every device is no group."""
    step = kernel.window_groups(cfg, n_devices)
    return [(s0, min(s0 + step, g)) for s0 in range(0, g, step)]


def host_wire(cfg: RaftConfig, st: State | None,
              metrics: Metrics | None = None, flight: Flight | None = None,
              device="cuda", n_groups: int | None = None,
              mesh=None) -> HostWire:
    """The fleet's wire at rest in host memory: `kernel.kinit` of each
    window's slice on its device, copied into its block. `stream_ticks`
    writes the blocks in place. With `st` None, a fresh fleet of
    `n_groups` groups: each slice's State is `state.init` of its groups
    on its device, so the fleet's State never exists whole. `mesh` (a
    tuple of devices, `mesh.make_mesh`) splits every window over its
    devices; without it, the windows go through `device`. The host
    buffer is pinned when the devices are cards."""
    mesh = ((torch.device(device),) if mesh is None
            else make_mesh(devices=mesh))
    g = st.alive_prev.shape[0] if st is not None else n_groups
    ring = 0 if flight is None else flight.tick.shape[0]
    rows = kernel.wire_words_per_group(cfg, ring)
    buf = torch.empty(rows * g, dtype=I32,
                      pin_memory=any(d.type == "cuda" for d in mesh))
    hw = HostWire([], [], [None] * len(mesh), g, ring, mesh, [], [])
    at = 0
    for w0, w1 in cohort_windows(cfg, g, len(mesh)):
        hw.parts.append([])
        for dev, (lo, hi) in stream_sched.device_slices(mesh, w0, w1):
            j = len(hw.parts[-1])
            s0, s1 = w0 + lo, w0 + hi
            if st is None:
                part = (state_mod.init(cfg, s1 - s0, dev, first_group=s0),
                        None, None if flight is None else
                        Flight(*(a[:, s0:s1].to(dev) for a in flight)))
            else:
                part = groups.take(st, metrics, flight, s0, s1, dev)
            (wire, a), _ = streams.cuda.kinit(cfg, *part)
            block = buf[at:at + rows * (s1 - s0)].view(rows, s1 - s0)
            block.copy_(wire)
            hw.parts[-1].append(len(hw.blocks))
            hw.blocks.append(block)
            hw.windows.append((s0, s1))
            hw.owner.append(j)
            if hw.accs[j] is None:
                hw.accs[j] = a
            at += rows * (s1 - s0)
    return hw


def _launches(cfg, leaves, t0: int, n_ticks: int, chunk: int, ci: int,
              g: int, hw: HostWire, j: int):
    """Window `ci`'s launches on shard `j` (`kernel.krun`, each in a chunk
    span with the window's index): `n_ticks` ticks in chunks of `chunk`,
    then a heartbeat over its `g` groups, the host's time between them
    traced as gaps. Returns (leaves, launches)."""
    n = len(hw.mesh)
    eng = sharded_engine(n)
    extra = {} if n == 1 else {"engine": eng, "shard": j}
    label = f"{eng}:c{ci}" + ("" if n == 1 else f":d{j}")
    with trace.covered(label):
        leaves = kernel.krun(cfg, leaves, t0, n_ticks, chunk, cohort=ci,
                             **extra)
        trace.heartbeat_wire(label, t0 + n_ticks, cfg, leaves, g)
    return leaves, -(-n_ticks // chunk)


def stream_ticks(cfg: RaftConfig, hw: HostWire, t0: int, n_ticks: int,
                 chunk_ticks: int | None = None,
                 stats: dict | None = None) -> HostWire:
    """Advance the whole host-resident fleet `n_ticks` ticks from tick
    `t0`, one window at a time through the double-buffered pipeline of
    the module docstring (every shard of a mesh at once), each window in
    launches of `chunk_ticks` ticks (default: one launch). Writes `hw`
    in place and returns it.

    `stats`, when given, accumulates the measured split: h2d_s and d2h_s
    (the copies' own time, summed over the shards, by CUDA events on the
    card), compute_s (the launches' time, of the slowest shard), wall_s
    (host clock, synchronised), launches, cohorts, and
    `overlap_efficiency_measured` = compute_s / wall_s (1.0: the copies
    hid entirely behind the launches). Over a mesh also the JAX
    package's `n_devices`, `per_device` (each shard's device, h2d_s,
    compute_s, d2h_s and copy_s), `slowest_device` (the shard with the
    most copy time) and `overlap_efficiency_per_device_measured` (each
    shard's compute_s / max(compute_s, copy_s))."""
    if n_ticks <= 0:
        return hw
    chunk = chunk_ticks or n_ticks
    per = {}
    wall0 = time.perf_counter()
    if any(d.type == "cuda" for d in hw.mesh):
        launches = _stream_card(cfg, hw, t0, n_ticks, chunk, per)
    else:
        launches = _stream_host(cfg, hw, t0, n_ticks, chunk, per)
    wall = time.perf_counter() - wall0
    if stats is not None:
        _fold_stats(stats, hw, per, launches, wall)
    return hw


def stream_ticks_sharded(cfg: RaftConfig, hw: HostWire, t0: int,
                         n_ticks: int, mesh, chunk_ticks: int | None = None,
                         stats: dict | None = None) -> HostWire:
    """`stream_ticks` of a host wire built over `mesh` (`host_wire(...,
    mesh=mesh)`): each window's slices page in, run and drain on every
    device of the mesh at once."""
    if make_mesh(devices=mesh) != hw.mesh:
        raise ValueError(f"the host wire was built over {hw.mesh}, not "
                         f"{tuple(mesh)}")
    return stream_ticks(cfg, hw, t0, n_ticks, chunk_ticks, stats)


def _fold_stats(stats: dict, hw: HostWire, per: dict, launches: int,
                wall: float):
    n = len(hw.mesh)
    rows = stats.setdefault("_per_device_s", {})
    for j, r in per.items():
        acc = rows.setdefault(j, {"h2d_s": 0.0, "compute_s": 0.0,
                                  "d2h_s": 0.0})
        for k in acc:
            acc[k] += r.get(k, 0.0)
    step = {"cohorts": len(hw.parts), "launches": launches,
            "h2d_s": sum(r.get("h2d_s", 0.0) for r in per.values()),
            "compute_s": max(r.get("compute_s", 0.0) for r in per.values()),
            "d2h_s": sum(r.get("d2h_s", 0.0) for r in per.values()),
            "wall_s": wall}
    for key, v in step.items():
        stats[key] = stats.get(key, 0) + v
    stats["overlap_efficiency_measured"] = (
        stats["compute_s"] / stats["wall_s"] if stats["wall_s"] > 0
        else None)
    if n == 1:
        stats.pop("_per_device_s")
        return
    table = [{"device": str(hw.mesh[j]), "shard": j, **r,
              "copy_s": r["h2d_s"] + r["d2h_s"]}
             for j, r in sorted(rows.items())]
    stats.update(
        n_devices=n, per_device=table,
        slowest_device=max(table, key=lambda r: r["copy_s"])["shard"],
        overlap_efficiency_per_device_measured=[
            r["compute_s"] / max(r["compute_s"], r["copy_s"])
            if r["compute_s"] > 0 else None for r in table])


def _stream_host(cfg, hw: HostWire, t0: int, n_ticks: int, chunk: int,
                 per: dict) -> int:
    """The pipeline on the CPU: every window in turn, synchronously,
    through `stream_sched`'s copies, each timed by the host clock."""
    lanes = stream_sched.lanes(hw.mesh)
    launches = 0
    for ci in range(len(hw.parts)):
        with trace.span(f"h2d c{ci}"):
            cur = stream_sched.put_window(hw, ci, lanes, per_device=per)
        for j, (b, d, _) in cur.items():
            s0, s1 = hw.windows[b]
            tic = time.perf_counter()
            with trace.span(f"compute c{ci}" + (
                    "" if len(hw.mesh) == 1 else f":d{j}")):
                (d, hw.accs[j]), n = _launches(cfg, (d, hw.accs[j]), t0,
                                               n_ticks, chunk, ci, s1 - s0,
                                               hw, j)
            launches += n
            stream_sched.tally(per, j, "compute_s",
                               time.perf_counter() - tic)
            cur[j] = (b, d, None)
        with trace.span(f"d2h c{ci}"):
            stream_sched.drain_window(hw, cur, lanes, per_device=per)
    return launches


def _stream_card(cfg, hw: HostWire, t0: int, n_ticks: int, chunk: int,
                 per: dict) -> int:
    """The card's pipeline, every shard's window i queued before any is
    awaited: returns the launches, and fills `per` with each shard's
    h2d, compute and d2h seconds (CUDA events). With a tracer installed
    that keeps device times, each window's h2d copy, launches and d2h
    copy become a span at its device time, on one lane per stream and
    shard."""
    cs = streams.cuda
    n = len(hw.mesh)
    lanes = stream_sched.lanes(hw.mesh)
    pool = stream_sched.StagingPool(hw)
    tracer = trace.get_tracer()
    if tracer is not None and not tracer.device_times:
        tracer = None   # no device times: no lanes placed, no wait
    if tracer is not None:   # the clock that places the streams' events
        ref = {}
        for j, d in enumerate(hw.mesh):
            ref[j] = cs.event()
            cs.record(ref[j], lanes[j].comp)
            cs.event_sync(ref[j])
        ref_us = tracer.now_us()

    spans = {j: {"h2d": [], "compute": [], "d2h": []} for j in range(n)}
    for j, lane in enumerate(lanes):
        # A shard's accumulator comes from `kinit` on its card's current
        # stream; its first launch reads it on the shard's own stream,
        # and the launch's output replaces it.
        if hw.accs[j] is not None and lane.comp != cs.current_stream(
                hw.mesh[j]):
            cs.record_stream(hw.accs[j], lane.comp)
    launches = 0
    nxt = stream_sched.put_window(hw, 0, lanes, pool)
    pending = {}   # shard -> (block, its result, the end of its launches)
    for i in range(len(hw.parts)):
        cur = nxt
        for j, (_, _, ev) in cur.items():
            spans[j]["h2d"].append((i, ev))
        if i + 1 < len(hw.parts):
            nxt = stream_sched.put_window(hw, i + 1, lanes, pool)  # prefetch
        for j, (_, _, ev) in cur.items():
            cs.wait_event(lanes[j].comp, ev[1])
        drained = stream_sched.drain_window(hw, pending, lanes)   # i - 1
        for j, ev in drained.items():
            spans[j]["d2h"].append((i - 1, ev))
        pending = {}
        for j, (b, d, _) in cur.items():
            comp = lanes[j].comp
            c0, c1 = cs.event(), cs.event()
            s0, s1 = hw.windows[b]
            with cs.use(comp):
                cs.record(c0, comp)
                (d, hw.accs[j]), k = _launches(cfg, (d, hw.accs[j]), t0,
                                               n_ticks, chunk, i, s1 - s0,
                                               hw, j)
                cs.record(c1, comp)
            launches += k
            spans[j]["compute"].append((i, (c0, c1)))
            pending[j] = (b, d, c1)
        del cur, d
        for ev in drained.values():
            cs.event_sync(ev[1])
    for j, ev in stream_sched.drain_window(hw, pending, lanes).items():
        spans[j]["d2h"].append((len(hw.parts) - 1, ev))
    del pending
    for d in set(hw.mesh):
        cs.device_sync(d)
    eng = sharded_engine(n)
    for j in range(n):
        for lane, kind in enumerate(("h2d", "compute", "d2h")):
            pairs = spans[j][kind]
            per.setdefault(j, {})[f"{kind}_s"] = sum(
                a.elapsed_time(b) for _, (a, b) in pairs) / 1e3
            if tracer is None:
                continue
            tid = 0x7FFF0000 + 3 * j + lane
            tag = "" if n == 1 else f" d{j}"
            tracer.lane(tid, f"{eng} {kind} stream{tag}")
            for i, (a, b) in pairs:
                tracer.complete(f"{kind} c{i}" + ("" if n == 1 else f":d{j}"),
                                ref_us + 1e3 * ref[j].elapsed_time(a),
                                1e3 * a.elapsed_time(b), tid, cohort=i)
    return launches


def finish(cfg: RaftConfig, hw: HostWire, metrics: Metrics | None = None,
           out_device=None):
    """(State, Metrics, Flight or None) of a host wire: `kernel.kfinish`
    (and `kflight`) of each block on the first device, with the shards'
    accumulators reduced there (`kmesh.reduce_acc`), gathered on
    `out_device` (default: that device). `metrics` is the base folded in
    as `kfinish` folds it; each block refuses a set ring-overflow flag
    or a latched narrow state."""
    out_device = hw.device if out_device is None else torch.device(out_device)
    acc = kmesh.reduce_acc(cfg, [a for a in hw.accs if a is not None],
                           hw.device)
    parts = []
    for (s0, s1), block in zip(hw.windows, hw.blocks):
        leaves = (block.to(hw.device), acc)
        out = kernel.kfinish(cfg, leaves, s1 - s0, metrics) + (
            kernel.kflight(cfg, leaves, s1 - s0),)
        parts.append(tuple(state_mod._map_named(
            tree, "", lambda _, a: a.to(out_device)) for tree in out))
    st = groups.cat_states([p[0] for p in parts], out_device)
    m = parts[0][1]._replace(**{     # the fleet-wide lanes: the same in all
        f: torch.cat([getattr(p[1], f) for p in parts])
        for f in groups.PER_GROUP if getattr(parts[0][1], f) is not None})
    return st, m, groups.cat_flights([p[2] for p in parts], out_device)


def prun_streamed(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0,
                  metrics: Metrics | None = None,
                  flight: Flight | None = None,
                  chunk_ticks: int | None = None,
                  stats: dict | None = None, device="cuda"):
    """Drop-in for `kernel.prun` on a fleet paged through one card: the
    same (State, Metrics[, Flight]), the same bits, returned on the
    device `st` lies on. Refuses a latched narrow state before paging
    and, on a card, a run `kernel.supported` does not fit under
    `stream_groups`: the kernel's shape, one window's pipeline in the
    card's free memory, and the pinned wire (with the input and output
    States when `st` lies on the host) in the host's available memory."""
    state_mod.check_narrow_overflow(cfg, st)
    device = torch.device(device)
    g = st.alive_prev.shape[0]
    ring = 0 if flight is None else flight.tick.shape[0]
    scfg = dataclasses.replace(cfg, stream_groups=True)
    on_host = st.alive_prev.device.type == "cpu"
    if device.type == "cuda" and not kernel.supported(
            scfg, g, ring, state_on_host=on_host):
        shape = ("" if kernel.shape_supported(cfg)
                 else f"{kernel.shape_refusal(cfg)}; ")
        raise ValueError(
            f"cohort: {shape}one window's pipeline needs "
            f"{kernel.cohort_hbm_bytes(cfg, ring)} B of the card's "
            f"{kernel.hbm_budget()} B free, the run's host copies "
            f"(the pinned wire" + (", the input State and the output"
                                   if on_host else "") +
            f") {kernel.host_bytes(cfg, g, ring, on_host)} B of the host's "
            f"{kernel.host_budget()} B available")
    hw = host_wire(cfg, st, metrics, flight, device)
    stream_ticks(cfg, hw, t0, n_ticks, chunk_ticks, stats)
    st2, m2, f2 = finish(cfg, hw, metrics, st.alive_prev.device)
    return (st2, m2) if flight is None else (st2, m2, f2)


def prun_streamed_sharded(cfg: RaftConfig, st: State, n_ticks: int, mesh,
                          t0: int = 0, metrics: Metrics | None = None,
                          flight: Flight | None = None,
                          chunk_ticks: int | None = None,
                          stats: dict | None = None):
    """Drop-in for `kmesh.prun_sharded` on a fleet paged through every
    device of `mesh` at once: the same (State, Metrics[, Flight]), the
    same bits, returned on the device `st` lies on. Refuses a latched
    narrow state and, on cards, a run `kernel.supported` does not fit
    under `stream_groups` over the mesh: on each card the window
    pipelines of every shard it holds, and the host copies in the host's
    available memory."""
    state_mod.check_narrow_overflow(cfg, st)
    mesh = make_mesh(devices=mesh)
    g = st.alive_prev.shape[0]
    ring = 0 if flight is None else flight.tick.shape[0]
    scfg = dataclasses.replace(cfg, stream_groups=True)
    on_host = st.alive_prev.device.type == "cpu"
    if any(d.type == "cuda" for d in mesh) and not kernel.supported(
            scfg, g, ring, state_on_host=on_host, mesh=mesh):
        raise ValueError(
            "cohort: " + ("" if kernel.shape_supported(cfg) else
                          f"{kernel.shape_refusal(cfg)}; ")
            + f"the shards' window pipelines need "
            f"{kernel.mesh_hbm_bytes(scfg, g, mesh, ring)} B by device, the "
            f"host copies {kernel.host_bytes(cfg, g, ring, on_host)} B of "
            f"the host's {kernel.host_budget()} B available")
    hw = host_wire(cfg, st, metrics, flight, mesh=mesh)
    stream_ticks_sharded(cfg, hw, t0, n_ticks, mesh, chunk_ticks, stats)
    st2, m2, f2 = finish(cfg, hw, metrics, st.alive_prev.device)
    return (st2, m2) if flight is None else (st2, m2, f2)
