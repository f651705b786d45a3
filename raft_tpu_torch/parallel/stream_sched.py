"""The copy path of the streamed pipeline when each window is split over a
mesh (the JAX package's `raft_tpu/parallel/stream_sched.py`).

`parallel/cohort.py` owns the pipeline's control flow (which window is
resident, when to prefetch, when to drain); this module owns how one
window's bytes cross between the host and the devices:

- `device_slices`: the placement rule. A window of the global step
  (`kernel.window_groups(cfg, n)`) splits into whole per-device block
  slices (`kernel.window_slices`); a device whose slice of the tail
  window holds no real group gets none.
- `StagingPool` + `put_window`: the host-to-device commit point. The
  reference stages each window into reusable contiguous host buffers
  before its per-device `device_put`s. The port's host wire
  (`cohort.HostWire`) is already one pinned buffer in which every
  (window, device) slice is a contiguous block, so a staging copy would
  copy for nothing: the pool is those pinned blocks, and `stage` copies
  nothing. `put_window` copies each device's slice of a window on that
  device's copy stream (`Lane.up`), all of them queued before any is
  awaited.
- `drain_window`: the device-to-host twin, each device's slice on its
  own copy-back stream (`Lane.down`), once that slice's launches are
  done.
- `staging_ablation`: the pinned blocks against a pageable copy of the
  same wire (the reference's naive path, a transfer from pageable
  memory), h2d only.

On the CPU (a mesh of `"cpu"` devices) the copies are synchronous and
timed by the host clock (`per_device`); `cohort`'s CPU pipeline moves
its windows through the same two functions. Every stream, event, copy
and host wait goes through the table of `sim/streams.py`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from raft_tpu_torch.sim import kernel, streams
from raft_tpu_torch.sim.state import I32


def device_slices(mesh, s0: int, s1: int) -> list:
    """[(device, (lo, hi)), ...]: each device's groups of the window
    [s0, s1), relative to the window (add s0 for fleet coordinates), in
    mesh order, whole blocks but for the fleet's tail, none empty."""
    return [(mesh[j], (lo, hi))
            for j, lo, hi in kernel.window_slices(s0, s1, len(mesh))]


def wire_word_problems(blocks) -> list[str]:
    """Blocks of the paged wire that are not int32 words. The narrow
    dials re-declare the resident State only: the wire at rest, which
    the pipeline pages and the byte model budgets, is 4-byte words."""
    return [f"wire block #{i} is {a.dtype}, not int32 words"
            for i, a in enumerate(blocks) if a.dtype != I32]


class Lane(NamedTuple):
    """A shard's streams on its card: its launches, its host-to-device
    copies and its copies back (None on the CPU)."""
    comp: object
    up: object
    down: object


def lanes(mesh) -> list:
    """One Lane per shard of `mesh`: its launches on the shard's stream
    (`kmesh.shard_stream`: the card's current stream for a shard alone
    on its card, else its own, so shards sharing a card overlap), and two
    copy streams of its own."""
    from raft_tpu_torch.parallel.kmesh import shard_stream
    cs = streams.cuda
    return [Lane(shard_stream(mesh, j), cs.stream(d), cs.stream(d))
            if d.type == "cuda" else Lane(None, None, None)
            for j, d in enumerate(mesh)]


class StagingPool:
    """The reference's reusable staging slots, here the host wire's own
    pinned blocks: every (window, device) slice is already a contiguous
    pinned block (module docstring), so `stage` copies nothing."""

    def __init__(self, hw):
        bad = wire_word_problems(hw.blocks)
        if bad:
            raise ValueError("stream_sched: not a wire of int32 words: "
                             + "; ".join(bad))
        if any(d.type == "cuda" for d in hw.mesh) and not all(
                streams.cuda.pinned(b) for b in hw.blocks):
            raise ValueError("stream_sched: the host wire is not pinned")
        self.hw = hw

    def stage(self, i: int) -> list:
        """[(block index, block), ...] of window i, in shard order."""
        return [(b, self.hw.blocks[b]) for b in self.hw.parts[i]]


def tally(per_device, j: int, key: str, secs: float):
    """Add `secs` to shard j's `key` in `per_device` (None: nothing)."""
    if per_device is not None:
        row = per_device.setdefault(j, {})
        row[key] = row.get(key, 0.0) + secs


def put_window(hw, i: int, lanes_, pool: StagingPool | None = None,
               per_device: dict | None = None) -> dict:
    """Window i's host-to-device copies: {shard: (block index, the slice
    on its device, its (start, end) CUDA events or None)}. On a card each
    copy is queued on the shard's `up` stream after the work already on
    its `comp` stream (which may still use the memory the allocator hands
    out), and nothing here waits for it; on the CPU it is done on return.
    From `pool`'s pinned blocks, or, without one, from the host wire's
    own blocks as they are (the naive path when they are pageable).
    `per_device` gathers each shard's host seconds (CPU: the copy)."""
    cs = streams.cuda
    srcs = pool.stage(i) if pool is not None else [
        (b, hw.blocks[b]) for b in hw.parts[i]]
    out = {}
    for b, src in srcs:
        j = hw.owner[b]
        dev, lane = hw.mesh[j], lanes_[j]
        tic = time.perf_counter()
        if lane.comp is None:
            out[j] = (b, cs.to_device(src, dev, hw.windows[b]), None)
        else:
            with cs.use(lane.comp):
                d = cs.empty(src.shape, dev)
            cs.wait_stream(lane.up, lane.comp)
            e0, e1 = cs.event(), cs.event()
            with cs.use(lane.up):
                cs.record(e0, lane.up)
                cs.copy(d, src, hw.windows[b])
                cs.record(e1, lane.up)
            out[j] = (b, d, (e0, e1))
        tally(per_device, j, "h2d_s", time.perf_counter() - tic)
    return out


def drain_window(hw, pending: dict, lanes_,
                 per_device: dict | None = None) -> dict:
    """The copies back of a window's slices, `pending` = {shard: (block
    index, the slice on its device, the event that ends its launches)}:
    {shard: its (start, end) CUDA events or None}. On a card each copy is
    queued on the shard's `down` stream once its launches end, and the
    slice is kept from reuse until the copy is done; on the CPU it is
    done on return. `per_device` gathers each shard's host seconds (CPU:
    the copy)."""
    cs = streams.cuda
    out = {}
    for j, (b, cur, done) in pending.items():
        lane = lanes_[j]
        tic = time.perf_counter()
        if lane.comp is None:
            cs.copy(hw.blocks[b], cur, hw.windows[b], non_blocking=False)
            out[j] = None
        else:
            cs.wait_event(lane.down, done)
            e0, e1 = cs.event(), cs.event()
            with cs.use(lane.down):
                cs.record(e0, lane.down)
                cs.copy(hw.blocks[b], cur, hw.windows[b])
                cs.record(e1, lane.down)
            cs.record_stream(cur, lane.down)
            out[j] = (e0, e1)
        tally(per_device, j, "d2h_s", time.perf_counter() - tic)
    return out


def staging_ablation(cfg, mesh, n_windows: int = 4, repeats: int = 3) -> dict:
    """The h2d copies of `n_windows` full windows (at most 4) over `mesh`,
    from the pinned host wire (the staged path) and from a pageable copy
    of it (the naive path), best wall of `repeats` passes each, every
    pass ended by a synchronise of the mesh's cards. No launch: a
    copy-path probe. Returns wall seconds and MiB/s of each path and
    their ratio (on the CPU both paths are host copies)."""
    from raft_tpu_torch.parallel import cohort
    n = len(mesh)
    scfg = dataclasses.replace(cfg, stream_groups=True)
    g = min(n_windows, 4) * kernel.window_groups(scfg, n)
    hw = cohort.host_wire(scfg, None, mesh=mesh, n_groups=g)
    pageable = dataclasses.replace(hw, blocks=[
        torch.empty(b.shape, dtype=I32).copy_(b) for b in hw.blocks])
    pool = StagingPool(hw)
    lanes_ = lanes(mesh)
    walls = {}
    for label, wire, use in (("staged", hw, pool), ("naive", pageable, None)):
        best = None
        for _ in range(repeats):
            tic = time.perf_counter()
            for i in range(len(wire.parts)):
                put_window(wire, i, lanes_, pool=use)
            for d in set(mesh):
                if d.type == "cuda":
                    streams.cuda.device_sync(d)
            wall = time.perf_counter() - tic
            best = wall if best is None else min(best, wall)
        walls[label] = best
    window_bytes = 4 * sum(hw.blocks[b].numel() for b in hw.parts[0])
    moved = 4 * sum(b.numel() for b in hw.blocks)
    return {
        "n_devices": n, "windows": len(hw.parts),
        "window_bytes": window_bytes,
        "staged_wall_s": walls["staged"], "naive_wall_s": walls["naive"],
        "staged_mib_s": moved / walls["staged"] / 2 ** 20,
        "naive_mib_s": moved / walls["naive"] / 2 ** 20,
        "staged_over_naive": walls["naive"] / walls["staged"],
    }
