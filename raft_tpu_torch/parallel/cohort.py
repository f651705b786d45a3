"""Cohort paging on one card: the fleet's wire at rest lives in host
memory, and windows of `cfg.cohort_blocks` 1,024-group blocks stream
through the card under the unchanged kernels (the JAX package's
`raft_tpu/parallel/cohort.py` `host_wire`, `cohort_windows`,
`stream_ticks`, `prun_streamed`).

      host memory  [w0 | w1 | w2 | ...]       one wire at rest per group,
                        |        ^            window-major: one contiguous
                  h2d of i+1     |            [P, window] block per window
                        v   d2h of i-1
      card         [ prev | current | next ]  O(cohort_blocks)
                              |
                    kstep(s) on the current window

While window i's launches run on the current stream, window i+1's
host-to-card copy and window i-1's card-to-host copy run on two copy
streams, ordered with CUDA events (window i-1's copy back is queued
before window i's launches); the host waits for that copy before it
allocates the next window, so the card holds at most
`kernel._stream_windows(cfg)` windows at rest (`kernel.cohort_hbm_bytes`)
whatever the fleet's size, and the group ceiling is the host's
(`kernel.streamed_ceiling_groups`). A window is a column slice of the
[P, G] wire, strided in a [P, G] host tensor, so the host store keeps
each window's block contiguous and every copy is one plain transfer.

Bit-identity is by construction: groups never talk to each other, a
window's launches are the same `kernel.kstep` on the same rows (the
group id rides the wire, so a group's draws are the same wherever it
sits), and the fleet's accumulators (`acc`) are one tensor every window
adds into with integer atomics, exact in any order. `kinit` and
`kfinish` run per window on the card, so the whole fleet's working
wire never exists there either.

Observability (obs/trace.py): every launch of a window carries a chunk
span with the window's index (`cohort`), a heartbeat record follows each
window's last launch (label `cuda-streamed:c<i>`), and, with a tracer
installed, each window's h2d copy, launches and d2h copy are placed on
the timeline at their device times, one lane per stream, so the overlap
shows. A chunk span waits for its launch to end before the host goes on,
so while tracing the card idles while the host queues the next window;
window i+1's prefetch and window i-1's copy back still run beside window
i's launches.

CPU tensors (`device="cpu"`) run the same windows through the plain
versions, synchronously. The multi-card pipeline (the JAX package's
`prun_streamed_sharded`) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.recorder import Flight
from raft_tpu_torch.sim import kernel
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.run import Metrics
from raft_tpu_torch.sim.state import I32, State

# The engine string of a streamed window's launches (its heartbeat label).
ENGINE = "cuda-streamed"

# Metrics lanes with one value per group (the rest are fleet-wide).
_PER_GROUP = ("committed", "leaderless", "safety", "client_acked",
              "client_retries")


@dataclasses.dataclass
class HostWire:
    """The fleet's wire at rest in host memory: `blocks[i]` is window i's
    contiguous int32 [P, s1 - s0] block over groups `windows[i]`, views
    of one host buffer (pinned when the device is a card); `acc` the
    fleet's accumulators on the device."""

    windows: list
    blocks: list
    acc: torch.Tensor
    g: int
    ring: int
    device: torch.device


def cohort_windows(cfg: RaftConfig, g: int, n_devices: int = 1) -> list:
    """[(s0, s1), ...]: the group ranges of the windows, `cohort_blocks`
    blocks of 1,024 groups each, the last taking the remainder. One
    device only: more raise `NotImplementedError`."""
    if n_devices != 1:
        raise NotImplementedError(
            f"raft_tpu_torch streams through one card, not {n_devices}: "
            f"the sharded pipeline (the JAX package's "
            f"stream_ticks_sharded) is not ported; see ROADMAP.md queue 2")
    step = kernel.window_groups(cfg)
    return [(s0, min(s0 + step, g)) for s0 in range(0, g, step)]


def _slice(st: State, metrics: Metrics | None, flight: Flight | None,
           s0: int, s1: int, device):
    """The groups [s0, s1) of a State, Metrics and Flight, on `device`."""
    st = state_mod._map_named(st, "", lambda _, a: a[s0:s1].to(device))
    if metrics is not None:
        metrics = metrics._replace(**{
            f: getattr(metrics, f)[s0:s1].to(device) for f in _PER_GROUP
            if getattr(metrics, f) is not None})
        metrics = state_mod._map_named(metrics, "",
                                       lambda _, a: a.to(device))
    if flight is not None:
        flight = Flight(*(a[:, s0:s1].to(device) for a in flight))
    return st, metrics, flight


def host_wire(cfg: RaftConfig, st: State | None,
              metrics: Metrics | None = None, flight: Flight | None = None,
              device="cuda", n_groups: int | None = None) -> HostWire:
    """The fleet's wire at rest in host memory: `kernel.kinit` of each
    window on `device`, copied into its block. `stream_ticks` writes
    the blocks in place. With `st` None, a fresh fleet of `n_groups`
    groups: each window's State is `state.init` of its groups on
    `device`, so the fleet's State never exists whole."""
    device = torch.device(device)
    g = st.alive_prev.shape[0] if st is not None else n_groups
    ring = 0 if flight is None else flight.tick.shape[0]
    rows = kernel.wire_words_per_group(cfg, ring)
    buf = torch.empty(rows * g, dtype=I32, pin_memory=device.type == "cuda")
    windows, blocks, acc, at = cohort_windows(cfg, g), [], None, 0
    for s0, s1 in windows:
        if st is None:
            part = (state_mod.init(cfg, s1 - s0, device, first_group=s0),
                    None, None if flight is None else
                    Flight(*(a[:, s0:s1].to(device) for a in flight)))
        else:
            part = _slice(st, metrics, flight, s0, s1, device)
        (wire, a), _ = kernel.kinit(cfg, *part)
        block = buf[at:at + rows * (s1 - s0)].view(rows, s1 - s0)
        block.copy_(wire)
        blocks.append(block)
        acc = a if acc is None else acc
        at += rows * (s1 - s0)
    return HostWire(windows, blocks, acc, g, ring, device)


def _launches(cfg, leaves, t0: int, n_ticks: int, chunk: int, ci: int,
              g: int):
    """Window `ci`'s launches (`kernel.krun`, each in a chunk span with
    the window's index): `n_ticks` ticks in chunks of `chunk`, then a
    heartbeat over its `g` groups. Returns (leaves, launches)."""
    leaves = kernel.krun(cfg, leaves, t0, n_ticks, chunk, cohort=ci)
    trace.heartbeat_wire(f"{ENGINE}:c{ci}", t0 + n_ticks, cfg, leaves, g)
    return leaves, -(-n_ticks // chunk)


def stream_ticks(cfg: RaftConfig, hw: HostWire, t0: int, n_ticks: int,
                 chunk_ticks: int | None = None,
                 stats: dict | None = None) -> HostWire:
    """Advance the whole host-resident fleet `n_ticks` ticks from tick
    `t0`, one window at a time through the double-buffered pipeline of
    the module docstring, each window in launches of `chunk_ticks` ticks
    (default: one launch). Writes `hw` in place and returns it.

    `stats`, when given, accumulates the measured split: h2d_s,
    compute_s, d2h_s (the copies' and the launches' own time, by CUDA
    events on the card), wall_s (host clock, synchronised), launches,
    cohorts, and `overlap_efficiency_measured` = compute_s / wall_s
    (1.0: the copies hid entirely behind the launches)."""
    if n_ticks <= 0:
        return hw
    chunk = chunk_ticks or n_ticks
    n_win = len(hw.blocks)
    wall0 = time.perf_counter()
    if hw.device.type == "cuda":
        t_h2d, t_compute, t_d2h, launches = _stream_card(
            cfg, hw, t0, n_ticks, chunk)
    else:
        t_h2d = t_compute = t_d2h = 0.0
        launches = 0
        for ci, (block, (s0, s1)) in enumerate(zip(hw.blocks, hw.windows)):
            tic = time.perf_counter()
            with trace.span(f"h2d c{ci}"):
                cur = block.to(hw.device, copy=True)
            t_h2d += time.perf_counter() - tic
            tic = time.perf_counter()
            with trace.span(f"compute c{ci}"):
                (cur, hw.acc), n = _launches(cfg, (cur, hw.acc), t0,
                                             n_ticks, chunk, ci, s1 - s0)
            launches += n
            t_compute += time.perf_counter() - tic
            tic = time.perf_counter()
            with trace.span(f"d2h c{ci}"):
                block.copy_(cur)
            t_d2h += time.perf_counter() - tic
    wall = time.perf_counter() - wall0
    if stats is not None:
        for key, v in (("cohorts", n_win), ("launches", launches),
                       ("h2d_s", t_h2d), ("compute_s", t_compute),
                       ("d2h_s", t_d2h), ("wall_s", wall)):
            stats[key] = stats.get(key, 0) + v
        stats["overlap_efficiency_measured"] = (
            stats["compute_s"] / stats["wall_s"] if stats["wall_s"] > 0
            else None)
    return hw


def _stream_card(cfg, hw: HostWire, t0: int, n_ticks: int, chunk: int):
    """The card's pipeline: (h2d s, compute s, d2h s, launches). With a
    tracer installed, each window's h2d copy, launches and d2h copy
    become a span at its device time, on one lane per stream."""
    dev = hw.device
    comp = torch.cuda.current_stream(dev)
    up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def event():
        return torch.cuda.Event(enable_timing=True)

    tracer = trace.get_tracer()
    if tracer is not None:   # the clock that places the streams' events
        ref = event()
        ref.record(comp)
        ref.synchronize()
        ref_us = tracer.now_us()

    def h2d(i):
        # Allocated on the compute stream; the copy stream waits for the
        # work already queued there, which may still use the memory.
        d = torch.empty(hw.blocks[i].shape, dtype=I32, device=dev)
        up.wait_stream(comp)
        e0, e1 = event(), event()
        with torch.cuda.stream(up):
            e0.record(up)
            d.copy_(hw.blocks[i], non_blocking=True)
            e1.record(up)
        return d, (e0, e1)

    def d2h(i, out, done):
        down.wait_event(done)
        e0, e1 = event(), event()
        with torch.cuda.stream(down):
            e0.record(down)
            hw.blocks[i].copy_(out, non_blocking=True)
            e1.record(down)
        out.record_stream(down)   # no reuse before the copy is done
        return e0, e1

    spans = {"h2d": [], "compute": [], "d2h": []}
    launches = 0
    nxt = h2d(0)
    pending = None   # (window, its result, the end of its launches)
    for i, (s0, s1) in enumerate(hw.windows):
        cur, (_, loaded) = nxt
        spans["h2d"].append(nxt[1])
        if i + 1 < len(hw.blocks):
            nxt = h2d(i + 1)                       # prefetch i + 1
        comp.wait_event(loaded)
        if pending is not None:
            spans["d2h"].append(d2h(*pending))     # drain i - 1
        c0, c1 = event(), event()
        c0.record(comp)
        (cur, hw.acc), n = _launches(cfg, (cur, hw.acc), t0, n_ticks, chunk,
                                     i, s1 - s0)
        launches += n
        c1.record(comp)
        spans["compute"].append((c0, c1))
        if pending is not None:
            spans["d2h"][-1][1].synchronize()
        pending = (i, cur, c1)
        del cur
    spans["d2h"].append(d2h(*pending))
    del pending
    torch.cuda.synchronize(dev)
    if tracer is not None:
        for lane, kind in enumerate(("h2d", "compute", "d2h")):
            tid = 0x7FFF0000 + lane
            tracer.lane(tid, f"{ENGINE} {kind} stream")
            for i, (a, b) in enumerate(spans[kind]):
                tracer.complete(f"{kind} c{i}",
                                ref_us + 1e3 * ref.elapsed_time(a),
                                1e3 * a.elapsed_time(b), tid, cohort=i)
    secs = [sum(a.elapsed_time(b) for a, b in spans[k]) / 1e3
            for k in ("h2d", "compute", "d2h")]
    return (*secs, launches)


def _cat(trees: list):
    """Concatenate NamedTuple trees leaf by leaf along the group axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_cat([getattr(t, f) for t in trees])
                             for f in first._fields))
    return torch.cat(trees)


def finish(cfg: RaftConfig, hw: HostWire, metrics: Metrics | None = None,
           out_device=None):
    """(State, Metrics, Flight or None) of a host wire: `kernel.kfinish`
    (and `kflight`) of each window on the device, gathered on
    `out_device` (default: the device). `metrics` is the base folded in
    as `kfinish` folds it; each window refuses a set ring-overflow flag
    or a latched narrow state."""
    out_device = hw.device if out_device is None else torch.device(out_device)
    parts = []
    for (s0, s1), block in zip(hw.windows, hw.blocks):
        leaves = (block.to(hw.device), hw.acc)
        out = kernel.kfinish(cfg, leaves, s1 - s0, metrics) + (
            kernel.kflight(cfg, leaves, s1 - s0),)
        parts.append(tuple(state_mod._map_named(
            tree, "", lambda _, a: a.to(out_device)) for tree in out))
    st = _cat([p[0] for p in parts])
    m = parts[0][1]._replace(**{
        f: torch.cat([getattr(p[1], f) for p in parts]) for f in _PER_GROUP
        if getattr(parts[0][1], f) is not None})
    flight = None
    if parts[0][2] is not None:
        flight = Flight(*(torch.cat(rows, dim=1)
                          for rows in zip(*(p[2] for p in parts))))
    return st, m, flight


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
