"""Happens-before hazard prover for the port's streamed pipelines: prove
that `parallel/cohort.py`, `parallel/stream_sched.py` and
`parallel/kmesh.py` order their copies, launches, host waits and frees
across CUDA streams safely, for every (cohort_blocks, devices, windows)
point of a grid, without a card (the JAX package's `verify/hazards.py`,
redesigned for streams).

In JAX the runtime orders copies and launches; in the port the drivers
order them by hand, across a compute stream and two copy streams per
shard, with events, `wait_stream`, `record_stream` and host waits. Those
calls all go through one table, `sim/streams.py` `cuda`. `capture`
replaces the table with a recorder:

- `capture(events)`: fakes on CPU tensors. Streams and events are
  tokens, a copy is a plain CPU copy, a launch records itself and
  returns its inputs. The real `cohort._stream_card`, `_stream_host`
  and `kmesh.kstep_sharded` loops run on this box, byte for byte the
  shipped control flow.
- `capture(events, observe=True)`: the real primitives, each recorded
  and then made. It adds no synchronisation and no copy, so a run on
  the card under it computes the same bits (chip_smoke.py phase (k3)).

Each `Event` names its stream, device, the tensors it touches (by a
serial number per tensor object), and the scheduler's `file:line`: the
innermost frame outside the table, the recorder, `kernel.py` and
`trace.py`. A tensor whose last reference goes records a `free` at the
line that dropped it.

`check_trace` replays a trace with vector clocks: every stream, and the
host, has one; an operation queued on a stream follows everything the
host had seen when it queued it; `record` snapshots a stream's clock
into an event, `wait_event`, `wait_stream` and the host waits
(`event_sync`, `device_sync`) merge clocks. Its rules:

- **upload-before-launch**: a launch must be ordered after the h2d copy
  of its slice;
- **launch-before-drain**: a d2h copy must be ordered after the last
  write (the launches) of the slice it reads;
- **cross-stream-free**: a slice allocated on one stream and used on
  another must be `record_stream`ed for that stream before its last
  reference goes, unless that use is already ordered before the
  allocating stream or the host;
- **pinned-reuse**: a host block written by a d2h must not be read by
  an h2d, nor returned to the caller, until the host has waited for
  that copy's end;
- **shard-join**: the caller's stream, and `kglobal_sharded` and
  `gather` reading the shards, must be ordered after every shard's
  launches (`streams.cuda.join` marks those reads);
- **double-drain**: a slice is copied back once per write;
- **drain-coverage** / **put-coverage**: per pass over the fleet, the
  groups the d2h (h2d) copies move tile [0, G) exactly.

The free rule covers the tensors whose allocation the trace saw (the
window slices, the launches' outputs, the accumulators the harness
places); the accumulators `kernel.kinit` makes before a run predate any
trace.

`prove_schedulers()` runs the real loops over the grid of the JAX
package's prover (cohort_blocks 1-3, devices 1, 2 and 4, windows 1-4;
several devices as cards of their own and as shards of one card), the
card loop and the CPU loop, two passes each, and the sharded launch
loop: it must find zero hazards. `prove_negatives()` runs synthetic
schedulers, each the real loop with one ordering edge removed, written
against the same table in this file: each must be caught by its rule at
a line of this file.

Limits: the proof is over one grid point's program order at a time
(the loops branch on shapes and dials only, which the grid sweeps);
what the kernel does inside a launch, and the allocations inside
`kernel.kstep`, are outside the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import sys
import weakref
from typing import Callable, List, Optional

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import streams
from raft_tpu_torch.sim.state import I32

_THIS_FILE = os.path.abspath(__file__)
HOST = "host"
# Frames in these files are the table or its callers' plumbing, never
# the scheduler statement that issued an operation.
_PLUMBING = ("streams.py", "kernel.py", "trace.py", "contextlib.py",
             "weakref.py")

# ------------------------------------------------------------- the trace


@dataclasses.dataclass(frozen=True)
class Event:
    """One operation of the pipeline, in issue (program) order."""
    kind: str         # stream alloc h2d d2h launch record wait_event
    #                   wait_stream event_sync device_sync record_stream
    #                   free join
    stream: str       # the stream it is queued on; "host" for host work
    device: str
    buffers: tuple    # serial numbers of the tensors it touches
    site: str         # "file.py:NN", the scheduler's line
    peer: object = None     # the other stream, or the event's number
    groups: Optional[tuple] = None   # a copy's [s0, s1) of the fleet
    outs: tuple = ()        # a launch's outputs


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One ordering rule violated, at the scheduler line that issued
    the unsafe operation."""
    rule: str
    site: str
    detail: str

    def __str__(self):
        return f"{self.rule} at {self.site}: {self.detail}"


def _site() -> str:
    """file.py:line of the innermost frame that is not plumbing: the
    scheduler statement that issued the operation being recorded."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        base = os.path.basename(path)
        if base in _PLUMBING or (os.path.abspath(path) == _THIS_FILE
                                 and f.f_code.co_name in _RECORDER_NAMES):
            f = f.f_back
            continue
        return f"{base}:{f.f_lineno}"
    return "<unknown>"


def counts(events: List[Event]) -> dict:
    """The event counts of a trace: h2d, launches, d2h, waits
    (wait_event and wait_stream), record_streams, host syncs."""
    n = {k: 0 for k in ("h2d", "launches", "d2h", "waits",
                        "record_streams", "host_syncs")}
    key = {"h2d": "h2d", "launch": "launches", "d2h": "d2h",
           "wait_event": "waits", "wait_stream": "waits",
           "record_stream": "record_streams", "event_sync": "host_syncs",
           "device_sync": "host_syncs"}
    for ev in events:
        if ev.kind in key:
            n[key[ev.kind]] += 1
    return n


# -------------------------------------------------------------- capture


class _FakeStream:
    """A stream on a device that is not there: a name."""

    def __init__(self, device, name: str):
        self.device = torch.device(device)
        self.name = name

    def __repr__(self):
        return f"<stream {self.name}>"


class _FakeEvent:
    """An event of a fake stream; its elapsed time is 0."""

    def elapsed_time(self, other) -> float:
        return 0.0


class _Recorder(streams.Cuda):
    """The table with every call recorded as an `Event` and then made
    (the real primitives: `observe`)."""

    def __init__(self, events: list, real: streams.Cuda):
        super().__init__()
        self.events = events
        self.real = real
        self._bufs = {}        # id(tensor) -> (weakref, serial)
        self._device = set()   # serials of device tensors
        self._serial = itertools.count()
        self._finalizers = []
        self._keep = []        # events and streams, so ids stay unique
        self._names = {}
        self.active = True

    # -- naming

    def _stream_name(self, s) -> str:
        if s is None:
            return HOST
        if isinstance(s, _FakeStream):
            return s.name
        key = (s.device_index, s.cuda_stream)
        if key not in self._names:
            self._keep.append(s)
            self._names[key] = f"cuda:{s.device_index}/s{len(self._names)}"
        return self._names[key]

    def _event_id(self, e) -> int:
        self._keep.append(e)
        return id(e)

    def _is_device(self, t) -> bool:
        return t.device.type == "cuda"

    def _buf(self, t, device: bool = False) -> int:
        hit = self._bufs.get(id(t))
        if hit is not None and hit[0]() is t:
            return hit[1]
        n = next(self._serial)
        self._bufs[id(t)] = (weakref.ref(t), n)
        if device or self._is_device(t):
            self._device.add(n)
            self._finalizers.append(weakref.finalize(t, self._on_free, n,
                                                     str(self._dev_of(t))))
        return n

    def _dev_of(self, t):
        return t.device

    def _on_free(self, n: int, device: str):
        if self.active:
            self._emit("free", HOST, device, (n,))

    def _emit(self, kind, stream, device, buffers=(), peer=None,
              groups=None, outs=()):
        self.events.append(Event(kind, stream, str(device), tuple(buffers),
                                 _site(), peer,
                                 None if groups is None else tuple(groups),
                                 tuple(outs)))

    def _cur(self, device) -> str:
        device = torch.device(device)
        if device.type != "cuda":
            return HOST
        return self._stream_name(self.current_stream(device))

    def close(self):
        self.active = False
        for f in self._finalizers:
            f.detach()

    # -- the table

    def stream(self, device):
        s = self.real.stream(device)
        self._emit("stream", self._stream_name(s), device)
        return s

    def own_stream(self, device, j: int):
        return self.real.own_stream(device, j)   # the process's streams

    def record(self, event, stream):
        self._emit("record", self._stream_name(stream), stream.device,
                   peer=self._event_id(event))
        self.real.record(event, stream)

    def wait_stream(self, waiter, other):
        self._emit("wait_stream", self._stream_name(waiter), waiter.device,
                   peer=self._stream_name(other))
        self.real.wait_stream(waiter, other)

    def wait_event(self, stream, event):
        self._emit("wait_event", self._stream_name(stream), stream.device,
                   peer=self._event_id(event))
        self.real.wait_event(stream, event)

    def event_sync(self, event):
        self._emit("event_sync", HOST, "cpu", peer=self._event_id(event))
        self.real.event_sync(event)

    def device_sync(self, device):
        self._emit("device_sync", HOST, device, peer=str(device))
        self.real.device_sync(device)

    def empty(self, shape, device):
        t = self.real.empty(shape, device)
        self._emit("alloc", self._cur(device), device,
                   (self._buf(t, True),))
        return t

    def record_stream(self, tensor, stream):
        self._emit("record_stream", self._stream_name(stream),
                   stream.device, (self._buf(tensor),))
        self.real.record_stream(tensor, stream)

    def copy(self, dst, src, groups=None, non_blocking: bool = True):
        bs, bd = self._buf(src), self._buf(dst)
        if bs in self._device:       # a copy back: d2h
            dev = self._dev_of(src)
            self._emit("d2h", self._cur(dev), dev, (bs, bd), groups=groups)
        else:
            dev = self._dev_of(dst)
            self._emit("h2d", self._cur(dev), dev, (bd, bs), groups=groups)
        self._copy(dst, src, groups, non_blocking)

    def _copy(self, dst, src, groups, non_blocking):
        self.real.copy(dst, src, groups, non_blocking)

    def to_device(self, src, device, groups=None):
        t = self.real.to_device(src, device, groups)
        n = self._buf(t, True)
        self._emit("alloc", self._cur(device), device, (n,))
        self._emit("h2d", self._cur(device), device, (n, self._buf(src)),
                   groups=groups)
        return t

    def kstep(self, cfg, leaves, t0: int, n_ticks: int):
        dev = self._dev_of(leaves[0])
        stream = self._cur(dev)
        ins = tuple(self._buf(a) for a in leaves)
        out = self._launch(cfg, leaves, t0, n_ticks)
        self._emit("launch", stream, dev, ins,
                   outs=tuple(self._buf(a, True) for a in out))
        return out

    def _launch(self, cfg, leaves, t0, n_ticks):
        return self.real.kstep(cfg, leaves, t0, n_ticks)

    def join(self, tensors):
        for t in tensors:
            n = self._buf(t)
            if n in self._device:
                dev = self._dev_of(t)
                self._emit("join", self._cur(dev), dev, (n,))
        self.real.join(tensors)


class _Fake(_Recorder):
    """The table with fakes: tokens for streams and events, CPU tensors
    standing for device ones, launches that return their inputs."""

    def __init__(self, events: list, real: streams.Cuda):
        super().__init__(events, real)
        self._on = {}          # serial -> the device it stands on
        self._stack = {}       # device -> the `use` stack
        self._default = {}
        self._n_streams = itertools.count()

    def place(self, t, device):
        """Record `t`, a CPU tensor, as allocated on `device`'s current
        stream (the harness's accumulators and shards)."""
        n = self._buf(t, True)
        self._on[n] = torch.device(device)
        self._emit("alloc", self._cur(device), device, (n,))
        return t

    def _is_device(self, t) -> bool:
        return False

    def _dev_of(self, t):
        hit = self._bufs.get(id(t))
        if hit is not None and hit[0]() is t and hit[1] in self._on:
            return self._on[hit[1]]
        return t.device

    def _new_stream(self, device, tag: str):
        device = torch.device(device)
        return _FakeStream(device, f"{device}/{tag}{next(self._n_streams)}")

    def stream(self, device):
        s = self._new_stream(device, "s")
        self._emit("stream", s.name, device)
        return s

    def own_stream(self, device, j: int):
        key = (torch.device(device), j)
        if key not in self._own:
            self._own[key] = self.stream(device)
        return self._own[key]

    def current_stream(self, device):
        device = torch.device(device)
        stack = self._stack.get(device)
        if stack:
            return stack[-1]
        if device not in self._default:
            self._default[device] = _FakeStream(device, f"{device}/default")
        return self._default[device]

    @contextlib.contextmanager
    def use(self, stream):
        self._stack.setdefault(stream.device, []).append(stream)
        try:
            yield
        finally:
            self._stack[stream.device].pop()

    def event(self):
        return _FakeEvent()

    def record(self, event, stream):
        self._emit("record", stream.name, stream.device,
                   peer=self._event_id(event))

    def wait_stream(self, waiter, other):
        self._emit("wait_stream", waiter.name, waiter.device,
                   peer=other.name)

    def wait_event(self, stream, event):
        self._emit("wait_event", stream.name, stream.device,
                   peer=self._event_id(event))

    def event_sync(self, event):
        self._emit("event_sync", HOST, "cpu", peer=self._event_id(event))

    def device_sync(self, device):
        self._emit("device_sync", HOST, device, peer=str(device))

    def empty(self, shape, device):
        t = torch.empty(shape, dtype=I32)
        n = self._buf(t, True)
        self._on[n] = torch.device(device)
        self._emit("alloc", self._cur(device), device, (n,))
        return t

    def pinned(self, tensor) -> bool:
        return True

    def record_stream(self, tensor, stream):
        self._emit("record_stream", stream.name, stream.device,
                   (self._buf(tensor),))

    def _copy(self, dst, src, groups, non_blocking):
        dst.copy_(src)

    def _launch(self, cfg, leaves, t0, n_ticks):
        return leaves


_RECORDER_NAMES = {n for c in (_Recorder, _Fake) for n in vars(c)}


@contextlib.contextmanager
def capture(events: List[Event], observe: bool = False):
    """Replace the stream table (`sim/streams.py` `cuda`) with a recorder
    for the length of the block; restore it on exit. Every operation
    the drivers issue inside is appended to `events`. With `observe`,
    each primitive is also made, on the card; without it, fakes on CPU
    tensors stand in (yields the recorder, whose `place` marks a CPU
    tensor as a device one)."""
    real = streams.cuda
    rec = (_Recorder if observe else _Fake)(events, real)
    streams.cuda = rec
    try:
        yield rec
    finally:
        streams.cuda = real
        rec.close()


# ----------------------------------------------------------- the prover


def _join(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if out.get(k, 0) < v:
            out[k] = v
    return out


def _after(pos, vc: dict) -> bool:
    """Is the operation at `pos` = (stream, count) ordered before a
    point whose clock is `vc`?"""
    return pos is None or vc.get(pos[0], 0) >= pos[1]


@dataclasses.dataclass
class _Buf:
    alloc: Optional[str] = None   # the stream it was allocated on
    write: Optional[tuple] = None  # (stream, count) of its last write
    write_kind: str = ""
    write_site: str = ""
    drained: bool = False
    uses: dict = dataclasses.field(default_factory=dict)
    recorded: set = dataclasses.field(default_factory=set)
    copied_back: Optional[tuple] = None   # a host block's last d2h
    copied_back_site: str = ""


def check_trace(events: List[Event], g: int, passes: int = 1) -> List[Hazard]:
    """Replay a trace against the ordering rules (module docstring);
    returns the hazards found, empty when the schedule is proven safe.
    `g` is the fleet's groups, `passes` the sweeps over it the trace
    makes (one per `stream_ticks` call)."""
    out: List[Hazard] = []
    vc = {HOST: {}}
    ev_vc = {}
    by_device = {}
    bufs = {}
    ranges = {"h2d": [], "d2h": []}

    def buf(n) -> _Buf:
        return bufs.setdefault(n, _Buf())

    def op(ev) -> tuple:
        s = ev.stream
        by_device.setdefault(ev.device, set()).add(s)
        clock = _join(vc.get(s, {}), vc[HOST]) if s != HOST else vc[HOST]
        clock = dict(clock)
        clock[s] = clock.get(s, 0) + 1
        vc[s] = clock
        return s, clock[s]

    for ev in events:
        k = ev.kind
        if k == "stream":
            vc.setdefault(ev.stream, {})
            by_device.setdefault(ev.device, set()).add(ev.stream)
        elif k == "alloc":
            pos = op(ev)
            b = buf(ev.buffers[0])
            b.alloc = ev.stream
            b.write, b.write_kind, b.drained = None, "", False
        elif k == "record":
            op(ev)
            ev_vc[ev.peer] = dict(vc[ev.stream])
        elif k == "wait_event":
            vc[ev.stream] = _join(vc.get(ev.stream, {}),
                                  ev_vc.get(ev.peer, {}))
            by_device.setdefault(ev.device, set()).add(ev.stream)
        elif k == "wait_stream":
            vc[ev.stream] = _join(vc.get(ev.stream, {}),
                                  vc.get(ev.peer, {}))
            by_device.setdefault(ev.device, set()).add(ev.stream)
        elif k == "event_sync":
            vc[HOST] = _join(vc[HOST], ev_vc.get(ev.peer, {}))
        elif k == "device_sync":
            for s in by_device.get(ev.device, ()):
                vc[HOST] = _join(vc[HOST], vc.get(s, {}))
        elif k == "record_stream":
            buf(ev.buffers[0]).recorded.add(ev.stream)
        elif k == "h2d":
            dst, src = ev.buffers
            host = buf(src)
            if host.copied_back is not None and not _after(
                    host.copied_back, vc[HOST]):
                out.append(Hazard(
                    "pinned-reuse", ev.site,
                    f"groups {ev.groups}: the host block is read by an h2d "
                    f"on {ev.stream} before the host waited for the d2h "
                    f"that wrote it ({host.copied_back_site})"))
            pos = op(ev)
            b = buf(dst)
            b.write, b.write_kind, b.write_site = pos, "h2d", ev.site
            b.drained = False
            b.uses[ev.stream] = pos
            ranges["h2d"].append(ev.groups)
        elif k == "launch":
            clock = _join(vc.get(ev.stream, {}), vc[HOST])
            for n in ev.buffers:
                b = buf(n)
                if b.write_kind == "h2d" and not _after(b.write, clock):
                    out.append(Hazard(
                        "upload-before-launch", ev.site,
                        f"a launch on {ev.stream} reads a slice whose h2d "
                        f"on {b.write[0]} ({b.write_site}) it is not "
                        f"ordered after"))
            pos = op(ev)
            for n in ev.buffers:
                buf(n).uses[ev.stream] = pos
            for n in ev.outs:
                b = buf(n)
                if b.alloc is None and n not in ev.buffers:
                    b.alloc = ev.stream   # a fresh output of the launch
                b.write, b.write_kind, b.write_site = pos, "launch", ev.site
                b.drained = False
                b.uses[ev.stream] = pos
        elif k == "d2h":
            src, dst = ev.buffers
            b = buf(src)
            clock = _join(vc.get(ev.stream, {}), vc[HOST])
            if b.write is not None and not _after(b.write, clock):
                out.append(Hazard(
                    "launch-before-drain", ev.site,
                    f"groups {ev.groups}: a d2h on {ev.stream} is not "
                    f"ordered after the {b.write_kind} on {b.write[0]} "
                    f"({b.write_site}) that wrote the slice"))
            if b.drained:
                out.append(Hazard(
                    "double-drain", ev.site,
                    f"groups {ev.groups}: the slice is copied back twice "
                    f"for one write"))
            pos = op(ev)
            b.drained = True
            b.uses[ev.stream] = pos
            host = buf(dst)
            host.copied_back, host.copied_back_site = pos, ev.site
            ranges["d2h"].append(ev.groups)
        elif k == "free":
            b = bufs.pop(ev.buffers[0], None)
            if b is None or b.alloc is None:
                continue
            ok = _join(vc.get(b.alloc, {}), vc[HOST])
            for s, pos in b.uses.items():
                if s != b.alloc and s not in b.recorded \
                        and not _after(pos, ok):
                    out.append(Hazard(
                        "cross-stream-free", ev.site,
                        f"a slice allocated on {b.alloc} and used on {s} "
                        f"loses its last reference with no record_stream "
                        f"for {s}, and that use is not ordered before "
                        f"{b.alloc} or the host"))
        elif k == "join":
            b = buf(ev.buffers[0])
            clock = _join(vc.get(ev.stream, {}), vc[HOST])
            if b.write_kind == "launch" and b.write[0] != ev.stream \
                    and not _after(b.write, clock):
                out.append(Hazard(
                    "shard-join", ev.site,
                    f"{ev.stream} reads a shard's output before it is "
                    f"ordered after the launch on {b.write[0]} "
                    f"({b.write_site})"))
    for n, b in bufs.items():
        if b.copied_back is not None and not _after(b.copied_back,
                                                    vc[HOST]):
            out.append(Hazard(
                "pinned-reuse", b.copied_back_site,
                "a host block goes back to the caller before the host "
                "waited for the d2h that wrote it"))
    for kind, rule in (("h2d", "put-coverage"), ("d2h", "drain-coverage")):
        problem = _tiling(ranges[kind], g, passes)
        if problem:
            out.append(Hazard(rule, "<whole-trace>",
                              f"{kind} copies: {problem}"))
    return out


def _tiling(ranges: list, g: int, passes: int) -> str:
    """'' when `ranges` cover every group of [0, g) exactly `passes`
    times and no two ranges of a pass overlap; else what is wrong."""
    if any(r is None for r in ranges):
        return "a copy names no groups"
    cover = [0] * (g + 1)
    for s0, s1 in ranges:
        if not 0 <= s0 < s1 <= g:
            return f"range {(s0, s1)} is not inside [0, {g})"
        cover[s0] += 1
        cover[s1] -= 1
    at = 0
    for i in range(g):
        at += cover[i]
        if at != passes:
            return (f"group {i} is covered {at} times, not {passes} "
                    f"(ranges {sorted(ranges)})")
    distinct = set(ranges)
    if any(ranges.count(r) != passes for r in distinct):
        return f"ranges {sorted(ranges)} are not {passes} equal passes"
    return ""


# --------------------------------------------------- the real schedulers


def _fake_wire(cfg: RaftConfig, g: int, mesh, rec: _Fake):
    """A host wire of the shape `cohort.host_wire` builds over `mesh`
    (the same windows, blocks, owners and parts), one row of zeros a
    group: the copies move it, the fake launches leave it. Its
    accumulators are placed on the shards' devices."""
    from raft_tpu_torch.parallel import cohort, stream_sched
    hw = cohort.HostWire([], [], [None] * len(mesh), g, 0, tuple(mesh),
                         [], [])
    for w0, w1 in cohort.cohort_windows(cfg, g, len(mesh)):
        hw.parts.append([])
        for dev, (lo, hi) in stream_sched.device_slices(mesh, w0, w1):
            j = len(hw.parts[-1])
            hw.parts[-1].append(len(hw.blocks))
            hw.blocks.append(torch.zeros((1, hi - lo), dtype=I32))
            hw.windows.append((w0 + lo, w0 + hi))
            hw.owner.append(j)
            if hw.accs[j] is None:
                hw.accs[j] = (rec.place(torch.zeros(4, dtype=I32), dev)
                              if dev.type == "cuda"
                              else torch.zeros(4, dtype=I32))
    return hw


def meshes(n_devices: int) -> dict:
    """placement -> mesh of `n_devices` fake devices: one card, cards
    of their own, shards sharing one card, and CPU shards."""
    cuda = [torch.device("cuda", j) for j in range(n_devices)]
    out = {"cpu": (torch.device("cpu"),) * n_devices}
    if n_devices == 1:
        out["card"] = tuple(cuda)
    else:
        out["cards"] = tuple(cuda)
        out["one-card"] = (cuda[0],) * n_devices
    return out


def run_real(cfg: RaftConfig, g: int, mesh, passes: int = 2,
             n_ticks: int = 2, chunk_ticks: int = 1) -> List[Event]:
    """Run the SHIPPED pipeline (`cohort.stream_ticks`: the card loop
    for card meshes, the CPU loop for CPU ones) `passes` times over a
    fake wire of `g` groups under capture; returns its trace."""
    from raft_tpu_torch.parallel import cohort
    events: List[Event] = []
    with capture(events) as rec:
        hw = _fake_wire(cfg, g, mesh, rec)
        for p in range(passes):
            cohort.stream_ticks(cfg, hw, p * n_ticks, n_ticks, chunk_ticks)
    return events


def run_sharded_launches(mesh, n_chunks: int = 2) -> List[Event]:
    """Run the SHIPPED sharded launch loop (`kmesh.kstep_sharded`)
    `n_chunks` times over fake shards placed on `mesh`."""
    from raft_tpu_torch.parallel import kmesh
    cfg = RaftConfig(seed=0, k=3)
    events: List[Event] = []
    with capture(events) as rec:
        shards = [(rec.place(torch.zeros((1, 8), dtype=I32), d),
                   rec.place(torch.zeros(4, dtype=I32), d)) for d in mesh]
        for c in range(n_chunks):
            shards = kmesh.kstep_sharded(cfg, shards, c, 1, mesh)
        rec.join([a for sh in shards for a in sh])
    return events


def prove_schedulers(max_cohort_blocks: int = 3, max_devices: int = 4,
                     max_windows: int = 4, log: Callable = None) -> dict:
    """The proof over the grid: for every (cohort_blocks, n_devices,
    n_windows, placement), the real card or CPU loop over two passes,
    and for every device count the sharded launch loop. Returns
    {"configs": n, "events": n, "hazards": [str, ...], "counts": {...}}
    — hazards must be empty."""
    from raft_tpu_torch.sim import kernel
    n_cfg = n_ev = 0
    hazards: List[Hazard] = []
    total = dict.fromkeys(counts([]), 0)
    devices = sorted({1, 2, max_devices})
    for cb, nd in itertools.product(range(1, max_cohort_blocks + 1),
                                    devices):
        cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=cb)
        step = kernel.window_groups(cfg, nd)
        for nw in range(1, max_windows + 1):
            # a short tail window from two windows on: the grid reaches
            # the device slices that hold no group
            g = step * nw - (step // 2 + 1 if nw > 1 else 0)
            for label, mesh in meshes(nd).items():
                ev = run_real(cfg, g, mesh)
                found = check_trace(ev, g, passes=2)
                n_cfg += 1
                n_ev += len(ev)
                for k_, v in counts(ev).items():
                    total[k_] += v
                hazards += found
                if log and found:
                    log(f"hazards at cb={cb} nd={nd} nw={nw} {label}: "
                        f"{[str(h) for h in found]}")
    for nd in devices:
        for label, mesh in meshes(nd).items():
            if label == "cpu":
                continue
            ev = run_sharded_launches(mesh)
            found = [h for h in check_trace(ev, 0)
                     if not h.rule.endswith("coverage")]
            n_cfg += 1
            n_ev += len(ev)
            for k_, v in counts(ev).items():
                total[k_] += v
            hazards += found
            if log and found:
                log(f"hazards in kstep_sharded over {label} x{nd}: "
                    f"{[str(h) for h in found]}")
    return {"configs": n_cfg, "events": n_ev, "counts": total,
            "hazards": [str(h) for h in hazards]}


# ------------------------------------------- synthetic negative fixtures
#
# Buggy schedulers written against the SAME table, so the prover's
# detection (and its file:line naming) is itself tested: each mirrors
# `cohort._stream_card` (or `kmesh.kstep_sharded`) with one ordering
# edge removed, and each must be caught, at a line inside this file.


def _synthetic_drain(hw, pending: dict, lanes, drop: str) -> dict:
    """`stream_sched.drain_window`'s card branch, less `drop`'s edge."""
    cs = streams.cuda
    done_events = {}
    for j, (b, cur, done) in pending.items():
        lane = lanes[j]
        if drop != "down_wait":
            cs.wait_event(lane.down, done)
        e1 = cs.event()
        with cs.use(lane.down):
            cs.copy(hw.blocks[b], cur, hw.windows[b])
            cs.record(e1, lane.down)
        if drop != "record_stream":
            cs.record_stream(cur, lane.down)
        done_events[j] = e1
    return done_events


def _synthetic_card(cfg: RaftConfig, hw, drop: str, passes: int = 1):
    """`cohort._stream_card` with its copies inline and without its
    prefetch, less the edge `drop` names: "comp_wait" (the launch does
    not wait for its h2d), "down_wait" (the d2h does not wait for the
    launch), "record_stream" (the slice is not kept from reuse for the
    copy back), "host_sync" (the host never waits for the copies back),
    "double_drain" (a stale pending drained again)."""
    from raft_tpu_torch.parallel import stream_sched
    cs = streams.cuda
    lanes = stream_sched.lanes(hw.mesh)
    for _ in range(passes):
        pending = {}
        for i in range(len(hw.parts)):
            cur = {}
            for b in hw.parts[i]:
                j, lane, src = hw.owner[b], lanes[hw.owner[b]], hw.blocks[b]
                with cs.use(lane.comp):
                    d = cs.empty(src.shape, hw.mesh[j])
                cs.wait_stream(lane.up, lane.comp)
                e1 = cs.event()
                with cs.use(lane.up):
                    cs.copy(d, src, hw.windows[b])
                    cs.record(e1, lane.up)
                cur[j] = (b, d, e1)
            if drop != "comp_wait":
                for j, (_, _, e1) in cur.items():
                    cs.wait_event(lanes[j].comp, e1)
            drained = _synthetic_drain(hw, pending, lanes, drop)
            if drop == "double_drain":
                drained.update(_synthetic_drain(hw, pending, lanes, drop))
            pending = {}
            for j, (b, d, _) in cur.items():
                comp, done = lanes[j].comp, cs.event()
                with cs.use(comp):
                    d, hw.accs[j] = cs.kstep(cfg, (d, hw.accs[j]), 0, 1)
                    cs.record(done, comp)
                pending[j] = (b, d, done)
            del cur, d
            if drop != "host_sync":
                for e in drained.values():
                    cs.event_sync(e)
        _synthetic_drain(hw, pending, lanes, drop)
        pending = {}
        if drop != "host_sync":
            for dev in set(hw.mesh):
                cs.device_sync(dev)


def _synthetic_sharded(cfg: RaftConfig, shards, mesh):
    """`kmesh.kstep_sharded` over shards sharing one card, less the
    caller's stream waiting for the shards' streams."""
    from raft_tpu_torch.parallel import kmesh
    cs = streams.cuda
    out = []
    for j, leaves in enumerate(shards):
        side = kmesh.shard_stream(mesh, j)
        cs.wait_stream(side, cs.current_stream(mesh[j]))
        with cs.use(side):
            res = cs.kstep(cfg, leaves, 0, 1)
        for a in leaves:
            cs.record_stream(a, side)
        out.append(res)
    for j, res in enumerate(out):   # no wait_stream(main, side) first
        cs.join(res)
    return out


NEGATIVES = (("no_comp_wait", "comp_wait", "upload-before-launch"),
             ("no_down_wait", "down_wait", "launch-before-drain"),
             ("no_record_stream", "record_stream", "cross-stream-free"),
             ("no_host_sync", "host_sync", "pinned-reuse"),
             ("double_drain", "double_drain", "double-drain"),
             ("unjoined_shards", None, "shard-join"))


def negative_trace(name: str) -> tuple:
    """(events, groups, passes) of one synthetic negative."""
    drop = dict((n, d) for n, d, _ in NEGATIVES)[name]
    cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=1)
    events: List[Event] = []
    if drop is None:
        mesh = (torch.device("cuda", 0),) * 2
        with capture(events) as rec:
            shards = [(rec.place(torch.zeros((1, 8), dtype=I32), d),
                       rec.place(torch.zeros(4, dtype=I32), d))
                      for d in mesh]
            _synthetic_sharded(cfg, shards, mesh)
        return events, 0, 1
    from raft_tpu_torch.sim import kernel
    g = 2 * kernel.window_groups(cfg)
    passes = 2 if drop == "host_sync" else 1
    with capture(events) as rec:
        hw = _fake_wire(cfg, g, (torch.device("cuda", 0),), rec)
        _synthetic_card(cfg, hw, drop, passes)
    return events, g, passes


def prove_negatives(log: Callable = None) -> dict:
    """Run the synthetic buggy schedulers; each must be CAUGHT by its
    rule. Returns {"caught": n, "missed": [name, ...], "sites": {name:
    site}, "rules": {name: rule}}."""
    missed, sites, rules = [], {}, {}
    for name, _, rule in NEGATIVES:
        events, g, passes = negative_trace(name)
        found = [h for h in check_trace(events, g, passes)
                 if h.rule == rule]
        if not found:
            missed.append(name)
            continue
        sites[name], rules[name] = found[0].site, rule
        if log:
            log(f"negative {name}: {rule} caught at {found[0].site}")
    return {"caught": len(NEGATIVES) - len(missed), "missed": missed,
            "sites": sites, "rules": rules}
