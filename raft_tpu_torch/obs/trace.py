"""Timeline tracing and the soak heartbeat (the JAX package's
`obs/trace.py`): host spans in Chrome trace-event JSON (open the saved
file in Perfetto, ui.perfetto.dev, or chrome://tracing), and a JSONL
health record every N launches of a long run.

- **Tracer**: complete spans ("ph": "X", ts and dur in microseconds
  since the tracer's epoch), with the JAX package's categories. Each
  span is also a `torch.profiler.record_function` range named
  `raft_tpu_torch.<span name>` (`RANGE_PREFIX`): under a profiler the
  program's spans land in its trace as `user_annotation` events, on the
  clock of the card's kernels and copies. The entry points put a span
  on their whole body (`spanned`): `state.init`, `run.metrics_init`,
  `recorder.flight_init`, and `kernel.prun` with its parts (`kinit`,
  `kinit encode`, `kfinish`, `kfinish overflow check`, `kfinish
  decode`, `kflight`); `kmesh.prun_sharded` likewise (`kmesh prun`,
  `kmesh cut`, `kmesh kinit`, `kmesh gather`, `kmesh finish`). The
  kernel drivers (`sim/kernel.py` `krun`, and so `prun`; the streamed
  windows of `parallel/cohort.py`) put one `chunk_span` on every launch,
  named `chunk cuda [t0,t1)` (`chunk plain [...)` for the plain version
  on the CPU), and the codec wrappers one `launch_span` on each of their
  launches. `kstep` puts a `kstep alloc` span on its output allocation
  and a `kstep launch` span on the launch's enqueue.
- **Device times** (`Tracer(device_times=True)`, the default): a launch
  is asynchronous, so on a card a chunk or launch span records CUDA
  events around it, waits for the second, stores the launch's device
  time in its args as `device_ms` (and the host's time to queue it as
  `enqueue_ms`: a host stall before the launch shows in both; a nested
  span that waits for its own launch, as the codec's do, adds to the
  enclosing one's) and then closes, so the span covers the launch's
  whole run. The streamed pipeline's copies and launches, which overlap
  on three streams, are placed on the timeline at their device times
  (`Tracer.complete`, one lane each). With `device_times=False` the
  tracer records no CUDA event and never waits: a chunk or launch span
  closes when its launch is enqueued, the streamed lanes are not
  placed, and the profiler's trace gives the device side.
- **Heartbeat**: a JSONL record of the counters and health signals
  every `every` launches (and on the first of each label), so a long run
  can be watched while it runs (`tail -f` the file). With a tracer
  installed each beat is a span too (`heartbeat <label>`): the card idles
  while the host reads the lanes, and the timeline shows for how long.
- **Gaps**: inside a `covered(label)` block (`kernel.krun`, a streamed
  window's launches), the host's time between the block's chunk spans
  and heartbeats (queueing the next launch, handling the last one's
  output, the drivers' own Python) is a span of its own, `gap <label>`
  (category `CAT_GAP`), from the end of one to the start of the next
  and at both ends of the block: the block's wall is its chunk spans,
  heartbeats and gaps, end to end, with no untraced time between. Gaps
  are in the tracer's own JSON only, not profiler ranges.

With no tracer (no heartbeat) installed, every hook is a no-op that
costs one attribute read, and nothing synchronises.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import threading
import time

import torch

# Span categories, as in the JAX package.
CAT_PHASE = "phase"      # set-up, warm-up, timed regions; pipeline stages
CAT_CHUNK = "chunk"      # one kernel launch
CAT_SEGMENT = "segment"  # a whole measured run
CAT_GAP = "gap"          # host time between a covered run's spans

# The name prefix of a span's profiler range.
RANGE_PREFIX = "raft_tpu_torch."

_NULL = contextlib.nullcontext()


class Tracer:
    """Collects Chrome trace-event spans. Appends are thread-safe; one
    process is one pid lane, host threads are tid lanes. With
    `device_times` a chunk or launch span on a card waits for its
    launch's end and records its device time; without, it records no
    CUDA event and closes when the launch is enqueued."""

    def __init__(self, device_times: bool = True):
        self.device_times = device_times
        # Read once: a system call, tens of microseconds on some hosts.
        self._pid = os.getpid()
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._run = threading.local()   # this thread's `covered` block
        self.events: list[dict] = []

    def now_us(self) -> float:
        """Microseconds since the tracer's epoch (host clock)."""
        return (time.perf_counter() - self._epoch) * 1e6

    def _append(self, ev: dict):
        with self._lock:
            self.events.append(ev)

    def _complete(self, name: str, cat: str, t0: float, t1: float,
                  args: dict | None = None):
        ev = {"name": name, "cat": cat, "ph": "X", "ts": t0,
              "dur": t1 - t0, "pid": self._pid,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def _span(self, name: str, cat: str, args: dict, covers: bool = False):
        """One complete span. With `covers` (a chunk span or a heartbeat)
        inside a `covered` block, the gap since the block's last such
        span ends where this one starts, and the next starts where this
        one ends."""
        run = self._run
        top = covers and getattr(run, "at", None) is not None \
            and not run.depth
        t0 = self.now_us()
        if top:
            self._complete(f"gap {run.label}", CAT_GAP, run.at, t0)
            run.depth += 1
        try:
            with torch.profiler.record_function(RANGE_PREFIX + name):
                yield args
        finally:
            t1 = self.now_us()
            self._complete(name, cat, t0, t1, args)
            if top:
                run.depth -= 1
                run.at = t1

    @contextlib.contextmanager
    def _covered(self, label: str):
        run = self._run
        if getattr(run, "at", None) is not None:   # an enclosing block
            yield
            return
        run.at, run.label, run.depth = self.now_us(), label, 0
        try:
            yield
        finally:
            self._complete(f"gap {label}", CAT_GAP, run.at, self.now_us())
            run.at = None

    def span(self, name: str, cat: str = CAT_PHASE, **args):
        """Context manager recording one complete span around its body;
        `args` land in the event's "args" (Perfetto's selection panel).
        It yields that dict, which the body may extend."""
        return self._span(name, cat, args)

    @contextlib.contextmanager
    def _launch(self, name: str, device, args: dict, covers: bool = False):
        events = None
        if self.device_times and device is not None \
                and torch.device(device).type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record(stream)
        with self._span(name, CAT_CHUNK, args, covers):
            t0 = self.now_us()
            yield args
            if events is not None:
                args["enqueue_ms"] = (self.now_us() - t0) / 1e3
                events[1].record(stream)
                events[1].synchronize()
                args["device_ms"] = events[0].elapsed_time(events[1])

    def complete(self, name: str, ts_us: float, dur_us: float, tid: int,
                 cat: str = CAT_PHASE, **args):
        """A complete span at a given place on the timeline, on lane
        `tid`: work whose time the card measured (CUDA events placed
        against a reference event)."""
        ev = {"name": name, "cat": cat, "ph": "X", "ts": ts_us,
              "dur": dur_us, "pid": self._pid, "tid": tid}
        if args:
            ev["args"] = args
        self._append(ev)

    def lane(self, tid: int, name: str):
        """Name lane `tid` in the viewer (a "thread_name" metadata event)."""
        self._append({"name": "thread_name", "ph": "M", "ts": 0,
                      "pid": self._pid, "tid": tid,
                      "args": {"name": name}})

    def to_json(self) -> dict:
        """The Chrome trace-event container object."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)
        return path


def validate_trace(obj) -> list[str]:
    """Schema problems of a Chrome trace-event container (empty: valid):
    a "traceEvents" list whose events carry name, ph, ts, pid and tid,
    with a numeric "dur" on every complete ("X") event."""
    problems = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["trace container is not {'traceEvents': [...]}"]
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event #{i} is not an object")
            continue
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"event #{i} ({ev.get('name')!r}) missing "
                                f"required key {k!r}")
        if ev.get("ph") == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            problems.append(f"event #{i} ({ev.get('name')!r}) is a "
                            f"complete span without a numeric 'dur'")
        for k in ("ts", "dur"):
            if k in ev and not isinstance(ev[k], (int, float)):
                problems.append(f"event #{i}: {k} is not numeric")
    return problems


# The process tracer: None = tracing off, every hook a no-op.
_TRACER: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear, with None) the process tracer; returns the
    previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str, cat: str = CAT_PHASE, **args):
    """`Tracer.span` on the installed tracer, or a null context."""
    t = _TRACER
    if t is None:
        return _NULL
    return t._span(name, cat, args)


def spanned(name: str):
    """Decorator: the function's whole body inside `span(name)` when a
    tracer is installed; without one, a plain call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _TRACER
            if t is None:
                return fn(*a, **kw)
            with t._span(name, CAT_PHASE, {}):
                return fn(*a, **kw)
        return wrapper
    return deco


def covered(label: str):
    """A block whose host gaps between its chunk spans and heartbeats are
    traced (`gap <label>` spans, module docstring), or a null context
    with no tracer installed. Inside another block it adds nothing: the
    outer block's gaps cover it."""
    t = _TRACER
    if t is None:
        return _NULL
    return t._covered(label)


def _beat_span(label: str):
    """The span of one heartbeat: a null context without a tracer."""
    t = _TRACER
    if t is None:
        return _NULL
    return t._span(f"heartbeat {label}", CAT_PHASE, {}, covers=True)


def launch_span(name: str, device=None, **args):
    """A `CAT_CHUNK` span around one kernel launch on `device` (on a card,
    under a tracer with device times: with its `device_ms`, closing after
    the launch ends), or a null context with no tracer installed. It
    yields the span's args (None without a tracer)."""
    t = _TRACER
    if t is None:
        return _NULL
    return t._launch(name, device, args)


def chunk_span(engine: str, t0: int, n_ticks: int, device=None, **args):
    """The span of one tick-kernel launch, `chunk {engine} [t0,t1)` with
    `engine`, `t0` and `n_ticks` in its args: one producer for every
    driver, so every lane of a trace names its launches alike."""
    t = _TRACER
    if t is None:
        return _NULL
    return t._launch(f"chunk {engine} [{t0},{t0 + n_ticks})", device,
                     dict(engine=engine, t0=int(t0), n_ticks=int(n_ticks),
                          **args), covers=True)


# ------------------------------------------------------------- heartbeat


class Heartbeat:
    """JSONL health records for long chunked runs.

    `beat(label, tick, metrics, flight)` after a launch of the plain
    path, `beat_wire(label, tick, cfg, leaves, g)` after a kernel launch;
    one record is appended every `every` calls of a label (and always on
    its first). A universe with scheduled reads adds `reads_done_total`,
    one with membership change `membership_changed_groups`
    (`run.feature_counts`; `beat` needs the config and State for them).
    Signals:

    - `election_storm` (with a flight ring): more completed elections in
      the ring's ticks than half the fleet;
    - `leaderless_stall` (with a flight ring): a group leaderless longer
      than the ring;
    - `safety_ok`: no group's per-tick safety bit has dropped.

    A beat reads a few lanes back to the host, so it waits for the
    launches queued before it."""

    def __init__(self, path: str, every: int = 10):
        if every < 1:
            raise ValueError(f"heartbeat every={every} must be >= 1")
        self.path = path
        self.every = every
        self._beats: dict[str, int] = {}

    def _due(self, label: str) -> bool:
        n = self._beats.get(label, 0)
        self._beats[label] = n + 1
        return n % self.every == 0

    def _write(self, rec: dict) -> dict:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def beat(self, label: str, tick_at: int, metrics, flight=None,
             cfg=None, state=None) -> dict | None:
        """Maybe append one record from (Metrics, Flight), and with the
        universe's `cfg` and `state` its feature counts; returns it, or
        None when this call is not due."""
        if not self._due(label):
            return None
        from raft_tpu_torch.sim.run import (total_client_ops,
                                            total_client_retries,
                                            total_rounds, unsafe_groups)
        leaderless = metrics.leaderless.cpu()
        unsafe = unsafe_groups(metrics)
        rec = {
            "label": label,
            "unix_time": round(time.time(), 3),
            "tick": int(tick_at),
            "rounds_total": total_rounds(metrics),
            "elections_total": int(metrics.elections),
            "unsafe_groups": unsafe,
            "safety_ok": unsafe == 0,
            "leaderless_groups": int((leaderless > 0).sum()),
            "max_leaderless_streak": int(leaderless.max())
            if leaderless.numel() else 0,
        }
        if metrics.client_acked is not None:
            rec["client_acked_total"] = total_client_ops(metrics)
            rec["client_retries_total"] = total_client_retries(metrics)
        if flight is not None:
            from raft_tpu_torch.obs.recorder import RING, flight_rows
            rows = flight_rows(flight)
            ring_elections = sum(r["elections"] for r in rows)
            rec.update(
                ring_ticks=len(rows), ring_elections=ring_elections,
                ring_msgs=sum(r["msgs"] for r in rows),
                election_storm=ring_elections > leaderless.shape[0] // 2,
                leaderless_stall=rec["max_leaderless_streak"] > RING)
        if cfg is not None and state is not None and _features_on(cfg):
            from raft_tpu_torch.sim.run import feature_counts
            counts = feature_counts(cfg, state)
            rec.update({k: counts[k] for k in _features_on(cfg)})
        return self._write(rec)

    def beat_wire(self, label: str, tick_at: int, cfg, leaves,
                  g: int) -> dict | None:
        """Maybe append one record read straight off a wire pair between
        launches (`kernel.kcommitted`, `kelections`, `kacked`, `kretries`
        and the wire's leaderless and safety rows). The flight rows are
        not read: `kernel.kflight` is the dump path."""
        if not self._due(label):
            return None
        from raft_tpu_torch.sim import kernel
        leaderless = kernel.klane(cfg, leaves, g, "leaderless")[0]
        unsafe = int((kernel.klane(cfg, leaves, g, "safety")[0] == 0).sum())
        rec = {
            "label": label,
            "engine": "cuda" if leaves[0].device.type == "cuda" else "plain",
            "unix_time": round(time.time(), 3),
            "tick": int(tick_at),
            "rounds_total": kernel.kcommitted(cfg, leaves, g),
            "elections_total": kernel.kelections(cfg, leaves, g),
            "unsafe_groups": unsafe, "safety_ok": unsafe == 0,
            "leaderless_groups": int((leaderless > 0).sum()),
            "max_leaderless_streak": int(leaderless.max()) if g else 0,
        }
        if cfg.clients_u32:
            rec["client_acked_total"] = kernel.kacked(cfg, leaves, g)
            rec["client_retries_total"] = kernel.kretries(cfg, leaves, g)
        on = _features_on(cfg)
        if "reads_done_total" in on:
            rec["reads_done_total"] = kernel.kreads(cfg, leaves, g)
        if "membership_changed_groups" in on:
            rec["membership_changed_groups"] = kernel.kmembership_changed(
                cfg, leaves, g)
        return self._write(rec)


def _features_on(cfg) -> tuple:
    """The feature counts a heartbeat of `cfg`'s universe carries."""
    return (("reads_done_total",) * (cfg.read_every != 0)
            + ("membership_changed_groups",) * (cfg.reconfig_u32 != 0))


# The process heartbeat, as the tracer.
_HEARTBEAT: Heartbeat | None = None


def set_heartbeat(hb: Heartbeat | None) -> Heartbeat | None:
    global _HEARTBEAT
    prev, _HEARTBEAT = _HEARTBEAT, hb
    return prev


def heartbeat(label: str, tick_at: int, metrics, flight=None, cfg=None,
              state=None):
    """`Heartbeat.beat` on the installed heartbeat (no-op without one). A
    failed write is reported and the run goes on."""
    hb = _HEARTBEAT
    if hb is None:
        return None
    try:
        with _beat_span(label):
            return hb.beat(label, tick_at, metrics, flight, cfg, state)
    except OSError as e:
        print(f"[heartbeat] write failed ({e}); continuing",
              file=sys.stderr, flush=True)
        return None


def heartbeat_wire(label: str, tick_at: int, cfg, leaves, g: int):
    """`Heartbeat.beat_wire` on the installed heartbeat (no-op without
    one): what the kernel drivers call after a launch."""
    hb = _HEARTBEAT
    if hb is None:
        return None
    try:
        with _beat_span(label):
            return hb.beat_wire(label, tick_at, cfg, leaves, g)
    except OSError as e:
        print(f"[heartbeat] write failed ({e}); continuing",
              file=sys.stderr, flush=True)
        return None
