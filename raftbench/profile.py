"""The traced run's device timeline: `torch.profiler` (CUPTI) over the
window's universes, read back from its Chrome trace into plain intervals
that the per-layer readers (`metrics/*.py`) take apart.

The benchmark's own spans, `torch.profiler.record_function` ranges from
`run.py`, mark each universe (`raftbench.universe`) and its parts
(`raftbench.init`, `raftbench.prun`, `raftbench.fetch`,
`raftbench.sample`). The port's kernels are told apart from PyTorch's by
name: every `__global__` function of the program's CUDA sources. The
window is the universes' spans: what lies between two universes (the
harness's sample gather) is not the program's, and is left out.

With the program's tracer installed (`System.tracing()`), the program's
own spans are ranges `raft_tpu_torch.<span>` in the same trace: they are
kept apart from the benchmark's (`Timeline.program_spans`), with the
host's launch calls (`Timeline.launches`), and read through
`idle_in_spans` and `launches_in_spans`. No reader of the benchmark's
spans or of the device sees them.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "raftbench."
UNIVERSE = "raftbench.universe"
# The program's spans' range prefix (its `obs.trace.RANGE_PREFIX`).
PROGRAM_PREFIX = "raft_tpu_torch."
HOST_CATS = ("cuda_runtime", "cuda_driver")
# The host's calls that put work on a card's queue.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")
GLOBAL_RE = re.compile(r"__global__(.*?)\(", re.S)
BOUNDS_RE = re.compile(r"__launch_bounds__\s*\([^)]*\)")


def port_kernel_names(csrc: Path) -> tuple:
    """The `__global__` function names of the program's CUDA sources."""
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        text = BOUNDS_RE.sub(" ", src.read_text())
        for head in GLOBAL_RE.findall(text):
            words = re.findall(r"\w+", head)
            if words:
                names.add(words[-1])
    return tuple(sorted(names))


@dataclasses.dataclass
class Timeline:
    """Intervals in microseconds on the profiler's clock."""
    universes: list       # [(start, end)] of each profiled universe
    spans: list           # [(name, start, end)] of the benchmark's spans
    device_events: list   # [(name, device, start, end, port_kernel)]
    devices: list         # the card indices of the run
    # [(name without PROGRAM_PREFIX, start, end)] of the program's spans
    program_spans: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)  # start times


def short_name(name: str) -> str:
    """A device op's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:120]


def read_chrome_trace(obj: dict, port_kernels: tuple,
                      devices: list) -> Timeline:
    words = [re.compile(rf"\b{re.escape(k)}\b") for k in port_kernels]
    universes, spans, dev, program, launches = [], [], [], [], []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        t0 = float(ev["ts"])
        t1 = t0 + float(ev["dur"])
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == UNIVERSE:
                universes.append((t0, t1))
            else:
                spans.append((name, t0, t1))
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            program.append((name[len(PROGRAM_PREFIX):], t0, t1))
        elif cat in HOST_CATS and name.startswith(LAUNCH_CALLS):
            launches.append(t0)
        elif cat in DEVICE_CATS:
            d = ev.get("args", {}).get("device")
            if d is None:
                continue
            port = cat == "kernel" and any(w.search(name) for w in words)
            dev.append((name, int(d), t0, t1, port))
    universes.sort()
    spans.sort(key=lambda s: s[1])
    dev.sort(key=lambda e: e[2])
    program.sort(key=lambda s: s[1])
    return Timeline(universes, spans, dev, list(devices), program,
                    sorted(launches))


def collect(prof, port_kernels: tuple, devices: list) -> Timeline | None:
    """The profiler's events as a Timeline, through its Chrome trace
    (written to a temporary file and removed). None when it holds no
    profiled universe."""
    with tempfile.TemporaryDirectory(prefix="raftbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        obj = json.loads(path.read_text())
    tl = read_chrome_trace(obj, port_kernels, devices)
    return tl if tl.universes else None


def split(tl: Timeline | None, n: int) -> tuple:
    """(`tl` over its first `n` universes, `tl` over the rest or None):
    every reader looks only inside a timeline's universes."""
    if tl is None:
        return None, None
    rest = tl.universes[n:]
    return (dataclasses.replace(tl, universes=tl.universes[:n]),
            dataclasses.replace(tl, universes=rest) if rest else None)


# ------------------------------------------------------- interval algebra


def union(intervals) -> list:
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] outside the sorted disjoint `busy`."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def in_universes(tl: Timeline, intervals: list) -> list:
    """The parts of the sorted disjoint `intervals` that lie inside a
    profiled universe."""
    return [p for a, b in tl.universes for p in clip(intervals, a, b)]


def universe_time(tl: Timeline) -> float:
    """The window's length: the profiled universes' spans, added up."""
    return sum(b - a for a, b in tl.universes)


def busy(tl: Timeline, device: int) -> list:
    """The time inside the universes during which an operation ran on
    `device`."""
    return in_universes(tl, union((e[2], e[3]) for e in tl.device_events
                                  if e[1] == device))


def port_kernel_union(tl: Timeline, lo: float, hi: float,
                      device: int | None = None) -> list:
    """The time in [lo, hi] during which a port kernel ran on `device`
    (on any card when None)."""
    return clip(union((e[2], e[3]) for e in tl.device_events
                      if e[4] and (device is None or e[1] == device)),
                lo, hi)


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device ops that took most time inside the universes (seconds,
    summed over cards and averaged per card) and the longest idle time
    inside them by what the host was doing (the innermost benchmark span
    over each piece of a gap; seconds averaged per card)."""
    n = max(1, len(tl.devices))
    ops = {}
    for name, _, a, b, _ in tl.device_events:
        inside = length(in_universes(tl, [(a, b)]))
        ops[short_name(name)] = ops.get(short_name(name), 0.0) + inside
    edges = sorted({t for _, a, b in tl.spans for t in (a, b)}
                   | {t for a, b in tl.universes for t in (a, b)})
    idle = {}
    for d in tl.devices:
        on = busy(tl, d)
        for lo, hi in tl.universes:
            for a, b in gaps(clip(on, lo, hi), lo, hi):
                # A gap that spans several host phases is split at their
                # edges, each piece labelled by what the host did in it.
                cut = edges[bisect.bisect_right(edges, a):
                            bisect.bisect_left(edges, b)]
                for x, y in zip([a] + cut, cut + [b]):
                    label = host_label(tl, (x + y) / 2)
                    idle[label] = idle.get(label, 0.0) + (y - x)

    def ranked(tab):
        return [[k, v / n / 1e6] for k, v in
                sorted(tab.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def host_label(tl: Timeline, t: float) -> str:
    """The innermost benchmark span holding time `t`."""
    best = None
    for name, a, b in tl.spans:
        if a > t:
            break
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    if best is not None:
        return best[0][len(SPAN_PREFIX):]
    return "universe"


# ------------------------------------------------------ the program's spans


def intersect(xs: list, ys: list) -> list:
    """The intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _contains(outer, inner) -> bool:
    return outer is not inner and outer[1] <= inner[1] \
        and inner[2] <= outer[2] and (outer[1], outer[2]) != (inner[1],
                                                              inner[2])


def top_level(spans: list) -> list:
    """The program spans no other program span contains."""
    return [s for s in spans if not any(_contains(o, s) for o in spans)]


def universe_program_spans(tl: Timeline, lo: float, hi: float) -> list:
    """The program spans of the universe [lo, hi]: those whose middle
    lies inside it."""
    return [s for s in tl.program_spans if lo <= (s[1] + s[2]) / 2 <= hi]


def host_in_spans(tl: Timeline, names, top: bool = True) -> list:
    """For each profiled universe in which the host enters a program span
    named in `names`: (the universe's (start, end), the union of those
    spans as sorted disjoint intervals). With `top`, only the spans that
    lie in no other program span count (`run.metrics_init` inside `prun`
    is the boundary's, not the init's)."""
    out = []
    for lo, hi in tl.universes:
        spans = universe_program_spans(tl, lo, hi)
        if top:
            spans = top_level(spans)
        inside = union((a, b) for name, a, b in spans if name in names)
        if inside:
            out.append(((lo, hi), inside))
    return out


def idle_in_spans(tl: Timeline, names, devices=None,
                  top: bool = True) -> list:
    """For each profiled universe in which the host enters a program span
    named in `names` (`host_in_spans`): the time (us) inside those spans
    during which no operation ran on a card, averaged over `devices`
    (default: the run's cards). A later configuration's reader of the
    idle card under its own spans calls this with their names."""
    devices = tl.devices if devices is None else list(devices)
    on = {d: busy(tl, d) for d in devices}
    out = []
    for (lo, hi), inside in host_in_spans(tl, names, top):
        off = [length(intersect(gaps(clip(on[d], lo, hi), lo, hi), inside))
               for d in devices]
        out.append(sum(off) / max(1, len(devices)))
    return out


def launches_in_spans(tl: Timeline, names, top: bool = True) -> list:
    """For each profiled universe in which the host enters a program span
    named in `names`: the host's launch calls (`LAUNCH_CALLS`) that start
    inside those spans."""
    return [sum(1 for t in tl.launches if any(a <= t <= b for a, b in inside))
            for _, inside in host_in_spans(tl, names, top)]
