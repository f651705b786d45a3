"""The idle card of a benchmark cell's universes, split by the program's
spans.

Runs universes of a `BENCHMARK.json` cell as the benchmark runs them
(`raftbench.spec.cell`, `raftbench.system.System`: `state.init`,
`run.metrics_init`, `recorder.flight_init`, `kernel.prun` or
`kmesh.prun_sharded`, the fetch into pinned host buffers), in blocks of
`--universes`, in turns with and without the program's tracer installed
(`obs.trace.Tracer(device_times=False)`: no CUDA event, no wait), each
turn once under `torch.profiler` and once bare. From the profiler's
Chrome trace, where the tracer's spans are `raft_tpu_torch.<span>`
ranges on the card's clock, it reads:

- the idle card inside each universe, labelled `<phase>/<innermost
  program span>` (phases `init`, `prun`, `fetch`: this script's own
  ranges around the harness's three calls; the phase alone where no
  program span covers the piece), and the unsplit total;
- `init_idle_ms`: the p90 over universes of the card's idle time while
  the host is inside a top-level `state.init`, `run.metrics_init` or
  `recorder.flight_init` span; `boundary_idle_ms`: the same inside the
  top-level `prun` (`kmesh prun`) span;
- `host_launches_per_universe`: the median of the host's launch calls
  (`cudaLaunchKernel*`, `cuLaunchKernel*`, `cudaMemcpyAsync`,
  `cudaMemsetAsync`) inside those spans;
- the host's synchronising runtime calls inside the `init` and `prun`
  phases, with the tracer and without;
- each universe's wall on the host clock, p90 and median, with and
  without the tracer, profiled and bare (the tracer's cost);
- the program spans a universe lacks (`required_spans`).

    python3 scripts/torch_span_split.py --workload raft5.steady --seed N
        [--universes 40] [--rounds 2] [--out FILE]

Prints one JSON object (and writes it to `--out`). Exits 2 without a
card, 1 when a traced universe lacks a span or the tracer changed the
synchronising calls, else 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raft_tpu_torch.obs import trace  # noqa: E402
from raftbench import spec  # noqa: E402
from raftbench.metrics_util import percentile  # noqa: E402
from raftbench.profile import clip, gaps, length, union  # noqa: E402
from raftbench.run import _power_limit  # noqa: E402

PHASE_PREFIX = "split."
UNIVERSE = PHASE_PREFIX + "universe"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")
INIT_SPANS = ("state.init", "run.metrics_init", "recorder.flight_init")
BOUNDARY_SPANS = ("prun", "kmesh prun")
KINDS = ("profiled-off", "profiled-on", "bare-off", "bare-on")


@dataclasses.dataclass
class Trace:
    """A profiler trace's intervals, in microseconds on its clock."""
    universes: list   # [(start, end)]
    phases: list      # [(phase, start, end)]
    spans: list       # [(program span, start, end)], prefix stripped
    busy: dict        # {device: sorted disjoint busy intervals}
    launches: list    # start times of the host's launch calls
    syncs: list       # start times of the host's synchronising calls


def read_trace(obj: dict) -> Trace:
    """The intervals of a Chrome trace (`export_chrome_trace`)."""
    universes, phases, spans, dev = [], [], [], {}
    launches, syncs = [], []
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name, cat = ev.get("name", ""), ev.get("cat", "")
        a = float(ev["ts"])
        b = a + float(ev["dur"])
        if cat == "user_annotation":
            if name == UNIVERSE:
                universes.append((a, b))
            elif name.startswith(PHASE_PREFIX):
                phases.append((name[len(PHASE_PREFIX):], a, b))
            elif name.startswith(trace.RANGE_PREFIX):
                spans.append((name[len(trace.RANGE_PREFIX):], a, b))
        elif cat in DEVICE_CATS:
            d = ev.get("args", {}).get("device")
            if d is not None:
                dev.setdefault(int(d), []).append((a, b))
        elif cat in HOST_CATS:
            if name.startswith(LAUNCH_CALLS):
                launches.append(a)
            elif "Synchronize" in name:
                syncs.append(a)
    return Trace(sorted(universes), sorted(phases, key=lambda p: p[1]),
                 sorted(spans, key=lambda s: s[1]),
                 {d: union(iv) for d, iv in dev.items()},
                 sorted(launches), sorted(syncs))


def _within(span, lo: float, hi: float) -> bool:
    return lo <= (span[1] + span[2]) / 2 <= hi


def _contains(outer, inner) -> bool:
    return outer is not inner and outer[1] <= inner[1] \
        and inner[2] <= outer[2] and (outer[1], outer[2]) != (inner[1],
                                                              inner[2])


def top_level(spans: list) -> list:
    """The program spans no other program span contains."""
    return [s for s in spans if not any(_contains(o, s) for o in spans)]


def innermost(spans: list, t: float):
    """The name of the shortest span holding time `t`, or None."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return None if best is None else best[0]


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


def idle(tr: Trace, device: int, lo: float, hi: float) -> list:
    """The card's idle intervals inside [lo, hi]."""
    return gaps(clip(tr.busy.get(device, []), lo, hi), lo, hi)


def per_universe(tr: Trace, devices: list) -> list:
    """For each universe: its idle card by label (`<phase>/<innermost
    program span>`, or the phase, or "universe"), its unsplit idle
    total, its span's length, the idle inside its top-level init and
    boundary spans, its host launches inside those spans, its
    synchronising calls by phase and the names of its program spans;
    times in microseconds averaged over `devices`."""
    out = []
    n = max(1, len(devices))
    for lo, hi in tr.universes:
        spans = [s for s in tr.spans if _within(s, lo, hi)]
        phases = [p for p in tr.phases if _within(p, lo, hi)]
        top = top_level(spans)
        init = union((a, b) for name, a, b in top if name in INIT_SPANS)
        bound = union((a, b) for name, a, b in top
                      if name in BOUNDARY_SPANS)
        edges = sorted({t for _, a, b in spans + phases for t in (a, b)})
        split, total, init_idle, bound_idle = {}, 0.0, 0.0, 0.0
        for d in devices:
            off = idle(tr, d, lo, hi)
            total += length(off)
            init_idle += length(intersect(off, init))
            bound_idle += length(intersect(off, bound))
            for a, b in off:
                cut = [t for t in edges if a < t < b]
                for x, y in zip([a] + cut, cut + [b]):
                    mid = (x + y) / 2
                    phase = innermost(phases, mid) or "universe"
                    prog = innermost(spans, mid)
                    label = phase if prog is None else f"{phase}/{prog}"
                    split[label] = split.get(label, 0.0) + (y - x) / n
        host = init + bound
        syncs = {}
        for name, a, b in phases:
            syncs[name] = syncs.get(name, 0) + sum(
                1 for t in tr.syncs if a <= t <= b)
        out.append(dict(
            idle=split, idle_total=total / n, wall=hi - lo,
            init_idle=init_idle / n,
            boundary_idle=bound_idle / n,
            launches=sum(1 for t in tr.launches
                         if any(a <= t <= b for a, b in host)),
            syncs=syncs, spans=sorted({s[0] for s in spans})))
    return out


def required_spans(cell, on_card: bool) -> tuple:
    """The program spans every universe of `cell` carries."""
    names = INIT_SPANS + ("kinit", "kinit encode", "kfinish",
                          "kfinish overflow check", "kfinish decode",
                          "kflight")
    if on_card:
        names += ("kstep alloc", "kstep launch")
    window = f"[0,{cell.ticks})"
    if cell.chips == 1:
        engine = "cuda" if on_card else "plain"
        return names + ("prun", f"chunk {engine} {window}")
    engine = ("cuda" if on_card else "plain") + f"-sharded-{cell.chips}dev"
    return names + ("kmesh prun", "kmesh cut", "kmesh kinit",
                    "kmesh gather", "kmesh finish",
                    f"chunk {engine} {window}")


def summarize(rows: list, walls: list) -> dict:
    """One kind's readings over its universes (ms)."""
    idle_ms = {}
    for r in rows:
        for k, v in r["idle"].items():
            idle_ms[k] = idle_ms.get(k, 0.0) + v / 1e3 / len(rows)
    out = {"universes": len(walls),
           "wall_p90_ms": percentile(walls, 90),
           "wall_median_ms": statistics.median(walls)}
    if rows:
        syncs = {}
        for r in rows:
            for k, v in r["syncs"].items():
                syncs[k] = syncs.get(k, 0) + v
        out.update(
            idle_ms_per_universe=dict(sorted(idle_ms.items(),
                                             key=lambda kv: -kv[1])),
            idle_split_sum_ms=sum(idle_ms.values()),
            idle_total_ms=statistics.fmean(r["idle_total"] / 1e3
                                           for r in rows),
            busy_ms_per_universe=statistics.fmean(
                (r["wall"] - r["idle_total"]) / 1e3 for r in rows),
            init_idle_ms=percentile([r["init_idle"] / 1e3 for r in rows],
                                    90),
            boundary_idle_ms=percentile(
                [r["boundary_idle"] / 1e3 for r in rows], 90),
            host_launches_per_universe=statistics.median(
                r["launches"] for r in rows),
            syncs_per_universe={k: v / len(rows) for k, v in syncs.items()})
    return out


@contextlib.contextmanager
def tracing(on: bool):
    """The program's tracer without device times installed (when `on`),
    the previous one restored after."""
    if not on:
        yield
        return
    prev = trace.set_tracer(trace.Tracer(device_times=False))
    try:
        yield
    finally:
        trace.set_tracer(prev)


def _export(prof) -> dict:
    with tempfile.TemporaryDirectory(prefix="span-split-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())


def measure(cell, seed: int, universes: int, rounds: int, devices=None,
            warmup: bool = True) -> dict:
    """The readings of `rounds` turns of the four kinds of block
    (`KINDS`, the order turned around every other round), `universes`
    universes each. `devices` (the CPU tests: `["cpu"] * chips`)
    replaces the cards."""
    from raftbench.system import System
    seeds = spec.universe_seeds(seed)
    sysm = System(cell.raft_fields(seeds[0]), cell.groups, cell.ticks,
                  cell.ring, cell.chips, devices)
    on_card = sysm.device.type == "cuda"
    sysm.build()
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    if on_card:   # CUPTI's first session initialises it: not in a block
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device=sysm.device).add_(1)
            sysm.synchronize()
    count = itertools.count()

    def universe(rf) -> float:
        u = next(count)
        sysm.use_seed(seeds[u % len(seeds)])
        t0 = time.perf_counter()
        with rf(UNIVERSE):
            with rf(PHASE_PREFIX + "init"):
                st, m, f = sysm.init(u * cell.groups)
            with rf(PHASE_PREFIX + "prun"):
                st, m, f = sysm.prun(st, m, f)
            with rf(PHASE_PREFIX + "fetch"):
                sysm.fetch(m, f)
        return (time.perf_counter() - t0) * 1e3

    if warmup:
        for _ in seeds:
            universe(lambda _n: contextlib.nullcontext())
    walls = {k: [] for k in KINDS}
    rows = {k: [] for k in KINDS}
    for r in range(rounds):
        for kind in (KINDS if r % 2 == 0 else KINDS[::-1]):
            profiled = kind.startswith("profiled")
            rf = (torch.profiler.record_function if profiled
                  else lambda _n: contextlib.nullcontext())
            prof = (torch.profiler.profile(activities=acts) if profiled
                    else contextlib.nullcontext())
            with tracing(kind.endswith("-on")), prof:
                walls[kind] += [universe(rf) for _ in range(universes)]
            if profiled:
                rows[kind] += per_universe(read_trace(_export(prof)),
                                           [d.index or 0 for d in sysm.mesh])
    need = required_spans(cell, on_card)
    missing = {i: sorted(set(need) - set(row["spans"]))
               for i, row in enumerate(rows["profiled-on"])}
    out = {"workload": cell.name, "groups": cell.groups,
           "ticks": cell.ticks, "device": (torch.cuda.get_device_name(
               sysm.device) if on_card else "cpu"),
           "rounds": rounds, "required_spans": list(need),
           "missing_spans": {i: m for i, m in missing.items() if m},
           "kinds": {k: summarize(rows[k], walls[k]) for k in KINDS}}
    del sysm
    return out


def faults(out: dict) -> list:
    """What makes a run fail: a traced universe without a required span,
    or synchronising calls that the tracer changed."""
    bad = [f"universe {i} lacks {m}" for i, m in
           out["missing_spans"].items()]
    on = out["kinds"]["profiled-on"].get("syncs_per_universe")
    off = out["kinds"]["profiled-off"].get("syncs_per_universe")
    if on != off:
        bad.append(f"synchronising calls per universe: {on} with the "
                   f"tracer, {off} without")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--universes", type=int, default=40)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s): no result",
              file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.universes, args.rounds)
    out["card"] = _power_limit()   # the card's name and power limit
    bad = faults(out)
    out["faults"] = bad
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
