"""Benchmark harness of the PyTorch/CUDA port: consensus rounds/sec/chip
(BASELINE.md target: 1M/s), bench.py's segments on one NVIDIA GPU.

    python bench_torch.py [--quick] [--groups N] [--manifest PATH]
        [--trace-dir DIR [--torch-profile] [--heartbeat-every N]]
        [--pack-wire] [--stream [--cohort-blocks N]] [--device cpu]

Prints ONE machine-parsable JSON line as its last line of stdout, with
bench.py's keys (`RENAMES` maps the XLA wall keys to the plain tick's;
`power_limit_w` is added):

    {"metric": "consensus_rounds_per_sec_per_chip", "value": ...,
     "unit": "rounds/s", "vs_baseline": value / 1e6, ...extras}

The engine is the fused-chunk CUDA kernel (`raft_tpu_torch/csrc/
fused_chunk.cu`, through `sim.kernel`): resident on one card, the
groups sharded over every visible card when there is more than one
(`parallel/kmesh.py`), or paged through the card by the cohort
scheduler under `--stream` (`parallel/cohort.py`). The port's plain
PyTorch tick (`obs.recorder.run_recorded`, on the same card) is the
reference only: every segment holds the kernel's full State, full
Metrics (histograms included) and flight ring against it at the same
end tick, and publishes only the kernel's numbers. There is no
fallback: a build or launch error propagates (the trace is saved
first), and a differential mismatch nulls that segment's rates, sets
its engine to "none (cuda mismatch!)", dumps both flight rings, and,
after the JSON line, exits 1. Without a card the bench exits 2; `--device
cpu` runs the plain engine in the kernel's place (engine "plain-cpu"),
for the CPU tests only.

Protocols, as bench.py's:
- steady state (throughput, election rounds, reads): the reference runs
  one warmup chunk and the timed chunks (`_timed_chunks`); the kernel
  runs two warmup launches, each closed by a counter fetch, then the
  timed launches over ticks [2*CHUNK, 2*CHUNK + timed), closed by the
  counter fetch; the reference is extended by one chunk to the
  kernel's end tick and the two universes compared there. The two
  counts are over different windows and are never compared.
- from tick 0 (config-4, config-5, clients, nemesis, every pressure
  rung): the reference runs the universe from tick 0 (the plain tick
  compiles nothing, so it needs no throwaway warmup); the kernel warms
  up on a throwaway universe (two launches), then runs the same
  universe from tick 0, closed by the counter fetch; the end-point
  trees are compared.
Every kernel build the run launches is compiled up front, in parallel
(`kernel.build`), so no segment's warmup wall holds `nvcc`.

Each segment appends one `obs.manifest` record (card name and power
limit, config hash, walls, verdicts, the `obs.roofline` H100 stamp) to
`--manifest` (default ./bench_manifest.jsonl); `scripts/
torch_bench_history.py` trends them. `--trace-dir DIR` writes a Chrome
trace (trace_bench.json: segment, warmup, timed and one chunk span per
launch with its CUDA-event device time) and a heartbeat JSONL (a beat
reads lanes back, so it syncs the card every N chunks: walls include
that cost); `--torch-profile` adds a `torch.profiler` capture per
segment under DIR/torchprof, where the same spans are
`raft_tpu_torch.<span>` ranges on the card's clock.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from raft_tpu_torch.clients.workload import (exactly_once_report,
                                             workload_params)
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import roofline as obs_roofline
from raft_tpu_torch.obs import trace as obs_trace
from raft_tpu_torch.obs.manifest import (NEMESIS_KEYS, PACKING_KEYS,
                                         PRESSURE_KEYS, emit_manifest)
from raft_tpu_torch.obs.recorder import (RING, dump_flight, flight_init,
                                         run_recorded)
from raft_tpu_torch.sim import kernel, state
from raft_tpu_torch.sim.run import (latency_censored, latency_quantile,
                                    metrics_init, total_client_ops,
                                    total_client_retries, total_rounds,
                                    unsafe_groups)
from raft_tpu_torch.utils.trees import trees_equal_why as _trees_equal_why

BASELINE_ROUNDS_PER_SEC = 1_000_000.0
GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]

# bench.py's JSON keys that this bench names after the plain tick: the
# port has no XLA engine. The one table of renames; every other key of
# bench.py's line is kept, and `power_limit_w` is added.
RENAMES = {
    "xla_wall_s": "plain_wall_s",
    "xla_warmup_wall_s": "plain_warmup_wall_s",
    "config4_xla_wall_s": "config4_plain_wall_s",
    "config4_xla_warmup_wall_s": "config4_plain_warmup_wall_s",
    "config5_fault_xla_wall_s": "config5_fault_plain_wall_s",
    "config5_fault_xla_warmup_wall_s": "config5_fault_plain_warmup_wall_s",
}

# The engine string of a segment whose kernel disagreed with the plain
# tick: it does not start with "cuda", so neither `obs.roofline` nor
# `obs.history` takes its record for a kernel point.
MISMATCH_ENGINE = "none (cuda mismatch!)"

# (groups, ticks) of each segment (bench.py:1469-1497); `--groups`
# overrides the throughput and config-5 groups. One table, so a test can
# shrink every shape at once.
SEGMENTS = ("throughput", "config-4", "config-5", "election-rounds",
            "reads", "clients", "nemesis", "pressure")
SHAPES = {
    "full": {"throughput": (100_000, 600),
             "config-4": (50_000, 600),
             "config-5": (100_000, 600),
             # 2,400 ticks so the timed region is seconds (the rate is
             # schedule-bound; see bench_election_rounds).
             "election-rounds": (10_000, 2_400),
             "reads": (50_000, 600),
             "clients": (50_000, 600),
             "nemesis": (50_000, 600),
             # Each of the five rungs is a full run from tick 0.
             "pressure": (20_000, 600)},
    "quick": {name: (1_000, 200) for name in SEGMENTS},
}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


# Filled by main(): the device every segment runs on, the card's name
# and power limit stamped into every manifest record, and the manifest
# file every segment appends to.
_DEVICE = torch.device("cuda")
_CARD: dict = {"device": None, "power_limit_w": None}
_MANIFEST = "bench_manifest.jsonl"


def _on_card() -> bool:
    return _DEVICE.type == "cuda"


def _sync():
    if _on_card():
        torch.cuda.synchronize(_DEVICE)


def _card_fields() -> dict:
    """The card's name ("cuda:<name>", or "cpu") and power limit in watts
    (nvidia-smi; None off the card or without nvidia-smi)."""
    if not _on_card():
        return {"device": "cpu", "power_limit_w": None}
    name = torch.cuda.get_device_name(_DEVICE)
    watts = None
    try:
        line = subprocess.run(GPU_QUERY, check=True, capture_output=True,
                              text=True, timeout=60).stdout.splitlines()[0]
        log(line)
        watts = float(line.split(",")[-1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        log(f"nvidia-smi gave no power limit ({type(e).__name__}: {e})")
    return {"device": f"cuda:{name}", "power_limit_w": watts}


def _kernel_mesh():
    """The kernel's mesh: every visible card when there is more than one,
    else None (the resident one-card path). The plain reference stays on
    the first card either way."""
    if _on_card() and torch.cuda.device_count() > 1:
        from raft_tpu_torch.parallel import mesh
        return mesh.make_mesh()
    return None


@dataclasses.dataclass
class _Engine:
    """The ONE kernel harness both kernel protocols share: `kinit` of a
    State, `run` of chunked launches from a tick, `count` of a
    `kernel.k*` counter straight off the wire, `finish` to (State,
    Metrics, Flight). `name` is load-bearing: the segments decide
    promotion and mesh provenance by comparing engine strings with it."""
    nd: int
    name: str
    kinit: object
    run: object
    count: object
    finish: object


def _kernel_engine(cfg, n_groups: int) -> _Engine:
    """The kernel engine of a segment: sharded over `_kernel_mesh()`
    (`kmesh`, engine `cuda-sharded-{n}dev`), or one card's resident
    `kernel.kstep` (`cuda-fused-chunk`), or off the card the plain tick
    in the kernel's place (`plain-cpu`). Raises when the kernel cannot
    run the shape."""
    mesh = _kernel_mesh()
    if _on_card() and not kernel.supported(cfg, n_groups, RING, mesh=mesh):
        raise ValueError(
            f"the kernel cannot run {n_groups} groups of this segment: "
            + (kernel.shape_refusal(cfg) if not kernel.shape_supported(cfg)
               else f"their launches need more than a card's budget "
                    f"({kernel.hbm_budget(_DEVICE)} B on the first)"))
    if mesh is not None:
        from raft_tpu_torch.parallel import kmesh
        nd = len(mesh)

        def kinit(st):
            return kmesh.kinit_sharded(
                cfg, st, mesh, flight=flight_init(n_groups, device=mesh[0]))

        def run(shards, t0, n_ticks, label, phase):
            at = t0
            while at < t0 + n_ticks:
                step = min(CHUNK, t0 + n_ticks - at)
                with obs_trace.span(f"sharded launch [{at},{at + step})",
                                    phase=phase):
                    shards = kmesh.kstep_sharded(cfg, shards, at, step, mesh)
                at += step
                for j, sh in enumerate(shards):
                    obs_trace.heartbeat_wire(f"{label}:d{j}", at, cfg, sh,
                                             sh[0].shape[1])
            return shards

        def count(name, shards, g):
            return sum(getattr(kernel, name)(cfg, sh, sh[0].shape[1])
                       for sh in shards)

        def finish(shards, g):
            whole = kmesh.gather(cfg, shards, mesh[0])
            st, m = kernel.kfinish(cfg, whole, g)
            return st, m, kernel.kflight(cfg, whole, g)

        return _Engine(nd, kmesh.sharded_engine(nd, mesh[0]), kinit, run,
                       count, finish)

    engine = "cuda" if _on_card() else "plain"

    def kinit(st):
        return kernel.kinit(cfg, st, flight=flight_init(n_groups,
                                                        device=_DEVICE))

    def run(leaves, t0, n_ticks, label, phase):
        # One chunk span and one heartbeat per launch (kernel.krun); the
        # caller rebinds `leaves`, so no launch's output is held.
        return kernel.krun(cfg, leaves, t0, n_ticks, CHUNK, label=label,
                           engine=engine, phase=phase)

    def count(name, leaves, g):
        return getattr(kernel, name)(cfg, leaves, g)

    def finish(leaves, g):
        st, m = kernel.kfinish(cfg, leaves, g)
        return st, m, kernel.kflight(cfg, leaves, g)

    return _Engine(1, "cuda-fused-chunk" if _on_card() else "plain-cpu",
                   kinit, run, count, finish)


def _mesh_fields(n_groups: int, nd: int) -> dict:
    """Provenance for every manifest record: the device-mesh shape the
    segment's kernel ran on. Callers pass the device count as a value
    (the kernel harness knows it)."""
    return {"mesh_shape": [nd], "groups_per_device": -(-n_groups // nd)}


# The canonical wall-clock key set every segment dict (and hence every
# manifest record) carries: bench.py's SEGMENT_WALL_KEYS through
# RENAMES. `timed_wall_s` is the kernel's steady-state wall (the
# published number's); nulls mean "that engine did not run".
SEGMENT_WALL_KEYS = ("timed_wall_s", RENAMES["xla_wall_s"],
                     RENAMES["xla_warmup_wall_s"], "kernel_wall_s",
                     "kernel_warmup_wall_s")


def _wall_fields(timed_wall_s, plain_wall_s=None, plain_warmup_wall_s=None,
                 kernel_wall_s=None, kernel_warmup_wall_s=None) -> dict:
    """The ONE producer of the wall-clock split keys (SEGMENT_WALL_KEYS).
    Rounds to ms precision; None passes through."""
    def r3(v):
        return round(v, 3) if v is not None else None
    return dict(zip(SEGMENT_WALL_KEYS,
                    (r3(timed_wall_s), r3(plain_wall_s),
                     r3(plain_warmup_wall_s), r3(kernel_wall_s),
                     r3(kernel_warmup_wall_s))))


# Filled by main() when --trace-dir is given: the Chrome trace file this
# process will save, stamped into every segment/manifest record.
_TRACE_PATH: str | None = None

# Kernel wire-layout and residency dials applied to every segment config,
# filled by main() from --pack-wire and --stream. The differentials are
# unchanged: a packed or streamed kernel must still equal the plain tick
# on full State + Metrics + flight ring.
_WIRE_DIALS: dict = {}

# Segments whose kernel disagreed with the plain tick (main exits 1).
_MISMATCHES: list = []


def _seg_cfg(**kwargs) -> RaftConfig:
    """A segment's RaftConfig with the run-wide dials applied: the ONE
    place --pack-wire and --stream reach the configs."""
    return RaftConfig(**kwargs, **_WIRE_DIALS)


def _packing_fields(cfg) -> dict:
    """Which wire-layout dials the segment's kernel ran with
    (obs.manifest.PACKING_KEYS)."""
    return {k: getattr(cfg, k) for k in PACKING_KEYS}


def _nemesis_fields(cfg) -> dict:
    """Which nemesis program the segment's universe ran under
    (obs.manifest.NEMESIS_KEYS), checked against the registry it
    fills."""
    from raft_tpu_torch import nemesis
    vals = {"nemesis_program_hash": nemesis.program_hash(cfg.nemesis),
            "nemesis_clauses": nemesis.to_json(cfg.nemesis)}
    if set(vals) != set(NEMESIS_KEYS):
        raise RuntimeError(f"obs.manifest.NEMESIS_KEYS {NEMESIS_KEYS} "
                           f"drifted from the bench producer {set(vals)}")
    return vals


def _stream_fields(cfg, pal=None) -> dict:
    """The residency stamp (obs.manifest.STREAM_KEYS + STREAM_MESH_KEYS):
    the dials, the predicted overlap of the cohort pipeline (whenever the
    config streams) and the measured one from a streamed kernel run's
    pipeline stats (`pal`; None on resident engines)."""
    pal = pal or {}
    return obs_roofline.stream_segment_fields(
        cfg, measured=pal.get("overlap_measured"), chunk_ticks=CHUNK,
        ring=RING,
        n_devices=(pal.get("nd") or 1) if cfg.stream_groups else 1,
        per_device_measured=pal.get("stream_per_device_measured"),
        slowest_device=pal.get("stream_slowest_device"))


def _run_ops(cfg, n_groups: int, end_tick: int, st_end, m_end):
    """The run's hash operations per tick from tick 0 to `end_tick`
    (obs.roofline.run_ops over its own start and end States), or None
    when the run did not end on the kernel."""
    if st_end is None:
        return None
    st0 = state.init(cfg, n_groups, device=st_end.group_id.device)
    return obs_roofline.run_ops(cfg, n_groups, end_tick, st0, st_end,
                                total_rounds(m_end)) / end_tick


def _roofline_fields(cfg, n_groups: int, engine: str, ticks: int,
                     timed_wall_s, nd: int = 1, ops=None) -> dict:
    """The roofline stamp every segment carries: predicted_rounds_per_sec
    / attainment_pct / bound and the whole derivation, against one
    H100's peaks (`obs.roofline`; bytes from the byte model, operations
    from the run's own `ops` per tick). Attainment is measured only for a
    kernel wall on a card."""
    fields = obs_roofline.segment_fields(
        cfg, n_groups, engine, ticks=ticks, timed_wall_s=timed_wall_s,
        chunk_ticks=CHUNK, ring=RING, nd=nd, ops=ops,
        measured=_on_card() and engine.startswith("cuda"))
    fields["trace_path"] = _TRACE_PATH
    return fields


def _differential(label: str, ref, got) -> dict:
    """The gate: the kernel's end-point (State, Metrics, Flight) `got`
    against the plain tick's `ref` at the same tick, on the card (a leaf
    goes to the host only to report its mismatch). On a mismatch the
    leaf is named, both flight rings are dumped and `label` joins
    `_MISMATCHES`. Returns the three `*_identical` verdicts."""
    oks, whys = zip(*(_trees_equal_why(a, b) for a, b in zip(ref, got)))
    verdicts = dict(zip(("state_identical", "metrics_identical",
                         "flight_identical"), oks))
    if all(oks):
        log(f"  [{label}] differential vs plain at the same tick: full "
            f"State + full Metrics + flight ring bit-identical")
        return verdicts
    log(f"  [{label}] DIFFERENTIAL MISMATCH ({verdicts}) - kernel number "
        f"discarded")
    for why in whys:
        if why:
            log(f"  [{label}] {why}")
    dump_flight(ref[2], label=f"{label}:plain-ref")
    dump_flight(got[2], label=f"{label}:cuda")
    _MISMATCHES.append(label)
    return verdicts


def _gate_fields(label: str, pal, m, f, n_groups: int) -> dict:
    """The verdict and mesh fields every steady-state segment shares: the
    per-tick safety verdict of the kernel's run, the differential
    verdicts, and the mesh the kernel ran on."""
    unsafe = _safety_check(label, m, f, n_groups)
    return {
        "state_identical": pal["state_identical"],
        "metrics_identical": pal["metrics_identical"],
        "flight_identical": pal["flight_identical"],
        "safety_ok": unsafe == 0,
        "unsafe_groups": unsafe,
        **_mesh_fields(n_groups, pal["nd"]),
    }


def _safety_check(label: str, m, flight=None, n_groups=None) -> int:
    """Per-tick safety verdict of a finished segment: logs it, dumps the
    flight recorder on a violation, returns the unsafe-group count. A
    violation is reported loudly but does not stop the bench (the JSON
    line and manifests still come out)."""
    unsafe = unsafe_groups(m)
    if unsafe == 0:
        log(f"  [{label}] per-tick safety fold: all groups clean")
    else:
        log(f"  [{label}] SAFETY VIOLATION: {unsafe} group(s) dropped the "
            f"per-tick safety bit")
        if flight is not None:
            dump_flight(flight, n_groups, label=label)
    return unsafe


CHUNK = 200   # ticks per kernel launch (and per plain-tick chunk)


def _timed_chunks(cfg, n_groups: int, ticks: int, counter_fn,
                  warmup_chunks: int = 1, label: str = "plain",
                  chunk: int | None = None):
    """The plain reference of a steady-state segment: `warmup_chunks`
    chunks from tick 0 (the elections), then `ticks // chunk` timed
    chunks, with the flight ring riding both. `counter_fn(st, m) -> int`
    reads a monotone event counter. Returns (rate/s, delta, elapsed_s,
    timed_ticks, warmup_s, st, m, f): the final trees let the caller
    extend the same universe. The plain engine's walls are provenance
    only; the published numbers are the kernel's."""
    chunk = chunk or CHUNK
    st = state.init(cfg, n_groups, device=_DEVICE)
    m = metrics_init(n_groups, device=_DEVICE)
    f = flight_init(n_groups, device=_DEVICE)
    t0 = time.perf_counter()
    tick_at = 0
    with obs_trace.span(f"warmup plain [{label}]",
                        warmup_chunks=warmup_chunks):
        for _ in range(warmup_chunks):
            with obs_trace.chunk_span("plain", tick_at, chunk, _DEVICE,
                                      phase="warmup"):
                st, m, f = run_recorded(cfg, st, chunk, tick_at, m, f)
                tick_at += chunk
        _sync()
    warmup_s = time.perf_counter() - t0
    log(f"  [plain] warmup {tick_at} ticks: {warmup_s:.1f}s")
    base = counter_fn(st, m)
    n_chunks = max(1, ticks // chunk)
    start = time.perf_counter()
    with obs_trace.span(f"timed plain [{label}]", n_chunks=n_chunks):
        for _ in range(n_chunks):
            with obs_trace.chunk_span("plain", tick_at, chunk, _DEVICE,
                                      phase="timed"):
                st, m, f = run_recorded(cfg, st, chunk, tick_at, m, f)
                tick_at += chunk
            obs_trace.heartbeat(label, tick_at, m, f, cfg, st)
        delta = counter_fn(st, m) - base   # the fetch closes the timer
    elapsed = time.perf_counter() - start
    return (delta / elapsed, delta, elapsed, n_chunks * chunk, warmup_s,
            st, m, f)


def _plain_full_run(cfg, n_groups: int, ticks: int, label: str,
                    counter_fn):
    """The plain reference of a from-tick-0 segment: the universe from
    tick 0 in chunks, the flight ring riding, closed by a counter fetch.
    Returns (st, m, f, elapsed_s)."""
    st = state.init(cfg, n_groups, device=_DEVICE)
    m = metrics_init(n_groups, clients=cfg.clients_u32 != 0, device=_DEVICE)
    f = flight_init(n_groups, device=_DEVICE)
    start = time.perf_counter()
    with obs_trace.span(f"timed plain [{label}]"):
        for tick_at in range(0, ticks, CHUNK):
            n = min(CHUNK, ticks - tick_at)
            with obs_trace.chunk_span("plain", tick_at, n, _DEVICE,
                                      phase="timed"):
                st, m, f = run_recorded(cfg, st, n, tick_at, m, f)
            obs_trace.heartbeat(label, tick_at + n, m, f, cfg, st)
        counter_fn(st, m)   # the fetch closes the timer
    elapsed = time.perf_counter() - start
    log(f"  [plain] {label} {n_groups} groups x {ticks} ticks in "
        f"{elapsed:.2f}s ({elapsed / ticks * 1e3:.2f} ms/tick)")
    return st, m, f, elapsed


def _pallas_segment(cfg, n_groups: int, timed_ticks: int, counter_name,
                    st_ref, m_ref, f_ref, what: str):
    """The kernel side of a steady-state segment (bench.py's name; the
    engine is the CUDA kernel): two warmup launches from tick 0, each
    closed by a counter fetch; the timed launches over [2*CHUNK, 2*CHUNK
    + timed_ticks), closed by the counter fetch; then the plain
    reference (at CHUNK + timed_ticks from `_timed_chunks`) extended by
    ONE chunk to the kernel's end tick and the two universes compared
    there (`_differential`). Returns {rate, count, elapsed, warmup_s,
    engine, nd, state_identical, metrics_identical, flight_identical,
    end, overlap_measured}: `end` is the kernel's (State, Metrics,
    Flight) at its end tick; on a mismatch rate, count and elapsed are
    None and the engine is MISMATCH_ENGINE. A build or launch error
    propagates."""
    if cfg.stream_groups:   # the cohort scheduler carries the kernel
        return _streamed_segment(cfg, n_groups, timed_ticks, counter_name,
                                 st_ref, m_ref, f_ref, what)
    eng = _kernel_engine(cfg, n_groups)
    label = f"{eng.name}:{what}"
    leaves, g = eng.kinit(state.init(cfg, n_groups, device=_DEVICE))
    t0 = time.perf_counter()
    with obs_trace.span(f"warmup {eng.name} [{what}]"):
        leaves = eng.run(leaves, 0, CHUNK, label, "warmup")
        eng.count(counter_name, leaves, g)
        leaves = eng.run(leaves, CHUNK, CHUNK, label, "warmup")
        base = eng.count(counter_name, leaves, g)
    warmup_s = time.perf_counter() - t0
    log(f"  [{eng.name}] warmup {2 * CHUNK} ticks (2 launches): "
        f"{warmup_s:.2f}s")
    n_chunks = timed_ticks // CHUNK
    start = time.perf_counter()
    with obs_trace.span(f"timed {eng.name} [{what}]", n_chunks=n_chunks):
        leaves = eng.run(leaves, 2 * CHUNK, n_chunks * CHUNK, label,
                         "timed")
        count = eng.count(counter_name, leaves, g) - base   # closes timer
    elapsed = time.perf_counter() - start
    rate = count / elapsed
    log(f"  [{eng.name}] {n_groups} groups x {timed_ticks} ticks: "
        f"{count} {what} in {elapsed:.3f}s -> {rate:,.0f} {what}/s "
        f"({elapsed / timed_ticks * 1e3:.3f} ms/tick)")
    end = eng.finish(leaves, g)
    del leaves
    with obs_trace.span(f"plain reference extension [{what}]"):
        ref = run_recorded(cfg, st_ref, CHUNK, CHUNK + timed_ticks, m_ref,
                           f_ref)
    verdicts = _differential(what, ref, end)
    out = dict(rate=rate, count=count, elapsed=elapsed, warmup_s=warmup_s,
               engine=eng.name, nd=eng.nd, end=end, overlap_measured=None,
               **verdicts)
    if not all(verdicts.values()):
        out.update(rate=None, count=None, elapsed=None,
                   engine=MISMATCH_ENGINE)
    return out


def _host_count(cfg, hw, counter_name: str) -> int:
    """A `kernel.k*` counter of a host wire (parallel/cohort.py): the
    lane counters summed over its blocks, the election count off the
    shards' accumulators reduced."""
    from raft_tpu_torch.parallel import kmesh
    acc = kmesh.reduce_acc(cfg, [a for a in hw.accs if a is not None],
                           hw.device)
    if counter_name == "kelections":
        return kernel.kelections(cfg, (None, acc), hw.g)
    fn = getattr(kernel, counter_name)
    return sum(fn(cfg, (b, acc), b.shape[1]) for b in hw.blocks)


def _stream_engine(cfg, n_groups: int):
    """(nd, engine string, host wire function, streamer) of the
    cohort scheduler over every visible card (`cuda-streamed-sharded-
    {n}dev`) or one device (`cuda-streamed`). Raises when the run does
    not fit."""
    from raft_tpu_torch.parallel import cohort
    mesh = _kernel_mesh()
    nd = len(mesh) if mesh is not None else 1
    if _on_card() and not kernel.supported(cfg, n_groups, RING, mesh=mesh):
        raise ValueError(
            f"the kernel cannot stream {n_groups} groups of this segment: "
            f"one window's pipeline needs {kernel.cohort_hbm_bytes(cfg, RING)}"
            f" B of the card's {kernel.hbm_budget(_DEVICE)} B budget, the "
            f"host wire {kernel.host_bytes(cfg, n_groups, RING)} B of the "
            f"host's {kernel.host_budget()} B")
    eng = (cohort.sharded_engine(nd) if _on_card()
           else "plain-cpu-streamed")

    def host(st):
        fl = flight_init(n_groups, device=_DEVICE)
        if mesh is not None:
            return cohort.host_wire(cfg, st, flight=fl, mesh=mesh)
        return cohort.host_wire(cfg, st, flight=fl, device=_DEVICE)

    def stream(hw, t0, n, stats=None):
        return cohort.stream_ticks(cfg, hw, t0, n, chunk_ticks=CHUNK,
                                   stats=stats)

    return nd, eng, host, stream


def _stream_stats(stats: dict) -> dict:
    return dict(overlap_measured=stats.get("overlap_efficiency_measured"),
                stream_per_device_measured=stats.get(
                    "overlap_efficiency_per_device_measured"),
                stream_slowest_device=stats.get("slowest_device"))


def _streamed_segment(cfg, n_groups: int, timed_ticks: int, counter_name,
                      st_ref, m_ref, f_ref, what: str):
    """--stream twin of `_pallas_segment`: the cohort scheduler pages the
    fleet host<->card under the unchanged kernel (every visible card
    when there is more than one). Warmup streams the SAME universe
    2*CHUNK ticks, the timed region is one stream pass over the timed
    ticks closed by the counter fetch, and the reference extended to
    the same end tick must equal it. Adds the pipeline's measured
    overlap and per-device split."""
    from raft_tpu_torch.parallel import cohort
    nd, eng, host, stream = _stream_engine(cfg, n_groups)
    hw = host(state.init(cfg, n_groups, device=_DEVICE))
    t0 = time.perf_counter()
    with obs_trace.span(f"warmup streamed [{what}]"):
        stream(hw, 0, 2 * CHUNK)
        base = _host_count(cfg, hw, counter_name)
    warmup_s = time.perf_counter() - t0
    stats: dict = {}
    start = time.perf_counter()
    with obs_trace.span(f"timed streamed [{what}]"):
        stream(hw, 2 * CHUNK, timed_ticks, stats=stats)
        count = _host_count(cfg, hw, counter_name) - base   # closes timer
    elapsed = time.perf_counter() - start
    rate = count / elapsed
    log(f"  [{eng}] {n_groups} groups x {timed_ticks} ticks "
        f"({stats['cohorts']} cohort windows, {stats['launches']} "
        f"launches): {count} {what} in {elapsed:.3f}s -> {rate:,.0f} "
        f"{what}/s (measured overlap "
        f"{stats['overlap_efficiency_measured']:.2f})")
    end = cohort.finish(cfg, hw)
    del hw
    ref = run_recorded(cfg, st_ref, CHUNK, CHUNK + timed_ticks, m_ref,
                       f_ref)
    verdicts = _differential(what, ref, end)
    out = dict(rate=rate, count=count, elapsed=elapsed, warmup_s=warmup_s,
               engine=eng, nd=nd, end=end, **_stream_stats(stats),
               **verdicts)
    if not all(verdicts.values()):
        out.update(rate=None, count=None, elapsed=None,
                   engine=MISMATCH_ENGINE)
    return out


def _pallas_full_run(cfg, n_groups: int, ticks: int, counter_name: str,
                     label: str, st_ref, m_ref, f_ref):
    """The kernel side of a from-tick-0 segment (bench.py's name): a
    throwaway universe takes two warmup launches, each closed by a
    counter fetch; the real universe runs from tick 0 in launches of
    CHUNK ticks, closed by the counter fetch; its end-point trees must
    equal the plain reference's (`_differential`). Returns {engine,
    promoted, k_elapsed, k_warmup_s, state_ok, metrics_ok, flight_ok,
    nd, k_name, end, overlap_measured}; `end` is the kernel's (State,
    Metrics, Flight). A build or launch error propagates."""
    if cfg.stream_groups:   # the cohort scheduler carries the kernel
        return _streamed_full_run(cfg, n_groups, ticks, counter_name,
                                  label, st_ref, m_ref, f_ref)
    eng = _kernel_engine(cfg, n_groups)
    klabel = f"{eng.name}:{label}"
    t0 = time.perf_counter()
    with obs_trace.span(f"warmup {eng.name} [{label}]"):
        wl, wg = eng.kinit(state.init(cfg, n_groups, device=_DEVICE))
        wl = eng.run(wl, 0, CHUNK, klabel, "warmup")
        eng.count(counter_name, wl, wg)
        wl = eng.run(wl, CHUNK, CHUNK, klabel, "warmup")
        eng.count(counter_name, wl, wg)
        del wl
    k_warmup_s = time.perf_counter() - t0
    leaves, g = eng.kinit(state.init(cfg, n_groups, device=_DEVICE))
    start = time.perf_counter()
    with obs_trace.span(f"timed {eng.name} [{label}]"):
        leaves = eng.run(leaves, 0, ticks, klabel, "timed")
        eng.count(counter_name, leaves, g)   # the fetch closes the timer
    k_elapsed = time.perf_counter() - start
    log(f"  [{eng.name}] {label} {n_groups} groups x {ticks} ticks in "
        f"{k_elapsed:.3f}s ({k_elapsed / ticks * 1e3:.3f} ms/tick; warmup "
        f"{k_warmup_s:.2f}s)")
    end = eng.finish(leaves, g)
    del leaves
    v = _differential(label, (st_ref, m_ref, f_ref), end)
    ok = all(v.values())
    return dict(engine=eng.name if ok else MISMATCH_ENGINE, promoted=ok,
                k_elapsed=k_elapsed, k_warmup_s=k_warmup_s,
                state_ok=v["state_identical"],
                metrics_ok=v["metrics_identical"],
                flight_ok=v["flight_identical"], nd=eng.nd,
                k_name=eng.name, end=end, overlap_measured=None)


def _streamed_full_run(cfg, n_groups: int, ticks: int, counter_name: str,
                       label: str, st_ref, m_ref, f_ref):
    """--stream twin of `_pallas_full_run`: a throwaway host wire takes
    one warmup chunk, the real universe streams from tick 0, closed by
    the counter fetch, and its end-point trees must equal the plain
    reference's. Fills the pipeline's measured overlap."""
    from raft_tpu_torch.parallel import cohort
    nd, eng, host, stream = _stream_engine(cfg, n_groups)
    t0 = time.perf_counter()
    with obs_trace.span(f"warmup streamed [{label}]"):
        whw = host(state.init(cfg, n_groups, device=_DEVICE))
        stream(whw, 0, CHUNK)
        _host_count(cfg, whw, counter_name)
        del whw
    k_warmup_s = time.perf_counter() - t0
    hw = host(state.init(cfg, n_groups, device=_DEVICE))
    stats: dict = {}
    start = time.perf_counter()
    with obs_trace.span(f"timed streamed [{label}]"):
        stream(hw, 0, ticks, stats=stats)
        _host_count(cfg, hw, counter_name)   # the fetch closes the timer
    k_elapsed = time.perf_counter() - start
    log(f"  [{eng}] {label} {n_groups} groups x {ticks} ticks "
        f"({stats['cohorts']} cohort windows) in {k_elapsed:.3f}s "
        f"(measured overlap {stats['overlap_efficiency_measured']:.2f})")
    end = cohort.finish(cfg, hw)
    del hw
    v = _differential(label, (st_ref, m_ref, f_ref), end)
    ok = all(v.values())
    return dict(engine=eng if ok else MISMATCH_ENGINE, promoted=ok,
                k_elapsed=k_elapsed, k_warmup_s=k_warmup_s,
                state_ok=v["state_identical"],
                metrics_ok=v["metrics_identical"],
                flight_ok=v["flight_identical"], nd=nd, k_name=eng,
                end=end, **_stream_stats(stats))


# --------------------------------------------------------- segment configs
# bench.py's knobs, one factory each: the segments and the up-front build
# read the same configs.

def throughput_cfg():
    return _seg_cfg(seed=42)


def fault_cfg(seed: int):
    return _seg_cfg(seed=seed, crash_prob=0.3, crash_epoch=64,
                    partition_prob=0.2, partition_epoch=64, drop_prob=0.02)


def election_cfg():
    return _seg_cfg(seed=44, cmds_per_tick=0, crash_prob=0.5,
                    crash_epoch=32)


def reads_cfg():
    return _seg_cfg(seed=45, read_every=4)


def clients_cfg(seed: int):
    return _seg_cfg(seed=seed, sessions=True, cmds_per_tick=0,
                    client_rate=0.2, client_slots=4, client_retry_backoff=8,
                    crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
                    partition_epoch=64, drop_prob=0.02)


def nemesis_cfg(seed: int, ticks: int):
    from raft_tpu_torch import nemesis
    return _seg_cfg(seed=seed, crash_prob=0.1, crash_epoch=64,
                    drop_prob=0.02, nemesis=nemesis.gray_mix(ticks))


def pressure_cfg(seed: int, ticks: int, rate: float = None):
    from raft_tpu_torch import nemesis
    return _seg_cfg(seed=seed, sessions=True, cmds_per_tick=0,
                    client_rate=(PRESSURE_RATES[0] if rate is None
                                 else rate),
                    client_slots=4, client_retry_backoff=8,
                    client_queue_cap=PRESSURE_QUEUE_CAP,
                    nemesis=nemesis.pressure_mix(ticks))


# ----------------------------------------------------------------- segments


def _null_rate(v, digits=1):
    return round(v, digits) if v is not None else None


def bench_throughput(n_groups: int, ticks: int):
    """Config 2/3/5 shape: steady-state replication throughput. The plain
    reference runs under `_timed_chunks`; the kernel's number, measured
    by `_pallas_segment`, is published only when its full State, full
    Metrics and flight ring equal the reference at the kernel's end
    tick."""
    cfg = throughput_cfg()
    (rps, rounds, elapsed, timed_ticks, warmup_s, st_ref, m_ref,
     f_ref) = _timed_chunks(cfg, n_groups, ticks,
                            lambda st, m: total_rounds(m),
                            label="throughput")
    log(f"  [plain] {n_groups} groups x {timed_ticks} ticks: {rounds} rounds "
        f"in {elapsed:.2f}s -> {rps:,.0f} rounds/s (reference only)")
    x_elapsed = elapsed
    pal = _pallas_segment(cfg, n_groups, timed_ticks, "kcommitted",
                          st_ref, m_ref, f_ref, "rounds")
    del st_ref, m_ref, f_ref
    engine, rate = pal["engine"], pal["rate"]
    _, m, f = pal["end"]
    seg = {
        "rounds_per_sec": _null_rate(rate), "rounds": pal["count"],
        "ticks": timed_ticks, "engine": engine,
        "pallas_rounds_per_sec": _null_rate(rate),
        "pallas_ms_per_tick": (round(pal["elapsed"] / timed_ticks * 1e3, 3)
                               if pal["elapsed"] is not None else None),
        **_wall_fields(pal["elapsed"], plain_wall_s=x_elapsed,
                       plain_warmup_wall_s=warmup_s,
                       kernel_wall_s=pal["elapsed"],
                       kernel_warmup_wall_s=pal["warmup_s"]),
        **_gate_fields("throughput", pal, m, f, n_groups),
        **_roofline_fields(cfg, n_groups, engine, timed_ticks,
                           pal["elapsed"], nd=pal["nd"],
                           ops=_run_ops(cfg, n_groups,
                                        2 * CHUNK + timed_ticks,
                                        *pal["end"][:2])),
        **_packing_fields(cfg),
        **_stream_fields(cfg, pal),
    }
    emit_manifest("throughput", cfg, _MANIFEST, **_CARD,
                  n_groups=n_groups, **seg)
    return seg


def _full_run_fields(cfg, n_groups: int, ticks: int, pal, x_elapsed,
                     x_warmup_s=None) -> dict:
    """The verdict, wall, mesh, roofline, packing and stream fields of a
    from-tick-0 segment from its kernel run `pal`."""
    elapsed = pal["k_elapsed"] if pal["promoted"] else None
    return {
        "engine": pal["engine"],
        "state_identical": pal["state_ok"],
        "metrics_identical": pal["metrics_ok"],
        "flight_identical": pal["flight_ok"],
        "n_groups": n_groups, "ticks": ticks,
        **_wall_fields(elapsed, plain_wall_s=x_elapsed,
                       plain_warmup_wall_s=x_warmup_s,
                       kernel_wall_s=pal["k_elapsed"],
                       kernel_warmup_wall_s=pal["k_warmup_s"]),
        **_mesh_fields(n_groups, pal["nd"]),
        **_roofline_fields(cfg, n_groups, pal["engine"], ticks, elapsed,
                           nd=pal["nd"],
                           ops=_run_ops(cfg, n_groups, ticks,
                                        *pal["end"][:2])),
        **_packing_fields(cfg),
        **_stream_fields(cfg, pal),
    }


def bench_fault_latency(seed: int, n_groups: int, ticks: int, label: str):
    """Fault-mix segment (config-4 shape at 50K; the same fault knobs at
    the 100K config-5 shape): randomized leader crashes + partitions +
    drops; the election-latency distribution (ticks from leaderless to
    a new leader) and the committed-round throughput under faults. Both
    engines run the same universe over ticks [0, ticks); the published
    numbers are the kernel's, when its full State, full Metrics
    (histogram included, hence p50/p99) and flight ring equal the plain
    tick's at the end."""
    cfg = fault_cfg(seed)
    st, m, f, x_elapsed = _plain_full_run(
        cfg, n_groups, ticks, label, lambda st, m: int(m.elections))
    pal = _pallas_full_run(cfg, n_groups, ticks, "kelections", label,
                           st, m, f)
    del st, m, f
    _, m, f = pal["end"]
    elapsed = pal["k_elapsed"] if pal["promoted"] else None
    n_elections = int(m.elections)
    rounds = total_rounds(m)
    unsafe = _safety_check(label, m, f, n_groups)
    p50 = latency_quantile(m.hist, 0.5)
    p99 = latency_quantile(m.hist, 0.99)
    censored = latency_censored(m.hist, 0.99)
    max_lat = int(m.max_latency)
    p99_note = (f"tail bounded by the fault schedule, not the protocol:"
                f" partitions hold for partition_epoch="
                f"{cfg.partition_epoch}-tick windows, so a group"
                f" partitioned away from quorum cannot elect until the"
                f" epoch rolls")
    log(f"  {label}: {n_elections} elections, p50={p50} p99={p99} "
        f"max={max_lat} ticks"
        f"{' [p99 CENSORED at histogram top bucket]' if censored else ''}"
        f" ({p99_note}); engine={pal['engine']}")
    seg = {
        "p50": p50, "p99": p99, "censored": censored, "max_lat": max_lat,
        "p99_note": p99_note, "elections": n_elections, "rounds": rounds,
        "rounds_per_sec": rounds / elapsed if elapsed else None,
        "safety_ok": unsafe == 0, "unsafe_groups": unsafe,
        **_full_run_fields(cfg, n_groups, ticks, pal, x_elapsed),
    }
    emit_manifest(label, cfg, _MANIFEST, **_CARD,
                  **{k: v for k, v in seg.items() if k != "p99_note"})
    return seg


def bench_nemesis(seed: int, n_groups: int, ticks: int, label: str):
    """Gray-failure segment: the canonical nemesis program
    (`nemesis.gray_mix`: a slow-but-alive follower and an asymmetric
    flaky link) on light base churn; committed-round throughput and the
    election-latency distribution under fail-SLOW faults. The
    from-tick-0 protocol of bench_fault_latency; the record carries the
    program's hash and clauses (obs.manifest.NEMESIS_KEYS)."""
    from raft_tpu_torch import nemesis
    cfg = nemesis_cfg(seed, ticks)
    log(f"  [{label}] program {nemesis.program_hash(cfg.nemesis)}: "
        f"{nemesis.describe(cfg.nemesis)}")
    st, m, f, x_elapsed = _plain_full_run(
        cfg, n_groups, ticks, label, lambda st, m: int(m.elections))
    pal = _pallas_full_run(cfg, n_groups, ticks, "kelections", label,
                           st, m, f)
    del st, m, f
    _, m, f = pal["end"]
    elapsed = pal["k_elapsed"] if pal["promoted"] else None
    n_elections = int(m.elections)
    rounds = total_rounds(m)
    unsafe = _safety_check(label, m, f, n_groups)
    p50 = latency_quantile(m.hist, 0.5)
    p99 = latency_quantile(m.hist, 0.99)
    censored = latency_censored(m.hist, 0.99)
    log(f"  {label}: {rounds} rounds, {n_elections} elections, p50={p50} "
        f"p99={p99} max={int(m.max_latency)} ticks"
        f"{' [p99 CENSORED at histogram top bucket]' if censored else ''}"
        f"; engine={pal['engine']}")
    seg = {
        "rounds_per_sec": rounds / elapsed if elapsed else None,
        "rounds": rounds, "elections": n_elections,
        "p50": p50, "p99": p99, "censored": censored,
        "max_lat": int(m.max_latency),
        **_nemesis_fields(cfg),
        "safety_ok": unsafe == 0, "unsafe_groups": unsafe,
        **_full_run_fields(cfg, n_groups, ticks, pal, x_elapsed),
    }
    emit_manifest(label, cfg, _MANIFEST, **_CARD, **seg)
    return seg


def bench_election_rounds(n_groups: int, ticks: int):
    """Config 2 shape: pure leader-election rounds (`cmds_per_tick=0`,
    commits stay 0) under constant crash churn, reported as completed
    leader acquisitions per second. Elections complete only when the
    crash schedule deposes a leader (crash_prob=0.5, crash_epoch=32:
    about one election per group per 64 ticks), so the rate is bounded
    by the schedule, not by the protocol; the JSON carries the raw
    election count. The steady-state protocol of bench_throughput."""
    cfg = election_cfg()
    (eps, elections, elapsed, timed_ticks, warmup_s, st_ref, m_ref,
     f_ref) = _timed_chunks(cfg, n_groups, ticks,
                            lambda st, m: int(m.elections),
                            label="election-rounds")
    log(f"  [plain] election rounds {n_groups} groups x {timed_ticks} "
        f"ticks: {elections} elections in {elapsed:.2f}s (reference only)")
    x_elapsed = elapsed
    pal = _pallas_segment(cfg, n_groups, timed_ticks, "kelections",
                          st_ref, m_ref, f_ref, "elections")
    del st_ref, m_ref, f_ref
    _, m, f = pal["end"]
    seg = {
        "elections_per_sec": _null_rate(pal["rate"]),
        "elections": pal["count"], "engine": pal["engine"],
        **_wall_fields(pal["elapsed"], plain_wall_s=x_elapsed,
                       plain_warmup_wall_s=warmup_s,
                       kernel_wall_s=pal["elapsed"],
                       kernel_warmup_wall_s=pal["warmup_s"]),
        **_gate_fields("election-rounds", pal, m, f, n_groups),
        **_roofline_fields(cfg, n_groups, pal["engine"], timed_ticks,
                           pal["elapsed"], nd=pal["nd"],
                           ops=_run_ops(cfg, n_groups,
                                        2 * CHUNK + timed_ticks,
                                        *pal["end"][:2])),
        **_packing_fields(cfg),
        **_stream_fields(cfg, pal),
    }
    emit_manifest("election-rounds", cfg, _MANIFEST, **_CARD,
                  n_groups=n_groups, ticks=timed_ticks, **seg)
    return seg


def bench_reads(n_groups: int, ticks: int):
    """Scheduled linearizable reads at scale: the config-5 replication
    workload with the ReadIndex pipeline on (read_every=4). Completed
    reads are the `reads_done` counters' sum (monotone: no fault
    schedule restarts a node). The steady-state protocol of
    bench_throughput."""
    cfg = reads_cfg()
    (rps, reads, elapsed, timed_ticks, warmup_s, st_ref, m_ref,
     f_ref) = _timed_chunks(
        cfg, n_groups, ticks,
        lambda st, m: int(st.nodes.reads_done.to(torch.int64).sum()),
        label="reads")
    log(f"  [plain] linearizable reads {n_groups} groups x {timed_ticks} "
        f"ticks (read_every={cfg.read_every}): {reads} reads in "
        f"{elapsed:.2f}s (reference only)")
    x_elapsed = elapsed
    pal = _pallas_segment(cfg, n_groups, timed_ticks, "kreads",
                          st_ref, m_ref, f_ref, "reads")
    del st_ref, m_ref, f_ref
    _, m, f = pal["end"]
    seg = {
        "reads_per_sec": _null_rate(pal["rate"]), "reads": pal["count"],
        "engine": pal["engine"],
        **_wall_fields(pal["elapsed"], plain_wall_s=x_elapsed,
                       plain_warmup_wall_s=warmup_s,
                       kernel_wall_s=pal["elapsed"],
                       kernel_warmup_wall_s=pal["warmup_s"]),
        **_gate_fields("reads", pal, m, f, n_groups),
        **_roofline_fields(cfg, n_groups, pal["engine"], timed_ticks,
                           pal["elapsed"], nd=pal["nd"],
                           ops=_run_ops(cfg, n_groups,
                                        2 * CHUNK + timed_ticks,
                                        *pal["end"][:2])),
        **_packing_fields(cfg),
        **_stream_fields(cfg, pal),
    }
    emit_manifest("reads", cfg, _MANIFEST, **_CARD, n_groups=n_groups,
                  ticks=timed_ticks, **seg)
    return seg


def bench_clients(seed: int, n_groups: int, ticks: int, label: str):
    """Client-SLO segment: the config-5 fault mix with open-loop
    exactly-once session traffic in place of the scheduled commands;
    committed-exactly-once ops/s and the ack-latency distribution
    (submit -> durable-apply witness, in ticks) under leader crashes
    that force ambiguous-failure retries. The from-tick-0 protocol; the
    gate spans the session-table and client-state leaves and the client
    lanes. The exactly-once verdict needs both the per-tick safety fold
    and the endpoint accounting report clean."""
    cfg = clients_cfg(seed)
    st, m, f, x_elapsed = _plain_full_run(
        cfg, n_groups, ticks, label, lambda st, m: total_client_ops(m))
    pal = _pallas_full_run(cfg, n_groups, ticks, "kacked", label,
                           st, m, f)
    del st, m, f
    st, m, f = pal["end"]
    elapsed = pal["k_elapsed"] if pal["promoted"] else None
    acked = total_client_ops(m)
    retries = total_client_retries(m)
    unsafe = _safety_check(label, m, f, n_groups)
    eo_ok, eo_why = exactly_once_report(cfg, st, m)
    exactly_once = eo_ok and unsafe == 0
    log(f"  [{label}] exactly-once verdict: "
        f"{'PROVEN clean' if exactly_once else 'VIOLATED'} — {eo_why}; "
        f"{retries} duplicate-risk retries under the fault mix")
    p50 = latency_quantile(m.client_hist, 0.5)
    p99 = latency_quantile(m.client_hist, 0.99)
    censored = latency_censored(m.client_hist, 0.99)
    log(f"  {label}: {acked} acked ops, ack latency p50={p50} p99={p99} "
        f"max={int(m.client_max_lat)} ticks"
        f"{' [p99 CENSORED at histogram top bucket]' if censored else ''}"
        f"; engine={pal['engine']}")
    seg = {
        "client_ops_per_sec": (round(acked / elapsed, 1) if elapsed
                               else None),
        "acked_ops": acked, "retries": retries,
        "ack_p50_ticks": p50, "ack_p99_ticks": p99,
        "ack_p99_censored": censored,
        "ack_max_ticks": int(m.client_max_lat),
        "exactly_once_ok": exactly_once,
        "safety_ok": unsafe == 0, "unsafe_groups": unsafe,
        "workload": workload_params(cfg),
        **_full_run_fields(cfg, n_groups, ticks, pal, x_elapsed),
    }
    emit_manifest(label, cfg, _MANIFEST, **_CARD, **seg)
    return seg


# Knee protocol (bench.py:1191-1208): each load point is graded against a
# two-part SLO, p99 ack latency within six retry-backoff windows and at
# most 5% of offered arrivals shed at the bounded admission queue (which
# keeps backlog delay out of the ack histogram, so overload shows as
# sheds and the knee lies inside the ladder).
PRESSURE_ACK_SLO_TICKS = 48
PRESSURE_SHED_SLO = 0.05

# Offered-load ladder (client arrivals per slot per tick) and the
# admission cap of the whole sweep.
PRESSURE_RATES = (0.05, 0.1, 0.2, 0.35, 0.5)
PRESSURE_QUEUE_CAP = 8


def _pressure_fields(cfg, knee: dict | None) -> dict:
    """The knee stamp (obs.manifest.PRESSURE_KEYS): the largest sustained
    ops/s meeting the SLO, the shed rate there, and the hash of the
    pressure program the sweep shared. Nulls: no load point met it."""
    from raft_tpu_torch import nemesis
    vals = {"knee_ops_per_sec": (round(knee["ops_per_sec"], 1)
                                 if knee else None),
            "shed_rate_at_knee": (knee["shed_rate"] if knee else None),
            "pressure_program_hash": nemesis.program_hash(cfg.nemesis)}
    if set(vals) != set(PRESSURE_KEYS):
        raise RuntimeError(f"obs.manifest.PRESSURE_KEYS {PRESSURE_KEYS} "
                           f"drifted from the bench producer {set(vals)}")
    return vals


def _knee(points: list) -> dict | None:
    """The knee of a swept ladder: among the load points that meet the
    SLO and kept safety and exactly-once, the one with the most ops/s
    (the first of equals), or None."""
    knee = None
    for pt in points:
        if pt["slo_ok"] and pt["safety_ok"] and (
                knee is None or pt["ops_per_sec"] > knee["ops_per_sec"]):
            knee = pt
    return knee


def _load_point(rate: float, st, m, elapsed, unsafe: int,
                eo_ok: bool) -> dict:
    """One rung's row from its end-point trees: acked ops (and ops/s over
    `elapsed`, None without a kernel wall), p99 ack latency, sheds and
    the shed rate against everything offered (completed, queued, in
    flight or shed at the gate), and the SLO verdict."""
    acked = total_client_ops(m)
    cl = st.clients

    def total(x):
        return int(x.to(torch.int64).sum())

    shed = total(cl.shed)
    admitted = total(cl.done) + total(cl.backlog) + total(cl.inflight)
    p99 = latency_quantile(m.client_hist, 0.99)
    censored = latency_censored(m.client_hist, 0.99)
    return {"offered_rate": rate,
            "ops_per_sec": (round(acked / elapsed, 1) if elapsed
                            else None),
            "acked_ops": acked,
            "ack_p99_ticks": p99, "ack_p99_censored": censored,
            "shed": shed,
            "shed_rate": round(shed / max(1, shed + admitted), 4),
            "slo_ok": (p99 <= PRESSURE_ACK_SLO_TICKS and not censored
                       and shed / max(1, shed + admitted)
                       <= PRESSURE_SHED_SLO),
            "unsafe_groups": unsafe,
            "safety_ok": unsafe == 0 and eo_ok}


def bench_pressure(seed: int, n_groups: int, ticks: int, label: str):
    """Graceful-degradation knee segment: offered client load swept up
    PRESSURE_RATES under the canonical storage-pressure program
    (`nemesis.pressure_mix`: a disk-full follower and compaction
    pressure) with the bounded admission queue on. EVERY rung runs on
    the kernel from tick 0 and is gated against its own plain run; the
    knee is the rung with the most kernel ops/s among those meeting the
    SLO. Safety and exactly-once accounting (shed ledger included) must
    hold at every rung."""
    from raft_tpu_torch import nemesis
    base = pressure_cfg(seed, ticks)
    log(f"  [{label}] program {nemesis.program_hash(base.nemesis)}: "
        f"{nemesis.describe(base.nemesis)}; SLO p99 <= "
        f"{PRESSURE_ACK_SLO_TICKS} ticks AND shed <= "
        f"{PRESSURE_SHED_SLO:.0%}, queue cap {PRESSURE_QUEUE_CAP}")
    points, runs = [], []
    x_total_s = k_total_s = 0.0
    for rate in PRESSURE_RATES:
        cfg = pressure_cfg(seed, ticks, rate)
        rl = f"{label} rate={rate}"
        st, m, f, x_elapsed = _plain_full_run(
            cfg, n_groups, ticks, rl, lambda st, m: total_client_ops(m))
        x_total_s += x_elapsed
        pal = _pallas_full_run(cfg, n_groups, ticks, "kacked", rl, st, m, f)
        del st, m, f
        k_total_s += pal["k_elapsed"]
        st, m, f = pal["end"]
        unsafe = _safety_check(rl, m, f, n_groups)
        eo_ok, eo_why = exactly_once_report(cfg, st, m)
        if not eo_ok:
            log(f"  [{rl}] EXACTLY-ONCE VIOLATED: {eo_why}")
        pt = _load_point(rate, st, m,
                         pal["k_elapsed"] if pal["promoted"] else None,
                         unsafe, eo_ok)
        pt.update(state_identical=pal["state_ok"],
                  metrics_identical=pal["metrics_ok"],
                  flight_identical=pal["flight_ok"])
        points.append(pt)
        runs.append((cfg, pal))
        log(f"  [{label}] rate={rate}: {pt['acked_ops']} acked "
            f"({pt['ops_per_sec']} ops/s), p99={pt['ack_p99_ticks']}"
            f"{' [CENSORED]' if pt['ack_p99_censored'] else ''}, "
            f"shed={pt['shed']} ({pt['shed_rate']:.2%}), "
            f"{'MEETS' if pt['slo_ok'] else 'misses'} SLO")
    promoted = all(pal["promoted"] for _, pal in runs)
    knee = _knee(points) if promoted else None
    if knee is None:
        log(f"  [{label}] NO load point met the SLO"
            + ("" if promoted else " (a rung's kernel disagreed with the "
               "plain tick)") + " — knee unresolved (manifest keys stay "
            "null)")
        cfg, pal = runs[0]
        knee_wall = k_total_s if promoted else None
    else:
        log(f"  [{label}] knee: rate={knee['offered_rate']} -> "
            f"{knee['ops_per_sec']:,.0f} ops/s at p99="
            f"{knee['ack_p99_ticks']} ticks, shed rate "
            f"{knee['shed_rate']:.2%}")
        cfg, pal = runs[points.index(knee)]
        knee_wall = pal["k_elapsed"]
    k_name, nd = runs[0][1]["k_name"], runs[0][1]["nd"]
    engine = k_name if promoted else MISMATCH_ENGINE
    seg = {
        **_pressure_fields(cfg, knee),
        "ack_slo_p99_ticks": PRESSURE_ACK_SLO_TICKS,
        "shed_slo": PRESSURE_SHED_SLO,
        "queue_cap": PRESSURE_QUEUE_CAP,
        "knee_offered_rate": knee["offered_rate"] if knee else None,
        "knee_ack_p99_ticks": knee["ack_p99_ticks"] if knee else None,
        "load_points": points,
        "exactly_once_ok": all(p["safety_ok"] for p in points),
        "engine": engine,
        "state_identical": all(p["state_identical"] for p in points),
        "metrics_identical": all(p["metrics_identical"] for p in points),
        "flight_identical": all(p["flight_identical"] for p in points),
        "n_groups": n_groups, "ticks": ticks,
        **_nemesis_fields(cfg),
        **_wall_fields(knee_wall, plain_wall_s=x_total_s,
                       kernel_wall_s=k_total_s,
                       kernel_warmup_wall_s=runs[0][1]["k_warmup_s"]),
        "safety_ok": all(p["safety_ok"] for p in points),
        "unsafe_groups": max(p["unsafe_groups"] for p in points),
        "workload": workload_params(cfg),
        **_mesh_fields(n_groups, nd),
        **_roofline_fields(cfg, n_groups, engine,
                           ticks * (1 if knee else len(points)),
                           knee_wall, nd=nd,
                           ops=_run_ops(cfg, n_groups, ticks,
                                        *pal["end"][:2])),
        **_packing_fields(cfg),
        **_stream_fields(cfg, pal),
    }
    emit_manifest(label, cfg, _MANIFEST, **_CARD, **seg)
    return seg


# ---------------------------------------------------------------- entry


def _launch_counts() -> dict:
    return {"fused_chunk": kernel.kstep.launches,
            "wire_unpack": kernel.unpack_wire.launches,
            "wire_pack": kernel.pack_wire.launches}


def _build_all(shapes: dict) -> None:
    """Compile every kernel build the run launches, one `nvcc` per flag
    set, all started together (`kernel.build`), and print the seconds."""
    ticks = shapes["nemesis"][1], shapes["pressure"][1]
    cfgs = [throughput_cfg(), fault_cfg(43), election_cfg(), reads_cfg(),
            clients_cfg(47), nemesis_cfg(48, ticks[0])]
    cfgs += [pressure_cfg(49, ticks[1], r) for r in PRESSURE_RATES]
    flags = sorted({kernel.features(c) for c in cfgs})
    t = time.time()
    kernel.build(flags, codec=any(kernel.packs(c) for c in cfgs))
    log(f"build: fused_chunk.cu for {len(flags)} flag set(s) "
        f"{[kernel.flag_name(f) for f in flags]}"
        + (" and wire_codec.cu" if any(kernel.packs(c) for c in cfgs)
           else "") + f" in {time.time() - t:.1f} s")


def main(argv=None) -> int:
    global _TRACE_PATH, _DEVICE, _MANIFEST
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="1,000 groups x 200 ticks for every segment")
    ap.add_argument("--groups", type=int, default=None,
                    help="override the throughput and config-5 group "
                         "counts")
    ap.add_argument("--manifest", default="bench_manifest.jsonl",
                    help="the run manifest JSONL each segment appends one "
                         "record to ('-': none; default "
                         "./bench_manifest.jsonl)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a Chrome trace-event timeline "
                         "(trace_bench.json, Perfetto-loadable) and the "
                         "heartbeat JSONL into this directory")
    ap.add_argument("--torch-profile", action="store_true",
                    help="with --trace-dir, also capture a torch.profiler "
                         "trace per segment under DIR/torchprof")
    ap.add_argument("--heartbeat-every", type=int, default=10,
                    help="launches between heartbeat records (with "
                         "--trace-dir; default 10)")
    ap.add_argument("--pack-wire", action="store_true",
                    help="every segment on the packed kernel wire "
                         "(pack_bools + pack_ring + alias_wire, through "
                         "the codec kernels); the gates are unchanged")
    ap.add_argument("--stream", action="store_true",
                    help="every kernel segment through the cohort "
                         "scheduler (stream_groups): the fleet's wire in "
                         "host memory, paged through the card; the gates "
                         "are unchanged, and every segment stamps the "
                         "predicted and measured overlap")
    ap.add_argument("--cohort-blocks", type=int, default=None,
                    help="with --stream: 1,024-group blocks per cohort "
                         "window (default: the config's, 4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain tick in the kernel's place "
                         "(engine plain-cpu), for the CPU tests")
    args = ap.parse_args(argv)

    _DEVICE = torch.device(args.device)
    if _on_card() and not torch.cuda.is_available():
        print("bench_torch: CUDA is not available (pass --device cpu to run "
              "the plain engine in the kernel's place)", file=sys.stderr)
        return 2
    _MANIFEST = args.manifest
    _WIRE_DIALS.clear()
    _MISMATCHES.clear()
    if args.pack_wire:
        # wire_hist stays on: the histograms and the full-Metrics gate
        # need the in-kernel histogram rows.
        _WIRE_DIALS.update(pack_bools=True, pack_ring=True,
                           alias_wire=True)
        log("packed wire: pack_bools + pack_ring + alias_wire on for "
            "every segment (wire_hist stays on for the histograms)")
    if args.stream:
        _WIRE_DIALS.update(stream_groups=True)
        if args.cohort_blocks is not None:
            _WIRE_DIALS.update(cohort_blocks=args.cohort_blocks)
        log(f"cohort streaming: stream_groups on for every kernel segment "
            f"(cohort_blocks="
            f"{args.cohort_blocks if args.cohort_blocks is not None else 4}"
            f"; the plain reference stays resident)")
    elif args.cohort_blocks is not None:
        ap.error("--cohort-blocks requires --stream")

    # Pre-flight engine-contract audit: no kernel, no card. A drifted
    # wire registry, byte model or checkpoint contract aborts the run
    # here, so no number is published off a drifted layout.
    from raft_tpu_torch import analysis
    analysis.startup_audit(level="static", log=log)

    _CARD.update(_card_fields())
    n_dev = torch.cuda.device_count() if _on_card() else 0
    log(f"device: {_CARD['device']} ({_CARD['power_limit_w']} W), "
        f"{n_dev} card(s) visible")
    shapes = dict(SHAPES["quick" if args.quick else "full"])
    if args.groups and not args.quick:
        for name in ("throughput", "config-5"):
            shapes[name] = (args.groups, shapes[name][1])
    if _on_card():
        _build_all(shapes)

    tracer = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        tracer = obs_trace.Tracer()
        obs_trace.set_tracer(tracer)
        _TRACE_PATH = os.path.join(args.trace_dir, "trace_bench.json")
        obs_trace.set_heartbeat(obs_trace.Heartbeat(
            os.path.join(args.trace_dir, "heartbeat.jsonl"),
            every=args.heartbeat_every))
        log(f"tracing to {_TRACE_PATH} (heartbeat every "
            f"{args.heartbeat_every} launches; NOTE: a heartbeat reads "
            f"lanes back, so it syncs the card mid-segment: walls include "
            f"that cost)")

    def segment(label, fn, *fargs):
        """One segment under its span (and a torch.profiler capture with
        --torch-profile)."""
        prof = contextlib.nullcontext()
        if args.torch_profile and args.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if _on_card() else [])
            prof = torch.profiler.profile(activities=acts)
        with obs_trace.span(label, cat=obs_trace.CAT_SEGMENT), prof as p:
            out = fn(*fargs)
        if p is not None:
            d = os.path.join(args.trace_dir, "torchprof")
            os.makedirs(d, exist_ok=True)
            p.export_chrome_trace(os.path.join(
                d, label.replace(" ", "_") + ".json"))
        return out

    kernel.kstep.launches = 0
    kernel.unpack_wire.launches = kernel.pack_wire.launches = 0
    # The trace must survive a failed run: the save rides a finally.
    try:
        g, t = shapes["throughput"]
        log(f"throughput (config-5 shape, {g} x 5-node groups):")
        tp = segment("throughput", bench_throughput, g, t)
        log("election latency (config-4 shape):")
        c4 = segment("config-4 fault run", bench_fault_latency, 43,
                     *shapes["config-4"], "config-4 fault run")
        log("fault-mix throughput + latency (config-5 shape):")
        c5f = segment("config-5 fault mix", bench_fault_latency, 46,
                      *shapes["config-5"], "config-5 fault mix")
        log("election rounds (config-2 shape):")
        c2 = segment("election-rounds", bench_election_rounds,
                     *shapes["election-rounds"])
        log("linearizable reads (config-5 shape + ReadIndex schedule):")
        rd = segment("reads", bench_reads, *shapes["reads"])
        log("client traffic SLO (config-5 fault mix + open-loop "
            "exactly-once sessions):")
        cl = segment("client-slo fault mix", bench_clients, 47,
                     *shapes["clients"], "client-slo fault mix")
        log("gray-failure mix (nemesis program on light churn):")
        nm = segment("nemesis gray mix", bench_nemesis, 48,
                     *shapes["nemesis"], "nemesis gray mix")
        log("storage-pressure knee (offered-load sweep under disk-full "
            "+ compaction pressure, bounded admission):")
        pr = segment("pressure knee", bench_pressure, 49,
                     *shapes["pressure"], "pressure knee")

        # Every segment carries the roofline, wall and packing stamps: a
        # number that cannot explain itself is not published.
        for name, seg in (("throughput", tp), ("config-4", c4),
                          ("config-5-faults", c5f),
                          ("election-rounds", c2), ("reads", rd),
                          ("client-slo", cl), ("nemesis", nm),
                          ("pressure", pr)):
            missing = [k for k in obs_roofline.ROOFLINE_FIELDS
                       if k not in seg]
            missing += [k for k in SEGMENT_WALL_KEYS if k not in seg]
            missing += [k for k in PACKING_KEYS if k not in seg]
            if missing:
                raise RuntimeError(
                    f"bench segment {name!r} lost contract field(s) "
                    f"{missing} — roofline/wall/packing stamping drifted")
    finally:
        if tracer is not None:
            obs_trace.set_heartbeat(None)
            obs_trace.set_tracer(None)
            log(f"trace: {len(tracer.events)} events -> "
                f"{tracer.save(_TRACE_PATH)}")
    log(f"bench_torch launches: {json.dumps(_launch_counts())}")

    # The client and pressure segments' exactly-once verdicts fold into
    # the global safety bit.
    safety_ok = all(s["safety_ok"]
                    for s in (tp, c4, c5f, c2, rd, cl, nm, pr)) \
        and cl["exactly_once_ok"] and pr["exactly_once_ok"]
    if not safety_ok:
        log("SAFETY: at least one segment dropped the per-tick safety "
            "bit — see the flight-recorder dumps above")
    value = tp["rounds_per_sec"]
    print(json.dumps({
        "metric": "consensus_rounds_per_sec_per_chip",
        "value": value,
        "unit": "rounds/s",
        "vs_baseline": (round(value / BASELINE_ROUNDS_PER_SEC, 3)
                        if value is not None else None),
        "n_groups": shapes["throughput"][0],
        "ticks": tp["ticks"],
        "wall_s": tp["timed_wall_s"],
        "warmup_wall_s": tp["plain_warmup_wall_s"],
        "engine": tp["engine"],
        "pallas_rounds_per_sec": tp["pallas_rounds_per_sec"],
        "pallas_ms_per_tick": tp["pallas_ms_per_tick"],
        "pallas_warmup_wall_s": tp["kernel_warmup_wall_s"],
        "throughput_state_identical": tp["state_identical"],
        "throughput_safety_ok": tp["safety_ok"],
        "predicted_rounds_per_sec": tp["predicted_rounds_per_sec"],
        "attainment_pct": tp["attainment_pct"],
        "bound": tp["bound"],
        "safety_ok": safety_ok,
        "p50_election_latency_ticks": c4["p50"],
        "p99_election_latency_ticks": c4["p99"],
        "p99_censored": c4["censored"],
        "max_election_latency_ticks": c4["max_lat"],
        "p99_note": c4["p99_note"],
        "elections_observed": c4["elections"],
        "config4_engine": c4["engine"],
        "config4_state_identical": c4["state_identical"],
        "config4_safety_ok": c4["safety_ok"],
        "config4_plain_wall_s": c4["plain_wall_s"],
        "config4_plain_warmup_wall_s": c4["plain_warmup_wall_s"],
        "config4_kernel_wall_s": c4["kernel_wall_s"],
        "config4_kernel_warmup_wall_s": c4["kernel_warmup_wall_s"],
        "faulted_rounds_per_sec": _null_rate(c5f["rounds_per_sec"]),
        "faulted_p50_election_latency_ticks": c5f["p50"],
        "faulted_p99_election_latency_ticks": c5f["p99"],
        "faulted_p99_censored": c5f["censored"],
        "faulted_elections_observed": c5f["elections"],
        "config5_fault_n_groups": c5f["n_groups"],
        "config5_fault_engine": c5f["engine"],
        "config5_fault_state_identical": c5f["state_identical"],
        "config5_fault_safety_ok": c5f["safety_ok"],
        "config5_fault_plain_wall_s": c5f["plain_wall_s"],
        "config5_fault_plain_warmup_wall_s": c5f["plain_warmup_wall_s"],
        "config5_fault_kernel_wall_s": c5f["kernel_wall_s"],
        "config5_fault_kernel_warmup_wall_s": c5f["kernel_warmup_wall_s"],
        "elections_per_sec": c2["elections_per_sec"],
        "config2_elections_observed": c2["elections"],
        "config2_engine": c2["engine"],
        "config2_state_identical": c2["state_identical"],
        "config2_safety_ok": c2["safety_ok"],
        "config2_note": "schedule-bound rate; see bench_election_rounds",
        "linearizable_reads_per_sec": rd["reads_per_sec"],
        "reads_observed": rd["reads"],
        "reads_engine": rd["engine"],
        "reads_state_identical": rd["state_identical"],
        "reads_safety_ok": rd["safety_ok"],
        "client_ops_per_sec": cl["client_ops_per_sec"],
        "client_ops_acked": cl["acked_ops"],
        "client_retries": cl["retries"],
        "client_ack_p50_ticks": cl["ack_p50_ticks"],
        "client_ack_p99_ticks": cl["ack_p99_ticks"],
        "client_ack_p99_censored": cl["ack_p99_censored"],
        "client_exactly_once_ok": cl["exactly_once_ok"],
        "client_engine": cl["engine"],
        "client_state_identical": cl["state_identical"],
        "client_safety_ok": cl["safety_ok"],
        "client_workload": cl["workload"],
        "nemesis_rounds_per_sec": _null_rate(nm["rounds_per_sec"]),
        "nemesis_p50_election_latency_ticks": nm["p50"],
        "nemesis_p99_election_latency_ticks": nm["p99"],
        "nemesis_p99_censored": nm["censored"],
        "nemesis_elections_observed": nm["elections"],
        "nemesis_program_hash": nm["nemesis_program_hash"],
        "nemesis_engine": nm["engine"],
        "nemesis_state_identical": nm["state_identical"],
        "nemesis_safety_ok": nm["safety_ok"],
        "knee_ops_per_sec": pr["knee_ops_per_sec"],
        "shed_rate_at_knee": pr["shed_rate_at_knee"],
        "pressure_program_hash": pr["pressure_program_hash"],
        "pressure_ack_slo_p99_ticks": pr["ack_slo_p99_ticks"],
        "pressure_shed_slo": pr["shed_slo"],
        "pressure_knee_ack_p99_ticks": pr["knee_ack_p99_ticks"],
        "pressure_queue_cap": pr["queue_cap"],
        "pressure_load_points": pr["load_points"],
        "pressure_exactly_once_ok": pr["exactly_once_ok"],
        "pressure_engine": pr["engine"],
        "pressure_state_identical": pr["state_identical"],
        "pressure_safety_ok": pr["safety_ok"],
        "device": _CARD["device"],
        "power_limit_w": _CARD["power_limit_w"],
    }), flush=True)
    if _MISMATCHES:
        log(f"bench_torch: the kernel disagreed with the plain tick in "
            f"{_MISMATCHES}; their numbers are null")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
