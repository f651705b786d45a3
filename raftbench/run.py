"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 -m raftbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up (`setup_s`, from the start of this module): imports, the CUDA
context, the kernel build of the cell's flag set (`kernel.load`; the
first run in a checkout compiles it into the program's fixed
`raft_tpu_torch/csrc/build`), and one warm-up universe at the cell's own
shapes for each of the run's universe seeds (`spec.universe_seeds`). The
window then runs universes back to back, one in flight (a closed loop, as
a seed sweep runs), each from `state.init` to its Metrics and flight ring
on the host, until the universes' walls add up to `--seconds`. The
window is those walls: between two universes the harness gathers the
sampled groups of the one that ended (`check.Samples`), off the clock.
With `--trace 1` two blocks of the window's universes run under one
`torch.profiler` session (`Blocks`): the first bare, read for the kernel
and the device (`Run.timeline`: `busy_s`, `window_s`, the `breakdown` and
the readers of the device), the second with the program's tracer
installed (`System.tracing()`), read for the program's own spans and the
host's launch calls (`Run.program_timeline`). The tracer's ranges cost
the host time, so no reading of the first block carries them. The result
carries the per-layer metrics, all read inside the universes' spans.

After the window the peak memory is read, the program's state freed, and
a sample of the groups drawn from the seed is judged against the plain
reference (`check.py`). The numbers compared, each with its limit, are the
last lines on standard error and the result line's last key, `checks`.

Exits 2 without a result when no card (or fewer than the cell's) is
visible, 3 when `jax`, `jaxlib`, `flax` or `raft_tpu` is loaded once the
window has closed, 1 on any other failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from raftbench import check, metrics_util, roofline, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")
PROFILE_SKIP = 1        # universes of the window before the profiler starts
PROFILE_UNIVERSES = 40  # universes a profiled block covers at most
PROFILE_BLOCKS = 2      # the bare block, then the block with the tracer


@dataclasses.dataclass
class Run:
    """What one run measured, as the metric readers see it."""
    cell: spec.Cell
    setup_s: float
    window_s: float         # the universes' walls, added up
    walls_ms: list          # each universe's wall, in window order
    group_ticks: int        # groups x ticks of the universes completed
    timeline: object = None  # profile.Timeline of a traced run
    roofline: dict | None = None   # least time of one universe's work
    # profile.Timeline of the traced run's block with the program's tracer
    program_timeline: object = None


def block_of(u: int) -> int | None:
    """The profiled block (0: bare, 1: with the program's tracer) that
    universe `u` of a traced run's window falls in, or None."""
    i = u - PROFILE_SKIP
    if 0 <= i < PROFILE_BLOCKS * PROFILE_UNIVERSES:
        return i // PROFILE_UNIVERSES
    return None


class Blocks:
    """The profiled blocks of a traced run (`block_of`), started and ended
    between two universes, off the clock: one `profiler()` session over
    both, and in block 1 `system.tracing()` inside it. One session, read
    once it has ended: on the card a second profiler session loses the
    first one's device events. `session` is the profiler, once started."""

    def __init__(self, system, profiler):
        self.system, self.profiler = system, profiler
        self.stack = contextlib.ExitStack()
        self.block = None
        self.session = None

    def before(self, u: int) -> None:
        """Start, move on or end the blocks before universe `u`."""
        b = block_of(u)
        if b == self.block:
            return
        if b is None:
            self.close()
        elif self.session is None:
            self.session = self.stack.enter_context(self.profiler())
        if b == 1:
            self.stack.enter_context(self.system.tracing())
        self.block = b

    def close(self) -> None:
        """End the blocks in progress, if any."""
        self.stack.close()
        self.block = None


def forbidden_modules(modules=None) -> list:
    """The names of `FORBIDDEN` that are the top-level name of a loaded
    module (of `modules`, default `sys.modules`), compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def read_metrics(run: Run, entries) -> dict:
    """{name: {"value", "unit"}} of the metric entries whose reader found
    something to read."""
    out = {}
    for m in entries:
        v = metrics_util.metric(m["name"], run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             devices=None, t_start: float | None = None, system_cls=None,
             warmup: bool = True,
             samples_per_universe: int = check.SAMPLES_PER_UNIVERSE) -> dict:
    """Run `cell` once. Returns the result line's object. `devices`
    (the CPU tests: `["cpu"] * chips`) replaces the cards; `system_cls`
    replaces `system.System` (the control and the tests' broken
    programs), which may also skip the warm-up and take more samples a
    universe."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from raftbench import profile
    if system_cls is None:
        from raftbench.system import System as system_cls
    seeds = spec.universe_seeds(seed)
    sysm = system_cls(cell.raft_fields(seeds[0]), cell.groups, cell.ticks,
                      cell.ring, cell.chips, devices)
    on_card = sysm.device.type == "cuda"
    t_build = time.perf_counter()
    sysm.build()
    t_built = time.perf_counter()
    samples = check.Samples(seed)

    def universe(u: int, keep: bool, spans) -> tuple:
        first = u * cell.groups
        useed = seeds[u % len(seeds)]
        sysm.use_seed(useed)
        t0 = time.perf_counter()
        with spans(profile.UNIVERSE):
            with spans("raftbench.init"):
                st, m, f = sysm.init(first)
            with spans("raftbench.prun"):
                st, m, f = sysm.prun(st, m, f)
            with spans("raftbench.fetch"):
                host = sysm.fetch(m, f)
        t1 = time.perf_counter()
        with spans("raftbench.sample"):
            pos = check.positions(seed, u, cell.groups,
                                  samples_per_universe)
            state = sysm.sample_state(st, torch.from_numpy(pos))
            if keep:
                samples.keep(u, useed, first, pos, state, host,
                             sysm.clients)
        return t0, t1

    def no_span(_name):
        return contextlib.nullcontext()

    if trace and on_card:
        # The first profiler session initialises CUPTI: in set-up, not in
        # the window.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=sysm.device).add_(1)
            sysm.synchronize()
    if warmup:
        for u in range(len(seeds)):
            universe(u, False, no_span)
    setup_s = time.perf_counter() - t_start
    log(f"setup: {setup_s:.3f} s (to the build {t_build - t_start:.3f} s, "
        f"build {t_built - t_build:.3f} s, warm-up "
        f"{time.perf_counter() - t_built:.3f} s)")

    walls, failed, error = [], 0, None
    rf = torch.profiler.record_function if trace else no_span
    blocks = Blocks(sysm, lambda: torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]))
    measured = 0.0
    u = 0
    while not walls or measured < seconds:
        if trace and on_card:
            blocks.before(u)
        try:
            t0, t1 = universe(u, True, rf)
        except Exception as e:   # a universe that fails ends the window
            failed, error = 1, e
            break
        walls.append((t1 - t0) * 1e3)
        measured += t1 - t0
        u += 1
    blocks.close()
    run = Run(cell=cell, setup_s=setup_s, window_s=measured,
              walls_ms=walls, group_ticks=len(walls) * cell.groups
              * cell.ticks)
    peak = sysm.memory_peak_bytes()
    kind = torch.cuda.get_device_name(sysm.device) if on_card else "cpu"
    if blocks.session is not None:
        run.timeline, run.program_timeline = profile.split(profile.collect(
            blocks.session, profile.port_kernel_names(sysm.CSRC)
            if sysm.CSRC else (), [d.index for d in sysm.mesh]),
            PROFILE_UNIVERSES)
    del blocks, sysm
    if on_card:
        torch.cuda.empty_cache()
    if error is not None:
        log(f"universe {len(walls)} failed: {error!r}")

    # The check, once the window has closed and the program's state is
    # freed.
    result = {"compared": 0, "mismatched": 0, "unsafe_both": 0,
              "details": []}
    judged = samples.judged()
    ref_error = None
    if judged:
        ids = [g for r in judged for g in r["group_ids"]]
        batches = check.batches(judged)
        t_ref = time.perf_counter()
        try:
            ref = check.run_reference(
                [(cell.raft_fields(s), g) for s, g in batches],
                cell.ticks, cell.ring)
        except RuntimeError as e:
            ref_error = e
        else:
            result = check.compare(judged, ref)
            g = cell.groups
            per_group = ref["ops"] / len(ids)
            least = roofline.least_time(2 * ref["group_bytes"] * g / cell.chips,
                                        per_group * g / cell.chips)
            run.roofline = least
            log(f"roofline: one universe's least time on a card "
                f"{least['seconds'] * 1e3:.6f} ms, bound by "
                f"{least['bound']} (bytes {least['hbm_s'] * 1e3:.6f} ms, "
                f"operations {least['ops_s'] * 1e3:.6f} ms); card: "
                f"{_power_limit() if on_card else 'none'}")
        log(f"reference: {len(ids)} groups of {len(judged)} universes in "
            f"{time.perf_counter() - t_ref:.1f} s")
    if ref_error is not None:
        log(f"reference failed: {ref_error}")
    for d in result["details"][:20]:
        log(f"mismatch: {d}")
    for u_, b in samples.identity[:20]:
        log(f"identity break: universe {u_}: {b}")
    log(f"sampled groups unsafe in the reference too (the semantics' own): "
        f"{result['unsafe_both']} of {result['compared']}")

    checks = {
        "groups_mismatched": {"value": result["mismatched"], "limit": 0},
        "identity_breaks": {"value": len(samples.identity), "limit": 0},
        "universes_failed": {"value": failed, "limit": 0},
        "reference_failed": {"value": int(ref_error is not None),
                             "limit": 0},
        "groups_compared": {"value": result["compared"], "limit": 1},
    }
    correct = (result["compared"] >= 1
               and all(c["value"] <= c["limit"] for k, c in checks.items()
                       if k != "groups_compared"))
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(walls) + failed,
           "failed": failed, "metrics": metrics, "device": device}
    if trace and run.timeline is not None:
        tl = run.timeline
        busy = [profile.length(profile.busy(tl, d)) for d in tl.devices]
        device["busy_s"] = float(np.mean(busy)) / 1e6
        device["window_s"] = profile.universe_time(tl) / 1e6
        out["breakdown"] = profile.breakdown(run.timeline)
    for k, c in checks.items():
        rel = ">=" if k == "groups_compared" else "<="
        log(f"check {k}: {c['value']} (limit {rel} {c['limit']})")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible: no result")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}: no result")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
