"""The program's spans in the harness: a traced run's second profiled
block, with the program's tracer installed, is read for the program's
`raft_tpu_torch.<span>` ranges and the host's launch calls. On
hand-written Chrome traces (one card and four) the readers of those
spans give hand-computed values, and adding the program's ranges and
launch calls to a trace moves no reading of the benchmark's own spans
or of the device. A reader of a program span is a new file under
`raftbench/metrics/` and a new `per_layer` entry, nothing else. On the
CPU the tracer is installed in the second block's universes alone, its
spans reach the profiler's trace under the names the readers take, and
an untraced universe runs with no tracer.

    python -m pytest raftbench/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import shutil

import pytest
import torch

from raftbench import metrics_util, profile, run, spec
from raftbench.system import System
from raft_tpu_torch.obs import trace

SEED = 2 ** 31 + 77
R = profile.PROGRAM_PREFIX
X4 = "raft5.steady.x4"


def X(name, cat, ts, dur, device=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def _one_card(at: float, fill: bool, first_launch: bool,
              program: bool = True) -> list:
    """One universe of 100 us from `at` on card 0. Init spans [2, 28),
    the fill kernel [10, 15) inside them when `fill`; `prun` [32, 88)
    with a copy [40, 44) and the port kernel [48, 92); launch calls at 9
    (when `first_launch`), 26, 39 and 47 inside the spans, 30 and 92
    outside, a synchronise at 53. Without `program`, no program range
    and no host call: the trace the parent's harness read."""
    ev = [X("raftbench.universe", "user_annotation", at, 100),
          X("raftbench.init", "user_annotation", at, 30),
          X("raftbench.prun", "user_annotation", at + 30, 60),
          X("raftbench.fetch", "user_annotation", at + 90, 10)]
    ops = ([("fill_kernel", "kernel", 10, 5)] if fill else []) + [
        ("cat", "kernel", 40, 4), ("void fused_chunk_kernel<true>(int*)",
                                   "kernel", 48, 44),
        ("Memcpy DtoH", "gpu_memcpy", 93, 4)]
    ev += [X(n, c, at + a, d, 0) for n, c, a, d in ops]
    if not program:
        return ev
    spans = [("state.init", 2, 18), ("run.metrics_init", 20, 5),
             ("recorder.flight_init", 25, 3), ("prun", 32, 56),
             ("kinit", 33, 12), ("run.metrics_init", 34, 2),
             ("kinit encode", 36, 8), ("chunk cuda [0,600)", 46, 4),
             ("kstep launch", 47, 2), ("kfinish", 52, 28)]
    ev += [X(R + n, "user_annotation", at + a, d) for n, a, d in spans]
    calls = ([("cudaLaunchKernel", 9)] if first_launch else []) + [
        ("cudaMemsetAsync", 26), ("cudaLaunchKernelExC", 39),
        ("cuLaunchKernel", 47), ("cudaLaunchKernel", 30),
        ("cudaMemcpyAsync", 92), ("cudaStreamSynchronize", 53)]
    ev += [X(n, "cuda_runtime", at + t, 1) for n, t in calls]
    return ev


def one_card(program: bool = True) -> profile.Timeline:
    """Two universes: the first with the fill kernel and the launch at
    9, the second without either."""
    evs = _one_card(0.0, True, True, program) + _one_card(
        200.0, False, False, program)
    return profile.read_chrome_trace({"traceEvents": evs},
                                     ("fused_chunk_kernel",), [0])


def _four_cards(at: float, program: bool = True) -> list:
    """One sharded universe of 100 us from `at`: `kmesh prun` [30, 95)
    with `kmesh cut` [31, 40), `kmesh kinit` [40, 45), `kmesh gather`
    [75, 80), `kmesh finish` [80, 92). Card 0: the fill [10, 15), the
    cut's copies [32, 38), its kernel [46, 74), the gather [75, 79), the
    decode [81, 90). Card d of 1-3: a copy in [33, 36), its kernel
    [46, 70 + d), card 3's also [76, 78)."""
    ev = [X("raftbench.universe", "user_annotation", at, 100),
          X("raftbench.prun", "user_annotation", at + 30, 65)]
    ops = [(0, "fill_kernel", "kernel", 10, 5),
           (0, "Memcpy PtoP", "gpu_memcpy", 32, 6),
           (0, "fused_chunk_kernel", "kernel", 46, 28),
           (0, "Memcpy DtoD", "gpu_memcpy", 75, 4),
           (0, "decode", "kernel", 81, 9)]
    for d in (1, 2, 3):
        ops += [(d, "Memcpy PtoP", "gpu_memcpy", 33, 3),
                (d, "fused_chunk_kernel", "kernel", 46, 24 + d)]
    ops += [(3, "Memcpy DtoD", "gpu_memcpy", 76, 2)]
    ev += [X(n, c, at + a, dur, d) for d, n, c, a, dur in ops]
    if program:
        spans = [("state.init", 2, 18), ("kmesh prun", 30, 65),
                 ("kmesh cut", 31, 9), ("kmesh kinit", 40, 5),
                 ("kmesh gather", 75, 5), ("kmesh finish", 80, 12)]
        ev += [X(R + n, "user_annotation", at + a, d) for n, a, d in spans]
        ev += [X("cudaLaunchKernel", "cuda_runtime", at + t, 1)
               for t in (9, 45, 81)]
    return ev


def four_cards(program: bool = True) -> profile.Timeline:
    evs = _four_cards(0.0, program) + _four_cards(200.0, program)
    return profile.read_chrome_trace({"traceEvents": evs},
                                     ("fused_chunk_kernel",), [0, 1, 2, 3])


def _run_of(tl, program_tl, cell: str = "raft5.steady"):
    return run.Run(cell=spec.cell(cell), setup_s=1.0, window_s=1.0,
                   walls_ms=[0.1, 0.1], group_ticks=1, timeline=tl,
                   roofline={"seconds": 0.03e-3},
                   program_timeline=program_tl)


def test_the_program_ranges_and_launch_calls_are_kept_apart():
    tl = one_card()
    assert [n for n, _, _ in tl.spans] == ["raftbench.init", "raftbench.prun",
                                          "raftbench.fetch"] * 2
    assert ("kinit encode", 36.0, 44.0) in tl.program_spans
    # the synchronise is no launch; the six launch calls of the first
    # universe and the five of the second
    assert len(tl.launches) == 11
    assert profile.top_level(profile.universe_program_spans(tl, 0, 100)) \
        == [("state.init", 2.0, 20.0), ("run.metrics_init", 20.0, 25.0),
            ("recorder.flight_init", 25.0, 28.0), ("prun", 32.0, 88.0)]


def test_the_helper_gives_the_idle_card_inside_named_spans():
    tl = one_card()
    init = ("state.init", "run.metrics_init", "recorder.flight_init")
    # init [2, 28): 26 us, less the fill kernel's 5 in the first universe
    assert profile.idle_in_spans(tl, init) == [21.0, 26.0]
    # `run.metrics_init` inside `kinit` is not top level: with `top` off
    # its 2 us inside `prun` count too
    assert profile.idle_in_spans(tl, ("run.metrics_init",)) == [5.0, 5.0]
    assert profile.idle_in_spans(tl, ("run.metrics_init",), top=False) \
        == [7.0, 7.0]
    # prun [32, 88): the copy's 4 us and the kernel's 40 busy
    assert profile.idle_in_spans(tl, ("prun",)) == [12.0, 12.0]
    assert profile.launches_in_spans(tl, init + ("prun",)) == [4, 3]
    assert profile.idle_in_spans(tl, ("no such span",)) == []


def test_the_three_readers_on_one_card():
    r = _run_of(one_card(program=False), one_card())
    m = metrics_util.metric
    assert m("init_idle_ms", r) == pytest.approx((21 + 0.9 * 5) / 1e3)
    assert m("boundary_idle_ms", r) == pytest.approx(0.012)
    assert m("host_launches_per_universe", r) == 3.5
    assert m("mesh_first_card_idle_ms", r) is None


def test_the_readers_on_four_cards():
    r = _run_of(four_cards(program=False), four_cards(), X4)
    m = metrics_util.metric
    # cards 1-3 inside the cut [31, 40) and the gather and finish
    # [75, 92): 26 us, less the copy's 3 on each and card 3's 2
    assert m("mesh_first_card_idle_ms", r) == pytest.approx(
        (23 + 23 + 21) / 3 / 1e3)
    assert profile.idle_in_spans(r.program_timeline, ("kmesh cut",),
                                 devices=[0], top=False) == [3.0, 3.0]
    # the top-level `kmesh prun` [30, 95) over the four cards
    idle = [65 - 6 - 28 - 4 - 9] + [65 - 3 - (24 + d) for d in (1, 2)] \
        + [65 - 3 - 27 - 2]
    assert m("boundary_idle_ms", r) == pytest.approx(sum(idle) / 4 / 1e3)
    assert m("host_launches_per_universe", r) == 3
    assert m("shard_spread_ms", r) == pytest.approx(0.003)
    for name in ("group_ticks_per_s", "universe_p90_ms",
                 "kernel_ms_per_universe", "device_idle_pct"):
        assert m(name + ".mesh", r) == m(name, r) is not None


@pytest.mark.parametrize("timeline", [one_card, four_cards])
def test_program_ranges_move_no_existing_reading(timeline):
    bare, traced = timeline(program=False), timeline()
    assert traced.launches and not bare.launches
    for name in ("kernel_ms_per_universe", "kernel_roofline_pct",
                 "device_idle_pct", "outside_kernel_p90_ms",
                 "shard_spread_ms"):
        assert metrics_util.metric(name, _run_of(bare, None)) == \
            metrics_util.metric(name, _run_of(traced, None))
    assert profile.breakdown(bare) == profile.breakdown(traced)
    assert metrics_util.metric("init_idle_ms", _run_of(traced, bare)) is None


def test_a_session_split_by_block_reads_as_each_block_alone():
    """The first block of one session reads as that block's own trace:
    the parent's single block, ending with its last universe."""
    whole = one_card()
    first, second = profile.split(whole, 1)
    alone = profile.read_chrome_trace(
        {"traceEvents": _one_card(0.0, True, True)}, ("fused_chunk_kernel",),
        [0])
    assert first.universes == alone.universes and len(second.universes) == 1
    for name in ("kernel_ms_per_universe", "kernel_roofline_pct",
                 "device_idle_pct", "outside_kernel_p90_ms"):
        assert metrics_util.metric(name, _run_of(first, None)) == \
            metrics_util.metric(name, _run_of(alone, None))
    assert profile.breakdown(first) == profile.breakdown(alone)
    assert profile.idle_in_spans(second, ("state.init",)) == [18.0]
    assert profile.split(whole, 2)[1] is None
    assert profile.split(None, 40) == (None, None)


def test_a_reader_of_a_program_span_is_a_file_and_an_entry(tmp_path,
                                                           monkeypatch):
    """`kinit_encode_idle_ms`, in no `BENCHMARK.json`: a new file under
    `metrics/` and a new `per_layer` entry reach the result."""
    for d in ("metrics", "traffic"):
        shutil.copytree(spec.HERE / d, tmp_path / d)
    (tmp_path / "metrics" / "kinit_encode_idle_ms.py").write_text(
        "from raftbench import profile\n\n\n"
        "def read(run):\n"
        "    tl = run.program_timeline\n"
        "    us = [] if tl is None else profile.idle_in_spans(\n"
        "        tl, ('kinit encode',), top=False)\n"
        "    return max(us) / 1e3 if us else None\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    bench = spec.load_benchmark()
    assert "kinit_encode_idle_ms" not in json.dumps(bench)
    bench["per_layer"].append(
        {"name": "kinit_encode_idle_ms", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "entry point, sim.state.init "
         "+ sim.kernel.prun boundary", "moves": "universe_p90_ms",
         "workloads": ["raft5.steady"]})
    cell = spec.cell("raft5.steady", bench)
    r = dataclasses.replace(_run_of(one_card(False), one_card()), cell=cell)
    got = run.read_metrics(r, cell.per_layer)
    # kinit encode [36, 44): the copy [40, 44) busy
    assert got["kinit_encode_idle_ms"] == {"value": pytest.approx(0.004),
                                           "unit": "ms"}
    assert got["init_idle_ms"]["value"] == pytest.approx(0.0255)


# ------------------------------------------------- the tracer on the CPU


def test_blocks_follow_the_window():
    assert [run.block_of(u) for u in (0, 1, 40, 41, 80, 81)] == [
        None, 0, 0, 1, 1, None]


def tiny(ticks: int = 8) -> spec.Cell:
    return dataclasses.replace(spec.cell("raft5.steady"), groups=4,
                               ticks=ticks)


class Profiler:
    """A stand-in for `torch.profiler.profile`."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_tracer_is_installed_in_the_second_block_alone():
    c = tiny()
    sysm = System(c.raft_fields(1), c.groups, c.ticks, c.ring, 1, ["cpu"])
    blocks = run.Blocks(sysm, Profiler)
    seen = []
    for u in range(run.PROFILE_SKIP + 2 * run.PROFILE_UNIVERSES + 3):
        blocks.before(u)
        seen.append(trace.get_tracer() is not None)
    blocks.close()
    lo = run.PROFILE_SKIP + run.PROFILE_UNIVERSES
    assert seen == [lo <= u < lo + run.PROFILE_UNIVERSES
                    for u in range(len(seen))]
    assert isinstance(blocks.session, Profiler)
    assert trace.get_tracer() is None


def test_the_programs_spans_reach_the_profilers_trace(monkeypatch):
    """Two blocks of two universes in one profiler session on the CPU (the
    plain tick in the kernel's place): the first block carries no program
    range, the second the spans the readers take."""
    monkeypatch.setattr(run, "PROFILE_UNIVERSES", 2)
    c = tiny(ticks=2)
    sysm = System(c.raft_fields(1), c.groups, c.ticks, c.ring, 1, ["cpu"])
    blocks = run.Blocks(sysm, lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    rf = torch.profiler.record_function
    for u in range(run.PROFILE_SKIP + 4):
        blocks.before(u)
        with rf(profile.UNIVERSE):
            st, m, f = sysm.init(u * c.groups)
            sysm.fetch(*sysm.prun(st, m, f)[1:])
    blocks.close()
    bare, traced = profile.split(profile.collect(blocks.session, (),
                                                 [None]), 2)
    assert len(bare.universes) == len(traced.universes) == 2
    assert all(profile.universe_program_spans(bare, lo, hi) == []
               for lo, hi in bare.universes)
    names = {n for n, _, _ in profile.top_level(traced.program_spans)}
    assert names == {"state.init", "run.metrics_init",
                     "recorder.flight_init", "prun"}
    for reader in ("init_idle_ms", "boundary_idle_ms"):
        got = profile.idle_in_spans(traced, metrics_util.module(
            reader).SPANS)
        assert len(got) == 2 and all(v > 0 for v in got)
    # no card, no launch call
    assert metrics_util.metric("host_launches_per_universe",
                               _run_of(None, traced)) is None


class Watched(System):
    """The program, noting whether a tracer is installed in each prun."""
    tracers: list = []

    def prun(self, st, m, f):
        Watched.tracers.append(trace.get_tracer())
        return super().prun(st, m, f)


@pytest.mark.parametrize("traced", [False, True])
def test_an_untraced_universe_runs_without_a_tracer(traced):
    Watched.tracers = []
    c = tiny()
    out = run.run_cell(c, SEED, 0.0, traced, devices=["cpu"],
                       system_cls=Watched, warmup=False)
    assert out["correct"] is True
    assert Watched.tracers and set(Watched.tracers) == {None}

