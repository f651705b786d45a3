"""The port's timeline tracer and heartbeat (`raft_tpu_torch.obs.trace`)
against the JAX package's `obs/trace.py`: each package's validator
accepts the other's trace; `Heartbeat.beat` on the port's recorded run
of tests/test_perf_obs.py's universe equals the reference's record on
its own, and `beat_wire` on the port's `kinit` wire equals the
reference's on `pkernel.kinit` (every key but `unix_time` and `engine`);
the port's drivers (`kernel.prun`, `kernel.krun`, `cohort.prun_streamed`)
leave exactly one chunk span per launch on the CPU, with the heartbeats
after them, and nothing with no tracer installed. Under `torch.profiler`
the installed tracer's spans are `raft_tpu_torch.` ranges on the
profiler's clock, nested as the entry points call each other
(`state.init` and `kernel.prun`; `kmesh.prun_sharded` over four CPU
shards), and a tracer without device times calls nothing of CUDA.

The reference runs `run_recorded(CFG, init, 40)` and `pkernel.kinit`,
the programs tests/test_perf_obs.py compiles."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from raft_tpu import sim as jsim
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.obs import Heartbeat as JHeartbeat
from raft_tpu.obs import run_recorded as jrun_recorded
from raft_tpu.obs import trace as jtrace
from raft_tpu.sim import pkernel
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder, trace
from raft_tpu_torch.parallel import cohort, kmesh
from raft_tpu_torch.parallel import mesh as mesh_mod
from raft_tpu_torch.sim import kernel, run, state

from jax_programs import release_jax_programs  # noqa: F401

KNOBS = dict(n_groups=8, k=3, seed=21, drop_prob=0.05, crash_prob=0.2,
             crash_epoch=16, log_cap=8, compact_every=4)
CFG, JCFG = RaftConfig(**KNOBS), JaxConfig(**KNOBS)


@pytest.fixture
def installed(tmp_path):
    """A fresh tracer and a Heartbeat(every=1), installed for the test."""
    t = trace.Tracer()
    hb = trace.Heartbeat(str(tmp_path / "hb.jsonl"), every=1)
    prev_t, prev_h = trace.set_tracer(t), trace.set_heartbeat(hb)
    try:
        yield t, tmp_path / "hb.jsonl"
    finally:
        trace.set_tracer(prev_t)
        trace.set_heartbeat(prev_h)


def _beats(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _chunks(t):
    return [e for e in t.events if e["cat"] == trace.CAT_CHUNK]


def test_each_validator_accepts_the_others_trace(installed, tmp_path):
    t, _ = installed
    with t.span("segment", cat=trace.CAT_SEGMENT, groups=8):
        leaves, g = kernel.kinit(CFG, state.init(CFG, device="cpu"))
        kernel.krun(CFG, leaves, 0, 20, 10)
    t.lane(7, "a lane")
    t.complete("placed", 1.0, 2.0, 7, cohort=0)
    obj = json.loads(open(t.save(str(tmp_path / "port.json"))).read())
    assert trace.validate_trace(obj) == [] == jtrace.validate_trace(obj)
    names = [e["name"] for e in obj["traceEvents"]]
    assert {"chunk plain [0,10)", "chunk plain [10,20)", "segment",
            "placed"} <= set(names)

    jt = jtrace.Tracer()
    prev = jtrace.set_tracer(jt)
    try:
        with jt.span("segment a", cat=jtrace.CAT_SEGMENT):
            with jtrace.chunk_span("pallas", 0, 8, phase="timed"):
                pass
        jt.instant("marker")
    finally:
        jtrace.set_tracer(prev)
    ref = jt.to_json()
    assert jtrace.validate_trace(ref) == [] == trace.validate_trace(ref)
    for bad in ({"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                                  "pid": 1, "tid": 1}]}, {"x": 1}):
        assert trace.validate_trace(bad) != [] \
            and jtrace.validate_trace(bad) != []
    assert (trace.CAT_PHASE, trace.CAT_CHUNK, trace.CAT_SEGMENT) == (
        jtrace.CAT_PHASE, jtrace.CAT_CHUNK, jtrace.CAT_SEGMENT)


def _strip(rec, *keys):
    return {k: v for k, v in rec.items() if k not in keys}


def test_beat_equals_the_reference(tmp_path):
    _, jm, jf = jrun_recorded(JCFG, jsim.init(JCFG), 40)
    _, m, f = recorder.run_recorded(CFG, state.init(CFG, device="cpu"), 40)
    for every in (1, 3):
        jhb = JHeartbeat(str(tmp_path / f"j{every}.jsonl"), every=every)
        hb = trace.Heartbeat(str(tmp_path / f"p{every}.jsonl"), every=every)
        for i in range(7):
            for flight in (jf, None):
                a = jhb.beat("soak", 40 + i, jm, flight)
                b = hb.beat("soak", 40 + i, m,
                            f if flight is not None else None)
                assert (a is None) == (b is None)
                if a is not None:
                    assert _strip(a, "unix_time") == _strip(b, "unix_time")
    rec = _beats(tmp_path / "p1.jsonl")[0]
    assert rec["ring_ticks"] == 40 and rec["safety_ok"]


def test_beat_wire_equals_the_reference(tmp_path):
    jleaves, jg = pkernel.kinit(JCFG, jsim.init(JCFG))
    leaves, g = kernel.kinit(CFG, state.init(CFG, device="cpu"))
    assert g == jg
    a = JHeartbeat(str(tmp_path / "j.jsonl"), every=2).beat_wire(
        "k", 200, JCFG, jleaves, jg)
    hb = trace.Heartbeat(str(tmp_path / "p.jsonl"), every=2)
    b = hb.beat_wire("k", 200, CFG, leaves, g)
    assert _strip(a, "unix_time", "engine") == _strip(b, "unix_time",
                                                      "engine")
    assert b["engine"] == "plain"
    assert hb.beat_wire("k", 400, CFG, leaves, g) is None
    assert hb.beat_wire("k", 600, CFG, leaves, g)["tick"] == 600


def test_beat_wire_reads_the_run_it_follows(tmp_path):
    """On a run's wire the heartbeat's counters are the wire's own, with
    the client lanes when clients run."""
    from raft_tpu_torch.analysis import bytemodel
    cfg = dataclasses.replace(bytemodel.clients_cfg(), n_groups=8)
    leaves, g = kernel.kinit(cfg, state.init(cfg, device="cpu"))
    leaves = kernel.kstep(cfg, leaves, 0, 30)
    rec = trace.Heartbeat(str(tmp_path / "hb.jsonl")).beat_wire(
        "c", 30, cfg, leaves, g)
    assert rec["rounds_total"] == kernel.kcommitted(cfg, leaves, g)
    assert rec["elections_total"] == kernel.kelections(cfg, leaves, g) > 0
    assert rec["client_acked_total"] == kernel.kacked(cfg, leaves, g)
    assert rec["client_retries_total"] == kernel.kretries(cfg, leaves, g)
    st, m = kernel.kfinish(cfg, leaves, g)
    assert rec["leaderless_groups"] == int((m.leaderless > 0).sum())
    assert rec["max_leaderless_streak"] == int(m.leaderless.max())


def test_prun_and_krun_leave_one_span_per_launch(installed):
    t, hb_path = installed
    st0 = state.init(CFG, device="cpu")
    kernel.prun(CFG, st0, 40)
    assert [e["name"] for e in _chunks(t)] == ["chunk plain [0,40)"]
    assert _chunks(t)[0]["args"] == {"engine": "plain", "t0": 0,
                                     "n_ticks": 40}
    leaves, g = kernel.kinit(CFG, st0)
    outs = []
    for at in range(0, 40, 15):
        outs.append(kernel.kstep_plain(CFG, outs[-1] if outs else leaves,
                                       at, min(15, 40 - at)))
    leaves = kernel.krun(CFG, leaves, 0, 40, 15, label="run")
    assert [e["name"] for e in _chunks(t)][1:] == [
        "chunk plain [0,15)", "chunk plain [15,30)", "chunk plain [30,40)"]
    got = [(b["tick"], b["rounds_total"]) for b in _beats(hb_path)
           if b["label"] == "run"]
    assert got == [(t1, kernel.kcommitted(CFG, o, g))
                   for t1, o in zip((15, 30, 40), outs)]
    assert [b["label"] for b in _beats(hb_path)][0] == "prun"


def test_streamed_windows_leave_one_span_per_launch(installed):
    t, hb_path = installed
    cfg = dataclasses.replace(CFG, pack_bools=True, pack_ring=True,
                              stream_groups=True, cohort_blocks=1)
    g = kernel.GB + 76   # two windows
    st0 = state.init(cfg, g, device="cpu")
    stats = {}
    st, m = cohort.prun_streamed(cfg, st0, 10, chunk_ticks=5, stats=stats,
                                 device="cpu")
    chunks = _chunks(t)
    assert stats["launches"] == len(chunks) == 4
    assert [(e["args"]["cohort"], e["args"]["t0"]) for e in chunks] \
        == [(0, 0), (0, 5), (1, 0), (1, 5)]
    names = [e["name"] for e in t.events]
    for kind in ("h2d", "compute", "d2h"):
        assert [n for n in names if n.startswith(kind)] \
            == [f"{kind} c0", f"{kind} c1"]
    beats = _beats(hb_path)
    assert [b["label"] for b in beats] == ["cuda-streamed:c0",
                                           "cuda-streamed:c1"]
    from raft_tpu_torch.sim import run
    assert sum(b["rounds_total"] for b in beats) == run.total_rounds(m)


def test_no_tracer_no_spans(tmp_path):
    assert trace.get_tracer() is None
    assert trace.chunk_span("cuda", 0, 200) is trace._NULL
    assert trace.launch_span("wire_pack cuda") is trace._NULL
    assert trace.span("x") is trace._NULL
    idle = trace.Tracer()   # made, never installed

    def body():
        st0 = state.init(CFG, device="cpu")
        kernel.prun(CFG, st0, 20)
        cfg = dataclasses.replace(CFG, stream_groups=True)
        cohort.prun_streamed(cfg, st0, 10, device="cpu")
        kmesh.prun_sharded(CFG, st0, 10, ["cpu"] * 2)
        return st0

    st0, events = _profiled(body, tmp_path)
    assert not [e for e in events if e[0].startswith(trace.RANGE_PREFIX)]
    assert [e for e in events if e[0] == "outer"]
    assert idle.events == []
    assert trace.heartbeat_wire("x", 0, CFG, kernel.kinit(CFG, st0)[0],
                                8) is None


# ------------------------------------------- program spans under a profiler


def _profiled(body, tmp_path):
    """(body's result, the profiler's complete events as (name, category,
    start, end) in microseconds) of `body` run inside a range "outer"
    under a CPU `torch.profiler`, read back from its Chrome trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            out = body()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    events = [(e["name"], e.get("cat"), float(e["ts"]),
               float(e["ts"]) + float(e["dur"]))
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    return out, events


def _tree(events) -> list:
    """Sorted (span, enclosing range) of each program range: the
    enclosing range is the shortest other user annotation around it,
    prefixes stripped."""
    def short(name):
        return name[len(trace.RANGE_PREFIX):] if name.startswith(
            trace.RANGE_PREFIX) else name
    ranges = [e for e in events if e[1] == "user_annotation"]
    out = []
    for e in ranges:
        if not e[0].startswith(trace.RANGE_PREFIX):
            continue
        around = [o for o in ranges if o is not e
                  and o[2] <= e[2] and e[3] <= o[3]
                  and o[3] - o[2] > e[3] - e[2]]
        parent = min(around, key=lambda o: o[3] - o[2])
        out.append((short(e[0]), short(parent[0])))
    return sorted(out)


def _inside(events, name, outer):
    """The events named `name` lying inside a range named `outer`."""
    spans = [e for e in events if e[0] == outer]
    return [e for e in events if e[0] == name and any(
        o[2] <= e[2] and e[3] <= o[3] for o in spans)]


PRUN_TREE = sorted([
    ("state.init", "outer"), ("run.metrics_init", "outer"),
    ("recorder.flight_init", "outer"), ("prun", "outer"),
    ("kinit", "prun"), ("run.metrics_init", "kinit"),
    ("kinit encode", "kinit"), ("chunk plain [0,20)", "prun"),
    ("kfinish", "prun"), ("kfinish overflow check", "kfinish"),
    ("kfinish decode", "kfinish"), ("kflight", "prun")])


@pytest.mark.parametrize("cfg", [CFG, dataclasses.replace(
    CFG, pack_bools=True, pack_ring=True)], ids=["plain", "packed"])
def test_spans_are_profiler_ranges_nested_as_called(cfg, tmp_path):
    """Each span of `state.init` + `kernel.prun` appears once per call,
    nested as the functions call each other, inside the caller's range
    and on the profiler's clock: `_encode`'s `aten::cat` lies inside
    `kinit encode`. The tracer's own JSON holds the same spans, and the
    gaps only there."""
    t = trace.Tracer(device_times=False)
    prev = trace.set_tracer(t)
    try:
        def body():
            st = state.init(cfg, device="cpu")
            m = run.metrics_init(cfg.n_groups, device="cpu")
            f = recorder.flight_init(cfg.n_groups, 16, device="cpu")
            return kernel.prun(cfg, st, 20, 0, m, f)
        out, events = _profiled(body, tmp_path)
    finally:
        trace.set_tracer(prev)
    assert len(out) == 3 and out[2].tick.shape == (16, cfg.n_groups)
    assert _tree(events) == PRUN_TREE
    assert _inside(events, "aten::cat", trace.RANGE_PREFIX + "kinit encode")
    own = sorted(e["name"] for e in t.events if e["cat"] != trace.CAT_GAP)
    assert own == sorted(name for name, _ in PRUN_TREE)
    assert {e["name"] for e in t.events if e["cat"] == trace.CAT_GAP} \
        == {"gap prun"}
    assert not [e for e in events if e[0].startswith(
        trace.RANGE_PREFIX + "gap")]


def _kinit_tree(n):
    return n * [("kinit", "kmesh kinit"), ("kinit encode", "kinit"),
                ("run.metrics_init", "kinit"),
                (f"chunk plain-sharded-{n}dev [0,10)", "kmesh prun")]


def _kfinish_tree(parent):
    return [("kfinish", parent), ("kfinish overflow check", "kfinish"),
            ("kfinish decode", "kfinish"), ("kflight", parent)]


@pytest.mark.parametrize("shards_in", [False, True],
                         ids=["whole", "shards"])
def test_sharded_run_spans_nest(shards_in, tmp_path):
    """`kmesh.prun_sharded` over four CPU shards: `kmesh cut`, `kmesh
    kinit` (a `kinit` a shard), a chunk span a shard, then `kmesh
    gather` and `kmesh finish` (whole State in: one `kfinish` and
    `kflight`), or `kmesh finish` alone (shards in: one of each a
    shard), all inside `kmesh prun`."""
    devices = ["cpu"] * 4
    st = state.init(CFG, device="cpu")
    if shards_in:
        st = mesh_mod.shard_state(st, mesh_mod.make_mesh(devices=devices))
    m = run.metrics_init(CFG.n_groups, device="cpu")
    f = recorder.flight_init(CFG.n_groups, 16, device="cpu")
    prev = trace.set_tracer(trace.Tracer(device_times=False))
    try:
        out, events = _profiled(
            lambda: kmesh.prun_sharded(CFG, st, 10, devices, 0, m, f),
            tmp_path)
    finally:
        trace.set_tracer(prev)
    assert len(out) == 3
    finish = (4 * _kfinish_tree("kmesh finish") if shards_in else
              [("kmesh gather", "kmesh prun")]
              + _kfinish_tree("kmesh finish"))
    assert _tree(events) == sorted(
        [("kmesh prun", "outer"), ("kmesh cut", "kmesh prun"),
         ("kmesh kinit", "kmesh prun"), ("kmesh finish", "kmesh prun")]
        + _kinit_tree(4) + finish)


def test_tracer_without_device_times_calls_no_cuda(monkeypatch):
    """With `torch.cuda`'s events, streams and synchronize made to
    raise, a tracer without device times runs chunk and launch spans on
    a card's name and whole CPU runs untouched, and keeps no device
    time; a tracer with them trips the first call."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA call")

    for name in ("Event", "synchronize", "current_stream", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    t = trace.Tracer(device_times=False)
    prev = trace.set_tracer(t)
    try:
        with trace.chunk_span("cuda", 0, 200, "cuda:0") as args:
            pass
        with trace.launch_span("wire_pack cuda", "cuda:0", groups=8):
            pass
        st = state.init(CFG, device="cpu")
        kernel.prun(CFG, st, 20)
        kmesh.prun_sharded(CFG, st, 10, ["cpu"] * 4)
    finally:
        trace.set_tracer(prev)
    assert args == {"engine": "cuda", "t0": 0, "n_ticks": 200}
    assert not [e for e in t.events if "device_ms" in e.get("args", {})]
    trace.set_tracer(trace.Tracer())
    try:
        with pytest.raises(AssertionError, match="a CUDA call"):
            with trace.chunk_span("cuda", 0, 200, "cuda:0"):
                pass
    finally:
        trace.set_tracer(prev)
