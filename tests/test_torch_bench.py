"""bench_torch.py (the port's bench) against bench.py, both on the CPU at
tiny shapes: `CHUNK` and the shapes of both modules shrunk with
monkeypatch (bench.py itself unchanged), the port's plain engine in the
kernel's place (`--device cpu`), the JAX side's manifest in a temp file
(`RAFT_TPU_MANIFEST`). Tolerance 0 on every compared value.

- the reference halves: `_timed_chunks`' count, State, Metrics and
  Flight, and the end-point trees after the one-chunk extension;
- bench_throughput and bench_fault_latency (config-4): equal values on
  every key but those listed in `NOT_COMPARED`, each with its reason;
- the knee choice and `_pressure_fields` on the same load points;
- the JSON line's keys are bench.py's (read with `ast`), through
  `RENAMES`, plus `power_limit_w`; `_wall_fields` is the one producer of
  SEGMENT_WALL_KEYS;
- no fallback: a planted mismatch nulls the rate, names the engine
  "none (cuda mismatch!)" and exits 1 after the line; no card and no
  `--device cpu` exits 2;
- the mesh and cohort-streaming twins give the resident engine's
  values.

The JAX half runs in a child process (tests/bench_reference_half.py),
started when the module starts, so its two XLA compiles overlap the
port's runs; the tests that read it come last."""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import inspect
import io
import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from jax_programs import release_jax_programs  # noqa: F401
from raft_tpu import nemesis as jnemesis
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim.run import total_rounds as jtotal_rounds
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.sim import state

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402
import bench_torch  # noqa: E402

# One chunk of reference warmup, one timed chunk and one extension: the
# kernel's timed window [2C, 3C) is then the JAX reference's extension
# chunk, so its count is comparable.
C, G = 16, 8
# config-4 from tick 0 over two chunks: the initial elections complete.
FAULT_TICKS = 2 * C
CPU_CARD = {"device": "cpu", "power_limit_w": None}

# Keys of a segment dict not compared, and why.
NOT_COMPARED = {
    # host walls of two engines on two frameworks
    "timed_wall_s", "xla_wall_s", "xla_warmup_wall_s", "kernel_wall_s",
    "kernel_warmup_wall_s",
    # rates divide counts by those walls
    "rounds_per_sec", "pallas_rounds_per_sec", "pallas_ms_per_tick",
    # the engine that stood: bench.py's XLA scan off the TPU, the port's
    # plain tick in the kernel's place
    "engine",
    # None in bench.py off the TPU (no kernel ran); the port's gate
    "state_identical", "metrics_identical", "flight_identical",
    # the roofline's predicted side: TPU peaks and XLA cost analysis
    # against the H100's peaks and the run's own operations
    "predicted_rounds_per_sec", "attainment_pct", "bound", "roofline",
}


def as_np(tree, jax_side: bool):
    return (jax.tree.map(np.asarray, tree) if jax_side
            else state.to_numpy(tree))


def same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(as_np(jax_tree, True),
                              as_np(torch_tree, False))
    assert ok, f"{what}: {why}"


def wrap(mp, module, name, sink):
    """Record the arguments and result of module.name in `sink`."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        out = orig(*args, **kw)
        sink.append((args, out))
        return out

    mp.setattr(module, name, rec)


@pytest.fixture(scope="module", autouse=True)
def jax_half(tmp_path_factory):
    """bench.py's bench_throughput(G, C) and bench_fault_latency(43, G,
    2C) in a child process, started now; `result()` waits for it and
    loads its pickle."""
    out = tmp_path_factory.mktemp("jax") / "half.pkl"
    err = open(str(out) + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "bench_reference_half.py"),
         str(C), str(G), str(FAULT_TICKS), str(out)],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=err)
    loaded = {}

    class Half:
        @staticmethod
        def result():
            if not loaded:
                rc = proc.wait(timeout=600)
                assert rc == 0, Path(err.name).read_text()[-4000:]
                with open(out, "rb") as fh:
                    loaded.update(pickle.load(fh))
            return loaded

    try:
        yield Half
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        err.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's bench_throughput(G, C) and bench_fault_latency(43, G,
    2C), with `_timed_chunks`' result and the gate's inputs recorded."""
    tmp = tmp_path_factory.mktemp("bench")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp, tmp)
        timed, gates = [], []
        wrap(mp, bench_torch, "_timed_chunks", timed)
        wrap(mp, bench_torch, "_differential", gates)
        out["throughput"] = bench_torch.bench_throughput(G, C)
        out["timed"] = timed[0][1]
        out["config-4"] = bench_torch.bench_fault_latency(
            43, G, FAULT_TICKS, "config-4 fault run")
        out["gates"] = gates
        out["manifest"] = [json.loads(ln) for ln in
                           (tmp / "m.jsonl").read_text().splitlines()]
    return out


def _tiny(mp, tmp, **dials):
    mp.setattr(bench_torch, "CHUNK", C)
    mp.setattr(bench_torch, "_DEVICE", torch.device("cpu"))
    mp.setattr(bench_torch, "_MANIFEST", str(tmp / "m.jsonl"))
    mp.setattr(bench_torch, "_CARD", CPU_CARD)
    mp.setattr(bench_torch, "_WIRE_DIALS", dials)


def test_manifest_records_carry_card_and_stamp(runs):
    recs = runs["manifest"]
    assert [r["segment"] for r in recs] == ["throughput",
                                            "config-4 fault run"]
    for r in recs:
        assert r["device"] == "cpu" and r["power_limit_w"] is None
        assert r["attainment_pct"] is None and r["bound"] in (
            "bytes", "operations")
        assert r["roofline"]["ops_per_tick"] > 0


def _bench_py_knee(points):
    """bench.py's knee rule, as written at bench.py:1313-1315."""
    knee = None
    for pt in points:
        if pt["slo_ok"] and pt["safety_ok"] and (
                knee is None or pt["ops_per_sec"] > knee["ops_per_sec"]):
            knee = pt
    return knee


POINTS = [
    {"offered_rate": 0.05, "ops_per_sec": 10.0, "shed_rate": 0.0,
     "slo_ok": True, "safety_ok": True},
    {"offered_rate": 0.1, "ops_per_sec": 30.0, "shed_rate": 0.01,
     "slo_ok": True, "safety_ok": True},
    {"offered_rate": 0.2, "ops_per_sec": 30.0, "shed_rate": 0.02,
     "slo_ok": True, "safety_ok": True},    # ties keep the first
    {"offered_rate": 0.35, "ops_per_sec": 50.0, "shed_rate": 0.2,
     "slo_ok": False, "safety_ok": True},   # misses the SLO
    {"offered_rate": 0.5, "ops_per_sec": 70.0, "shed_rate": 0.03,
     "slo_ok": True, "safety_ok": False},   # unsafe
]


@pytest.mark.parametrize("points", [POINTS, POINTS[3:], []],
                         ids=["ladder", "none-meets", "empty"])
def test_knee_and_pressure_fields_match_bench_py(points):
    knee = bench_torch._knee(points)
    assert knee is _bench_py_knee(points)
    jcfg = JaxConfig(seed=49, nemesis=jnemesis.pressure_mix(600))
    cfg = bench_torch.pressure_cfg(49, 600)
    assert bench_torch._pressure_fields(cfg, knee) == \
        bench._pressure_fields(jcfg, knee)
    assert (bench_torch.PRESSURE_RATES, bench_torch.PRESSURE_QUEUE_CAP,
            bench_torch.PRESSURE_ACK_SLO_TICKS,
            bench_torch.PRESSURE_SHED_SLO) == (
        bench.PRESSURE_RATES, bench.PRESSURE_QUEUE_CAP,
        bench.PRESSURE_ACK_SLO_TICKS, bench.PRESSURE_SHED_SLO)


def test_segment_configs_are_bench_py_knobs():
    """Each factory's config is the one bench.py builds (bench.py:765,
    :820, :916, :1005, :1052, :1108, :1248), field for field."""
    def fields(c):
        d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
        d["nemesis"] = [tuple(x) for x in d["nemesis"]]
        return d

    pairs = [
        (bench_torch.throughput_cfg(), JaxConfig(seed=42)),
        (bench_torch.fault_cfg(46), JaxConfig(
            seed=46, crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
            partition_epoch=64, drop_prob=0.02)),
        (bench_torch.election_cfg(), JaxConfig(
            seed=44, cmds_per_tick=0, crash_prob=0.5, crash_epoch=32)),
        (bench_torch.reads_cfg(), JaxConfig(seed=45, read_every=4)),
        (bench_torch.clients_cfg(47), JaxConfig(
            seed=47, sessions=True, cmds_per_tick=0, client_rate=0.2,
            client_slots=4, client_retry_backoff=8, crash_prob=0.3,
            crash_epoch=64, partition_prob=0.2, partition_epoch=64,
            drop_prob=0.02)),
        (bench_torch.nemesis_cfg(48, 600), JaxConfig(
            seed=48, crash_prob=0.1, crash_epoch=64, drop_prob=0.02,
            nemesis=jnemesis.gray_mix(600))),
        (bench_torch.pressure_cfg(49, 600, 0.35), JaxConfig(
            seed=49, sessions=True, cmds_per_tick=0, client_rate=0.35,
            client_slots=4, client_retry_backoff=8, client_queue_cap=8,
            nemesis=jnemesis.pressure_mix(600))),
    ]
    for mine, ref in pairs:
        assert fields(mine) == fields(ref)
    full = bench_torch.SHAPES["full"]
    assert (full["throughput"], full["config-4"], full["config-5"],
            full["election-rounds"], full["reads"], full["clients"],
            full["nemesis"], full["pressure"]) == (
        (100_000, 600), (50_000, 600), (100_000, 600), (10_000, 2400),
        (50_000, 600), (50_000, 600), (50_000, 600), (20_000, 600))
    assert set(bench_torch.SHAPES["quick"].values()) == {(1_000, 200)}
    assert bench_torch.CHUNK == bench.CHUNK == 200


def _json_keys_of_bench_py() -> set:
    """The keys of the dict bench.py's main prints (`print(json.dumps(
    {...}))`), read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print" and node.args
                and isinstance(node.args[0], ast.Call)
                and isinstance(node.args[0].args[0], ast.Dict)):
            return {k.value for k in node.args[0].args[0].keys}
    raise AssertionError("bench.py prints no JSON dict")


def test_wall_fields_one_producer():
    assert bench_torch.SEGMENT_WALL_KEYS == tuple(
        bench_torch.RENAMES.get(k, k) for k in bench.SEGMENT_WALL_KEYS)
    vals = (1.23456, 2.0, 3.0004, None, 5.0)
    mine = bench_torch._wall_fields(*vals)
    assert tuple(mine) == bench_torch.SEGMENT_WALL_KEYS
    assert list(mine.values()) == list(bench._wall_fields(*vals).values())
    # Every segment function routes through the one producer and writes
    # no wall key of its own.
    for fn in (bench_torch.bench_throughput, bench_torch.bench_fault_latency,
               bench_torch.bench_election_rounds, bench_torch.bench_reads,
               bench_torch.bench_clients, bench_torch.bench_nemesis,
               bench_torch.bench_pressure, bench_torch._full_run_fields):
        src = inspect.getsource(fn)
        assert "_wall_fields(" in src or "_full_run_fields(" in src, \
            fn.__name__
        assert not any(f'"{k}":' in src
                       for k in bench_torch.SEGMENT_WALL_KEYS), fn.__name__


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """main() at 4 groups x 8 ticks on the CPU, the kernel-side State of
    the throughput segment perturbed in one leaf before its gate."""
    tmp = tmp_path_factory.mktemp("main")
    orig = bench_torch._differential

    def perturbed(label, ref, got):
        if label == "rounds":
            st = got[0]
            term = st.nodes.term.clone()
            term[0, 0] += 1
            got = (st._replace(nodes=st.nodes._replace(term=term)),
                   *got[1:])
        return orig(label, ref, got)

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "CHUNK", 8)
        mp.setitem(bench_torch.SHAPES, "quick",
                   {n: (4, 8) for n in bench_torch.SEGMENTS})
        mp.setattr(bench_torch, "_differential", perturbed)
        mp.setattr(bench_torch, "_DEVICE", bench_torch._DEVICE)
        mp.setattr(bench_torch, "_MANIFEST", bench_torch._MANIFEST)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench_torch.main(["--device", "cpu", "--quick",
                                   "--manifest", str(tmp / "m.jsonl")])
    return (rc, out.getvalue(), err.getvalue()), [
        json.loads(ln) for ln in (tmp / "m.jsonl").read_text().splitlines()]


def test_planted_mismatch_nulls_the_rate_and_exits_1(planted):
    (rc, stdout, stderr), recs = planted
    assert rc == 1, stderr[-3000:]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["pallas_rounds_per_sec"] is None
    assert line["engine"] == bench_torch.MISMATCH_ENGINE
    assert line["throughput_state_identical"] is False
    assert not line["engine"].startswith("cuda")
    assert "DIFFERENTIAL MISMATCH" in stderr
    assert ".nodes.term" in stderr
    assert "rounds:plain-ref] flight recorder" in stderr
    assert "rounds:cuda] flight recorder" in stderr
    # The other segments stood, each held to its plain run.
    for key in ("config4", "config5_fault", "config2", "reads", "client",
                "nemesis", "pressure"):
        assert line[f"{key}_engine"] == "plain-cpu", key
        assert line[f"{key}_state_identical"] is True, key
    tp = recs[0]
    assert tp["segment"] == "throughput" and tp["rounds_per_sec"] is None
    assert tp["engine"] == bench_torch.MISMATCH_ENGINE
    assert len(recs) == 8 and line["device"] == "cpu"


def test_json_line_keys_are_bench_py_through_the_renames(planted):
    (_, stdout, _), _ = planted
    line = json.loads(stdout.strip().splitlines()[-1])
    want = _json_keys_of_bench_py()
    assert set(bench_torch.RENAMES) <= want | set(bench.SEGMENT_WALL_KEYS)
    assert set(line) == {bench_torch.RENAMES.get(k, k)
                         for k in want} | {"power_limit_w"}
    assert not any("xla" in k for k in line)


def test_no_card_exits_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the bench would run")
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           "--quick"], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


def test_kernel_refusal_raises(monkeypatch):
    """A shape the kernel cannot run on the card raises: no plain number
    stands in for it."""
    monkeypatch.setattr(bench_torch, "_on_card", lambda: True)
    monkeypatch.setattr(bench_torch, "_kernel_mesh", lambda: None)
    monkeypatch.setattr(bench_torch.kernel, "supported",
                        lambda *a, **k: False)
    monkeypatch.setattr(bench_torch.kernel, "hbm_budget", lambda d=None: 7)
    with pytest.raises(ValueError, match="cannot run 1000 groups"):
        bench_torch._kernel_engine(bench_torch.throughput_cfg(), 1000)


def test_launch_error_propagates_after_the_trace_is_saved(tmp_path,
                                                          monkeypatch):
    """A kernel error is not caught (bench.py's "xla stands" is gone):
    main raises it, after its `finally` has saved the trace."""
    def broken(cfg, n_groups):
        raise RuntimeError("fused_chunk launch failed: bad argument")

    monkeypatch.setattr(bench_torch, "CHUNK", 8)
    monkeypatch.setitem(bench_torch.SHAPES, "quick",
                        {n: (4, 8) for n in bench_torch.SEGMENTS})
    monkeypatch.setattr(bench_torch, "_kernel_engine", broken)
    for name in ("_DEVICE", "_MANIFEST", "_TRACE_PATH", "_CARD"):
        monkeypatch.setattr(bench_torch, name, getattr(bench_torch, name))
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(RuntimeError, match="launch failed"):
            bench_torch.main(["--device", "cpu", "--quick", "--manifest",
                              str(tmp_path / "m.jsonl"), "--trace-dir",
                              str(tmp_path / "tr")])
    assert out.getvalue() == ""   # no JSON line
    trace = json.loads((tmp_path / "tr" / "trace_bench.json").read_text())
    assert any(e["name"] == "throughput" for e in trace["traceEvents"])
    assert not (tmp_path / "m.jsonl").exists()


@pytest.mark.parametrize("twin", ["mesh", "stream"])
def test_mesh_and_stream_twins_match_the_resident_engine(runs, twin,
                                                         tmp_path):
    """The sharded engine (two CPU shards in place of two cards) and the
    cohort scheduler give the resident engine's values, each held to
    the plain tick."""
    with pytest.MonkeyPatch.context() as mp:
        if twin == "mesh":
            _tiny(mp, tmp_path)
            mp.setattr(bench_torch, "_kernel_mesh",
                       lambda: (torch.device("cpu"),) * 2)
        else:
            _tiny(mp, tmp_path, stream_groups=True, cohort_blocks=1)
        tp = bench_torch.bench_throughput(G, C)
        c4 = bench_torch.bench_fault_latency(43, G, FAULT_TICKS,
                                             "config-4 fault run")
    want_eng = ("plain-sharded-2dev" if twin == "mesh"
                else "plain-cpu-streamed")
    for seg, ref in ((tp, runs["throughput"]), (c4, runs["config-4"])):
        assert seg["engine"] == want_eng
        assert seg["state_identical"] and seg["metrics_identical"] \
            and seg["flight_identical"]
        for k in ("rounds", "elections", "p50", "p99", "max_lat",
                  "unsafe_groups"):
            if k in ref:
                assert seg[k] == ref[k], (twin, k)
    assert tp["mesh_shape"] == ([2] if twin == "mesh" else [1])
    if twin == "stream":
        assert tp["stream_groups"] and tp["overlap_efficiency_measured"] \
            is not None


# ------------------------------------------- against the JAX half (last)


def test_reference_halves_equal(runs, jax_half):
    """`_timed_chunks` on both sides: the same count over [C, 2C), the
    same State, Metrics and Flight at 2C."""
    j, t = jax_half.result()["timed"], runs["timed"]
    assert t[1] == j[1] > 0 and t[3] == j[3] == C
    for i, what in ((5, "state"), (6, "metrics"), (7, "flight")):
        same(j[i], t[i], f"_timed_chunks {what}")


def test_extension_end_point_equal(runs, jax_half):
    """The port's reference extended to the kernel's end tick 3C equals
    the JAX reference extended the same way (bench.py:439-441), and the
    kernel-side trees equal both."""
    half = jax_half.result()
    ext, m = half["extended"], half["timed"][6]
    (label, ref, got), _ = runs["gates"][0]
    assert label == "rounds"
    for jt, rt, kt, what in zip(ext, ref, got, ("state", "metrics",
                                                "flight")):
        same(jt, rt, f"extended reference {what}")
        same(jt, kt, f"kernel-side {what}")
    # The published count is the kernel's over [2C, 3C): the JAX
    # reference's extension chunk.
    assert runs["throughput"]["rounds"] == \
        jtotal_rounds(ext[1]) - jtotal_rounds(m) > 0


@pytest.mark.parametrize("name", ["throughput", "config-4"])
def test_segment_values_equal(runs, jax_half, name):
    j, t = jax_half.result()[name], runs[name]
    assert {bench_torch.RENAMES.get(k, k) for k in j} == set(t)
    # bench.py publishes its reference count off the TPU, over [C, 2C);
    # the port the kernel's over [2C, 3C), held to the JAX extension in
    # test_extension_end_point_equal.
    skip = NOT_COMPARED | ({"rounds"} if name == "throughput" else set())
    want = {k: v for k, v in j.items() if k not in skip}
    assert want == {k: t[k] for k in want}
    if name == "config-4":
        assert t["elections"] > 0 and t["rounds"] > 0
    assert t["engine"] == "plain-cpu" and t["state_identical"] \
        and t["metrics_identical"] and t["flight_identical"]
