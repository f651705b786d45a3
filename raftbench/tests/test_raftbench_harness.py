"""The harness on the CPU at tiny sizes: the data files load by name, the
names and units keep the benchmark's character rules, the universe loop
runs end to end with the program's plain tick in the kernel's place, and
the per-layer readers take a device timeline apart as they should.

    python -m pytest raftbench/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys

import pytest

from raftbench import check, profile, run, spec

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 5


def problems(bench: dict) -> list:
    """What in `bench` breaks the benchmark's naming and file rules."""
    out = []

    def name(v, what):
        if not isinstance(v, str) or not NAME_RE.match(v):
            out.append(f"{what}: bad name {v!r}")

    metrics = bench["end_to_end"] + bench["per_layer"]
    for kind, items in (("config", bench["configs"]),
                        ("workload", bench["workloads"]),
                        ("metric", metrics)):
        names = [i["name"] for i in items]
        if len(set(names)) != len(names):
            out.append(f"{kind}: duplicate names")
        for n in names:
            name(n, kind)
    for c in bench["configs"]:
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
        f = spec.ROOT / c["file"]
        if not f.is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
    for w in bench["workloads"]:
        name(w["config"], f"workload {w['name']} config")
        name(w["traffic"], f"workload {w['name']} traffic")
        if not (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic file")
    for m in metrics:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better {m['better']!r}")
        if not (spec.HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader")
    return out


def tiny(name: str, ticks: int = 24) -> spec.Cell:
    c = spec.cell(name)
    return dataclasses.replace(c, groups=6 * c.chips, ticks=ticks)


def test_benchmark_keeps_its_naming_and_file_rules():
    assert problems(BENCH) == []
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for key in ("source", "why"):
            assert 1 <= len(c[key]) <= 200 and "\n" not in c[key]
        assert c["file"].startswith("raftbench/")
        conf = spec.config_file(BENCH, c["name"])
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        for w in m.get("workloads", CELLS):
            # every cell a per-layer metric is read in reports the
            # end-to-end metric it moves
            assert m["moves"] in {e["name"] for e in spec.cell(w).end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_files_load_by_name(name):
    c = spec.cell(name)
    assert c.groups == spec.config_file(
        BENCH, c.config)["groups_per_chip"] * c.chips
    assert {"seed"} | set(c.fields) == set(c.raft_fields(1))
    assert c.ticks == 600 and c.ring == 64
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and len(c.per_layer) >= 1
    for m in c.end_to_end + c.per_layer:
        assert callable(run.metrics_util.module(m["name"]).read)


def test_dials_are_refused_in_the_data_files(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "t.json").write_text(json.dumps(
        {"why": "x", "raft": {"pack_bools": True}, "ticks_per_universe": 8,
         "flight_ring": 64}))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    bench = dict(BENCH, workloads=[{"name": "c", "config": "raft5",
                                    "traffic": "t", "chips": 1,
                                    "why": "x"}])
    with pytest.raises(ValueError, match="not semantic"):
        spec.cell("c", bench)


def test_seed_of_any_size_maps_to_a_u32():
    assert spec.config_seed(2 ** 31 + 5) == 2 ** 31 + 5
    assert spec.config_seed(2 ** 32 + 5) == 5
    assert 0 <= spec.config_seed(-1) < 2 ** 32


def test_universe_seeds_are_drawn_from_the_run_seed():
    seeds = spec.universe_seeds(SEED)
    assert seeds == spec.universe_seeds(SEED)
    assert len(set(seeds)) == spec.SEEDS_PER_RUN
    assert all(0 <= s < 2 ** 32 for s in seeds)
    assert seeds != spec.universe_seeds(SEED + 1)
    recs = [{"seed": 5, "group_ids": [1, 2]}, {"seed": 5, "group_ids": [7]},
            {"seed": 9, "group_ids": [3]}]
    assert check.batches(recs) == [(5, [1, 2, 7]), (9, [3])]
    parts = check.jobs([({"seed": 5}, [1, 2, 7]), ({"seed": 9}, [3])], 2)
    assert [ids for _, ids in parts] == [[1, 2], [7], [3]]
    assert [f["seed"] for f, _ in parts] == [5, 5, 9]


@pytest.mark.parametrize("name", CELLS)
def test_universe_loop_runs_end_to_end_on_the_cpu(name):
    c = tiny(name)
    out = run.run_cell(c, SEED, 1.0, False, devices=["cpu"] * c.chips)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"]["groups_compared"]["value"] == min(
        out["attempted"], check.MAX_UNIVERSES) * check.SAMPLES_PER_UNIVERSE
    assert out["device"]["count"] == c.chips


def test_traced_run_without_a_card_reports_no_device_metric():
    c = tiny("raft5.steady")
    out = run.run_cell(c, SEED, 0.5, True, devices=["cpu"])
    assert out["correct"] is True
    assert out["metrics"] == {}
    assert "breakdown" not in out and "busy_s" not in out["device"]


def test_sampling_is_drawn_from_the_seed():
    a = check.positions(SEED, 3, 100_000)
    assert (a == check.positions(SEED, 3, 100_000)).all()
    assert not (a == check.positions(SEED + 1, 3, 100_000)).all()
    assert check.judged(SEED, 5) == [0, 1, 2, 3, 4]
    many = check.judged(SEED, 1000)
    assert len(many) == check.MAX_UNIVERSES == len(set(many))
    assert many == check.judged(SEED, 1000)


def test_without_a_card_the_command_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "raftbench.run", "--workload",
                        "raft5.steady", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=spec.ROOT, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


# ------------------------------------------------------ the trace readers


def _event(name, cat, ts, dur, device=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def _timeline(devices=(0,)):
    """Two universes of 100 us; in each, a port kernel of 60 us on every
    card (the second card's ending 5 us later) and a copy of 10 us."""
    evs = []
    for u, t in enumerate((0.0, 200.0)):
        evs.append(_event("raftbench.universe", "user_annotation", t, 100))
        evs.append(_event("raftbench.prun", "user_annotation", t + 10, 70))
        evs.append(_event("raftbench.fetch", "user_annotation", t + 80, 20))
        for d in devices:
            evs.append(_event("void fused_chunk_kernel<true>(int const*)",
                              "kernel", t + 15 + 5 * d, 60, d))
        evs.append(_event("Memcpy DtoH", "gpu_memcpy", t + 85, 10, 0))
    obj = {"traceEvents": evs}
    return profile.read_chrome_trace(obj, ("fused_chunk_kernel",),
                                     list(devices))


def _run_with(tl, roof=None):
    c = spec.cell("raft5.steady")
    return run.Run(cell=c, setup_s=1.0, window_s=1.0,
                   walls_ms=[0.1, 0.1], group_ticks=1, timeline=tl,
                   roofline=roof)


def test_readers_take_a_timeline_apart():
    r = _run_with(_timeline(), {"seconds": 0.03e-3})
    m = run.metrics_util.metric
    assert m("kernel_ms_per_universe", r) == pytest.approx(0.06)
    assert m("kernel_roofline_pct", r) == pytest.approx(50.0)
    # window: the two universes, 200 us; busy 2 x (60 + 10) us
    assert m("device_idle_pct", r) == pytest.approx(100 * (1 - 140 / 200))
    assert m("outside_kernel_p90_ms", r) == pytest.approx(0.04)
    assert m("shard_spread_ms", r) is None
    bd = profile.breakdown(r.timeline)
    assert bd["device_ops"][0] == ["fused_chunk_kernel<true>",
                                   pytest.approx(120e-6)]
    # each universe: idle 0-10 (no span), 10-15 and 75-80 (prun), 80-85
    # and 95-100 (fetch); the 100 us between the universes is not the
    # program's
    labels = dict((k, v) for k, v in bd["idle_gaps"])
    assert labels == {"universe": pytest.approx(20e-6),
                      "prun": pytest.approx(20e-6),
                      "fetch": pytest.approx(20e-6)}


def test_shard_spread_reads_the_last_card_against_the_first():
    r = _run_with(_timeline(devices=(0, 1, 2, 3)))
    assert run.metrics_util.metric("shard_spread_ms", r) == pytest.approx(
        0.015)
    # kernel time is the union over cards: 15 + 60 + 15 us a universe
    assert run.metrics_util.metric("kernel_ms_per_universe", r) == \
        pytest.approx(0.075)


def test_readers_find_nothing_without_a_timeline():
    r = _run_with(None)
    for m in BENCH["per_layer"]:
        assert run.metrics_util.metric(m["name"], r) is None


def test_port_kernel_names_come_from_the_programs_sources():
    from raftbench.system import System
    names = profile.port_kernel_names(System.CSRC)
    assert "fused_chunk_kernel" in names
    assert "__launch_bounds__" not in names
