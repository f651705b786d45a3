"""The benchmark's one-card cells under faults, `etcd5.ops-jepsen` (the
all-features build: PreVote, leader transfer, membership change,
ReadIndex reads, a heartbeat every tick) and `raft5.jepsen` (the base
build), and what the program counts of the features.

- Both cells resolve through `raftbench.spec.cell`, and a few-group
  universe of each through `raftbench.system.System` on the CPU equals
  the frozen reference (`raftbench/reference/`) leaf for leaf.
- `run.feature_counts`, `kernel.kmembership_changed` and the
  heartbeat's `reads_done_total` / `membership_changed_groups` agree on
  a universe where every feature fires, and are absent without them; a
  traced launch of the kernel names its build.
- The cells report the one-card end-to-end entries, and each `.faults`
  per-layer metric reads what its one-card metric reads and moves an
  end-to-end entry that lists the same cells.

    python -m pytest tests/test_torch_fault_cells.py -q
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder, trace
from raft_tpu_torch.sim import kernel, run as run_mod, state
from raftbench import metrics_util, profile, refworker, roofline, run, spec
from raftbench.runner import tree_leaves
from raftbench.system import System

SEED = 2 ** 31 + 77   # more than 32 signed bits hold
CELLS = ("etcd5.ops-jepsen", "raft5.jepsen")
END_TO_END = ("group_ticks_per_s", "universe_p90_ms")
FAULTS = ("kernel_ms_per_universe", "kernel_roofline_pct", "device_idle_pct",
          "boundary_idle_ms")
ALL_FEATURES = "prevote+transfer+reconfig+reads"
# etcd5.ops-jepsen's fields with every epoch at 16 ticks, so that each
# feature fires inside 64 ticks (tests/test_torch_features.py's case)
EPOCHS = dict(transfer_epoch=16, reconfig_epoch=16, crash_epoch=16,
              partition_epoch=16)


def _cfg(cell: str, **kw) -> RaftConfig:
    return RaftConfig(**dict(spec.cell(cell).fields, seed=71, **kw))


# ------------------------------------------------------------- the cells


@pytest.mark.parametrize("name", CELLS)
def test_the_cell_resolves(name):
    c = spec.cell(name)
    assert (c.chips, c.groups, c.ticks, c.ring) == (1, 100_000, 600, 64)
    assert {m["name"] for m in c.end_to_end} == {
        "setup_s", *END_TO_END}
    assert {m["name"] for m in c.per_layer} == {n + ".faults" for n in FAULTS}
    cfg = RaftConfig(n_groups=c.groups, **c.raft_fields(1))
    flags = kernel.flag_name(kernel.features(cfg))
    assert flags == (ALL_FEATURES if name.startswith("etcd5") else "base")
    # resident on one card with room to spare (an H100 has 80 GB)
    assert kernel.supported(cfg, c.groups, ring=c.ring, hbm=16 * 2 ** 30)


def test_etcd5_is_etcds_settings():
    conf = spec.config_file(spec.load_benchmark(), "etcd5")
    assert conf["raft"] == dict(k=5, heartbeat_every=1, election_min=10,
                                election_range=10, log_cap=32,
                                max_entries_per_msg=4, compact_every=8,
                                prevote=True)
    assert conf["reduced"] == [] and conf["groups_per_chip"] == 100_000
    fields = spec.cell("etcd5.ops-jepsen").fields
    assert fields["read_every"] == 1 and fields["cmds_per_tick"] == 1


def _flat(st, m, f) -> dict:
    out = {"state." + k: v.numpy() for k, v in tree_leaves(st).items()}
    out.update({"metrics." + k: v.numpy() for k, v in tree_leaves(m).items()
                if k in refworker.PER_GROUP_LANES})
    out.update({"flight." + k: v.numpy() for k, v in tree_leaves(f).items()})
    return out


@pytest.mark.parametrize("name", CELLS)
def test_a_universe_of_the_cell_equals_the_reference(name):
    c = dataclasses.replace(spec.cell(name), groups=5, ticks=40)
    fields = c.raft_fields(spec.universe_seeds(SEED)[3])
    sysm = System(fields, c.groups, c.ticks, c.ring, 1, ["cpu"])
    first = 3 * c.groups
    got = _flat(*sysm.prun(*sysm.init(first)))
    want = refworker.reference_run(fields, c.ticks, c.ring,
                                   list(range(first, first + c.groups)))
    leaves = [k for k in want if k not in ("ops", "group_bytes")]
    assert sorted(got) == sorted(leaves)
    for k in leaves:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["metrics.safety"].all()


# ------------------------------------------- what the features leave


def _features_run(cfg: RaftConfig, tmp_path: Path, ticks: int = 64):
    """The kernel path on the CPU with a heartbeat and a tracer installed:
    (the beat_wire record, the wire pair, State, Metrics, Flight, the
    tracer)."""
    hb = trace.Heartbeat(str(tmp_path / f"hb{cfg.seed}.jsonl"), every=1)
    t = trace.Tracer(device_times=False)
    prev_h, prev_t = trace.set_heartbeat(hb), trace.set_tracer(t)
    try:
        st0 = state.init(cfg, device="cpu")
        m0 = run_mod.metrics_init(cfg.n_groups, device="cpu")
        f0 = recorder.flight_init(cfg.n_groups, 64, device="cpu")
        leaves, g = kernel.kinit(cfg, st0, m0, f0)
        leaves = kernel.krun(cfg, leaves, 0, ticks, label="faults",
                             engine="cuda")
        st, m = kernel.kfinish(cfg, leaves, g, m0)
        f = kernel.kflight(cfg, leaves, g)
        beat = trace.heartbeat("plain", ticks, m, f, cfg, st)
    finally:
        trace.set_heartbeat(prev_h)
        trace.set_tracer(prev_t)
    wire_beat = [json.loads(x) for x in (tmp_path / f"hb{cfg.seed}.jsonl")
                 .read_text().splitlines()][0]
    return wire_beat, beat, leaves, g, st, t


def test_feature_counts_and_heartbeat_with_every_feature(tmp_path):
    cfg = _cfg("etcd5.ops-jepsen", n_groups=6, **EPOCHS)
    wire_beat, beat, leaves, g, st, t = _features_run(cfg, tmp_path)
    counts = run_mod.feature_counts(cfg, st)
    assert counts["reads_done_total"] == kernel.kreads(cfg, leaves, g) > 0
    assert 0 < counts["membership_changed_groups"] == int(
        run_mod.membership_changed(cfg, st).sum()) == \
        kernel.kmembership_changed(cfg, leaves, g)
    assert counts["top_term"] == int(st.nodes.term.max()) > 2
    for rec in (wire_beat, beat):
        assert rec["reads_done_total"] == counts["reads_done_total"]
        assert rec["membership_changed_groups"] == \
            counts["membership_changed_groups"]
    chunks = [e for e in t.events if e.get("cat") == trace.CAT_CHUNK]
    assert [e["args"]["build"] for e in chunks] == [ALL_FEATURES]


def test_no_feature_counts_without_the_features(tmp_path):
    cfg = _cfg("raft5.jepsen", n_groups=4, crash_epoch=16)
    wire_beat, beat, leaves, g, st, t = _features_run(cfg, tmp_path, 24)
    for rec in (wire_beat, beat):
        assert "reads_done_total" not in rec
        assert "membership_changed_groups" not in rec
        assert rec["rounds_total"] > 0
    assert run_mod.feature_counts(cfg, st)["reads_done_total"] == 0
    assert not run_mod.membership_changed(cfg, st).any()
    chunks = [e for e in t.events if e.get("cat") == trace.CAT_CHUNK]
    assert [e["args"]["build"] for e in chunks] == ["base"]
    # the plain engine names no build; a beat without the State counts
    # no feature
    prev = trace.set_tracer(trace.Tracer(device_times=False))
    try:
        leaves2, _ = kernel.kinit(cfg, state.init(cfg, device="cpu"))
        kernel.krun(cfg, leaves2, 0, 2)
        args = [e["args"] for e in trace.get_tracer().events
                if e.get("cat") == trace.CAT_CHUNK]
    finally:
        trace.set_tracer(prev)
    assert args and all("build" not in a for a in args)
    feat = _cfg("etcd5.ops-jepsen", n_groups=2)
    _, m = run_mod.run(feat, state.init(feat, device="cpu"), 4)
    rec = trace.Heartbeat(str(tmp_path / "m.jsonl")).beat("m", 4, m)
    assert "reads_done_total" not in rec


def test_chip_smoke_takes_membership_changed_from_the_package():
    src = (Path(__file__).resolve().parent.parent / "chip_smoke.py") \
        .read_text()
    assert "from raft_tpu_torch.sim.run import membership_changed" in src
    assert "def membership_changed" not in src


# ------------------------------------------------------------ the readers


def X(name, cat, ts, dur, device=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if device is not None:
        ev["args"] = {"device": device}
    return ev


def _timeline(program: bool) -> profile.Timeline:
    """Two universes of 100 us on card 0: init [0, 30) with a fill
    kernel [10, 15), prun [30, 90) with the port kernel [40, 85) and, in
    the second universe, [40, 70); with `program`, the program's `prun`
    span [32, 88)."""
    ev = []
    for at, end in ((0.0, 85), (200.0, 70)):
        ev += [X("raftbench.universe", "user_annotation", at, 100),
               X("raftbench.init", "user_annotation", at, 30),
               X("raftbench.prun", "user_annotation", at + 30, 60),
               X("raftbench.fetch", "user_annotation", at + 90, 10),
               X("fill_kernel", "kernel", at + 10, 5, 0),
               X("fused_chunk_kernel", "kernel", at + 40, end - 40, 0)]
        if program:
            ev.append(X(profile.PROGRAM_PREFIX + "prun", "user_annotation",
                        at + 32, 56))
    return profile.read_chrome_trace({"traceEvents": ev},
                                     ("fused_chunk_kernel",), [0])


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_reads_the_one_card_metrics(cell):
    r = run.Run(cell=spec.cell(cell), setup_s=1.0, window_s=2.0,
                walls_ms=[250.0, 240.0, 260.0], group_ticks=3 * 6 * 10 ** 7,
                timeline=_timeline(False), roofline={"seconds": 1e-6},
                program_timeline=_timeline(True))
    for name in FAULTS:
        got = metrics_util.metric(name + ".faults", r)
        assert got is not None and got == metrics_util.metric(name, r), name
    e2e = run.read_metrics(r, spec.cell(cell).end_to_end)
    assert e2e["group_ticks_per_s"]["value"] == pytest.approx(9e7)
    assert e2e["universe_p90_ms"]["value"] == pytest.approx(258.0)
    assert metrics_util.metric("kernel_ms_per_universe.faults", r) == \
        pytest.approx(0.0375)
    assert metrics_util.metric("boundary_idle_ms.faults", r) == \
        pytest.approx((11 + 0.9 * (26 - 11)) / 1e3)
    got = run.read_metrics(r, spec.cell(cell).per_layer)
    assert set(got) == {n + ".faults" for n in FAULTS}


def test_each_new_entry_moves_an_end_to_end_entry_of_its_cells():
    bench = spec.load_benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    # the cells are appended to the one-card end-to-end entries, under
    # their bounds; no end-to-end entry of their own
    for name in END_TO_END:
        assert e2e[name]["workloads"] == [
            "raft5.steady", "raft5-sessions.clients-jepsen", *CELLS]
    assert not [n for n in e2e if n.endswith(".faults")]
    new = [m for m in bench["per_layer"] if m["name"].endswith(".faults")]
    assert {m["name"] for m in new} == {n + ".faults" for n in FAULTS}
    for m in new:
        assert sorted(m["workloads"]) == sorted(CELLS), m["name"]
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved["workloads"])
        one_card = next(p for p in bench["per_layer"]
                        if p["name"] == m["name"].rsplit(".", 1)[0])
        assert m["layer"] == one_card["layer"]
        assert m["moves"] == one_card["moves"]


def test_the_roofline_counts_etcd5s_work():
    """The reference's count of a few etcd5 groups' work gives a least
    time, so `kernel_roofline_pct.faults` has something to read."""
    c = spec.cell("etcd5.ops-jepsen")
    fields = c.raft_fields(spec.universe_seeds(SEED)[0])
    ids = list(range(4))
    ref = refworker.reference_run(fields, 40, c.ring, ids)
    base = refworker.reference_run(dict(fields, read_every=0,
                                        transfer_prob=0.0,
                                        reconfig_prob=0.0), 40, c.ring, ids)
    assert ref["ops"] > base["ops"] > 0
    least = roofline.least_time(2 * ref["group_bytes"] * c.groups,
                                ref["ops"] / len(ids) * c.groups)
    r = run.Run(cell=c, setup_s=1.0, window_s=1.0, walls_ms=[1.0],
                group_ticks=1, timeline=_timeline(False), roofline=least)
    pct = metrics_util.metric("kernel_roofline_pct.faults", r)
    assert pct is not None and pct > 0
