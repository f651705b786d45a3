"""The multi-device drivers of the port (raft_tpu_torch/parallel/mesh.py,
kmesh.py, stream_sched.py and the sharded half of cohort.py) against the
JAX package, tolerance 0, with shards on the CPU (`devices=["cpu"] * n`):

- `make_mesh`'s refusals and repeats;
- `run_sharded` over three shards at tests/test_parallel.py's universe
  against JAX `parallel.run_sharded` over the 8 virtual CPU devices and
  JAX `sim.run`;
- `prun_sharded` over three shards at `kmesh.faulted_64_cfg()` in two
  launches against JAX `sim.run` (tests/test_kmesh.py's program), with
  `kglobal_sharded` against the host's counters;
- the windows and per-device slices of the sharded pipeline against the
  reference's real-group spans, from shapes alone;
- `prun_streamed_sharded` at tests/test_stream_mesh.py's two-window
  universe against the resident `prun_sharded`, and on to tick 48
  against JAX `sim.run` on the groups that universe shares with the 64;
- a checkpoint the JAX package wrote, loaded onto a three-shard mesh and
  continued, against the unsharded run;
- `supported` summing the shards that share a device, and holding the
  first device to the whole fleet's gather and finish: the model's
  bytes against the tensors `prun_sharded` makes there.

Every JAX program here is one the reference files compile at the same
shape.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import json

import jax
import numpy as np
import pytest
import torch

from raft_tpu import parallel as jparallel
from raft_tpu import sim as jsim
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.parallel import cohort as jcohort
from raft_tpu.parallel import kmesh as jkmesh
from raft_tpu.parallel import stream_sched as jsched
from raft_tpu.sim import checkpoint as jckpt
from raft_tpu.sim import pkernel
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder, roofline, trace
from raft_tpu_torch.parallel import cohort, groups, kmesh, mesh, stream_sched
from raft_tpu_torch.sim import checkpoint, kernel, run, state
from jax_programs import release_jax_programs  # noqa: F401

jrun = importlib.import_module("raft_tpu.sim.run")

CPU3 = ("cpu",) * 3
JFAULT = jkmesh.faulted_64_cfg()
FAULT = kmesh.faulted_64_cfg()
# tests/test_parallel.py:22-38
PARALLEL = dict(seed=9, drop_prob=0.05, crash_prob=0.2, crash_epoch=32)


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


def assert_equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        if x is None:
            assert y is None, f"{what}.{name}"
        elif isinstance(x, tuple):
            assert_equal(x, y, f"{what}.{name}")
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}.{name}"


@pytest.fixture(scope="module")
def fault_48():
    """JAX `sim.run` of the faulted universe, 48 ticks
    (tests/test_kmesh.py's reference program)."""
    st0 = jsim.init(JFAULT)
    return jrun.run(JFAULT, st0, 48)


def test_make_mesh_refusals_and_repeats(monkeypatch):
    """A mesh is a tuple of devices, repeats allowed; fewer devices than
    asked raise, and no card is ever swapped for the CPU (the reference's
    test_make_mesh_refuses_silent_cpu_fallback: the port has no such
    flag at all)."""
    assert mesh.make_mesh(devices=CPU3) == (torch.device("cpu"),) * 3
    assert mesh.make_mesh(2, devices=CPU3) == (torch.device("cpu"),) * 2
    for bad in (dict(n_devices=4, devices=CPU3), dict(devices=[]),
                dict(n_devices=0, devices=CPU3)):
        with pytest.raises(ValueError):
            mesh.make_mesh(**bad)
    assert "allow_cpu_fallback" not in inspect.signature(
        mesh.make_mesh).parameters
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for n in (None, 1, 8):
        with pytest.raises(ValueError):
            mesh.make_mesh(n)
    # the cut: ceil(G / n) groups a shard, the last the remainder
    assert groups.spans(64, 3) == [(0, 22), (22, 44), (44, 64)]
    assert groups.spans(4, 3) == [(0, 2), (2, 4)]
    with pytest.raises(ValueError, match="not the cut"):
        mesh.as_shards(mesh.shard_state(state.init(FAULT, device="cpu"),
                                        CPU3)[:2], CPU3)


def test_run_sharded_matches_jax_mesh_and_run():
    """tests/test_parallel.py's universe: the port's plain tick sharded
    22/22/20 over three CPU shards equals JAX's 8-device `run_sharded`
    (every GlobalMetrics counter) and JAX `sim.run` (full State)."""
    jcfg, cfg = JaxConfig(**PARALLEL), RaftConfig(**PARALLEL)
    ref_st, ref_m = jsim.run(jcfg, jsim.init(jcfg, n_groups=64), 120)
    jmesh = jparallel.make_mesh(8)
    _, jgm = jparallel.run_sharded(
        jcfg, jparallel.shard_state(jsim.init(jcfg, n_groups=64), jmesh),
        120, jmesh)
    m3 = mesh.make_mesh(devices=CPU3)
    st, gm = mesh.run_sharded(cfg, state.init(cfg, 64, device="cpu"), 120,
                              m3)
    assert_same(ref_st, st, "state")
    for f in mesh.GlobalMetrics._fields:
        assert np.array_equal(np.asarray(getattr(jgm, f)),
                              getattr(gm, f).numpy()), f
    assert int(gm.rounds) == int(np.asarray(ref_m.committed).sum()) > 0
    assert int(gm.unsafe) == 0


def test_prun_sharded_in_two_launches_matches_jax(fault_48):
    """`kmesh.faulted_64_cfg()` over three CPU shards, 2 x 24-tick
    launches: full State and Metrics equal JAX `sim.run` at 48 ticks;
    `kglobal_sharded` equals the host's counters; the chunk spans name
    the sharded engine."""
    sj, mj = fault_48
    m3 = mesh.make_mesh(devices=CPU3)
    st0 = state.init(FAULT, device="cpu")
    t = trace.Tracer()
    trace.set_tracer(t)
    try:
        st, m = kmesh.prun_sharded(FAULT, st0, 48, m3, chunk_ticks=24)
    finally:
        trace.set_tracer(None)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    spans = [e for e in t.events if e["name"].startswith("chunk ")]
    assert [(e["args"]["engine"], e["args"]["shard"], e["args"]["t0"])
            for e in spans] == [("plain-sharded-3dev", j, t0)
                                for t0 in (0, 24) for j in range(3)]
    shards, g = kmesh.kinit_sharded(FAULT, st0, m3)
    for at in (0, 24):
        shards = kmesh.kstep_sharded(FAULT, shards, at, 24, m3)
    gm = kmesh.kglobal_sharded(FAULT, shards, g, m3)
    whole = kmesh.gather(FAULT, shards, "cpu")
    assert int(gm.rounds) == kernel.kcommitted(FAULT, whole, g) \
        == run.total_rounds(m)
    assert int(gm.elections) == kernel.kelections(FAULT, whole, g) \
        == int(mj.elections)
    assert np.array_equal(gm.hist.numpy(), kernel.khist(FAULT, whole, g))
    assert int(gm.max_latency) == int(mj.max_latency)
    assert int(gm.unsafe) == run.unsafe_groups(m) == 0
    assert_equal(kmesh.kfinish_sharded(FAULT, shards, g)[0], st, "kfinish")


@pytest.mark.parametrize("g", [1000, 2500, 5000, 100_369])
def test_windows_and_slices_match_the_reference(g):
    """The port's windows and per-device slices are the reference's
    spans of real groups (its padding dropped), on a grid of cohort
    sizes and device counts, read from shapes."""
    for blocks in (1, 2, 3, 98):
        for n in (1, 2, 4, 8):
            jcfg = JaxConfig(cohort_blocks=blocks, stream_groups=True)
            cfg = RaftConfig(cohort_blocks=blocks, stream_groups=True)
            padded = -(-g // (n * pkernel.GB)) * n * pkernel.GB
            leaf = np.empty((1, padded // pkernel.LANE, pkernel.LANE),
                            np.int32)
            jmesh = jparallel.make_mesh(n)
            order = list(jmesh.devices.flat)
            want_w, want_s = [], []
            for s0, s1 in jcohort.cohort_windows(jcfg, [leaf], n_devices=n):
                w0 = s0 * pkernel.LANE
                want_w.append((w0, min(s1 * pkernel.LANE, g)))
                want_s.append(sorted(
                    (order.index(d), lo * pkernel.LANE,
                     min((s0 + hi) * pkernel.LANE, g) - w0)
                    for d, (lo, hi) in jsched.device_slices(
                        jmesh, leaf, s0, s1)
                    if (s0 + lo) * pkernel.LANE < g))
            got_w = cohort.cohort_windows(cfg, g, n)
            assert got_w == want_w, (g, blocks, n)
            m = tuple(torch.device("cuda", j) for j in range(n))
            got_s = [[(d.index, lo, hi) for d, (lo, hi) in
                      stream_sched.device_slices(m, *w)] for w in got_w]
            assert got_s == want_s, (g, blocks, n)
            assert kernel.stream_blocks_per_device(cfg, n) == \
                pkernel.stream_blocks_per_device(jcfg, n)


def test_streamed_sharded_matches_resident_and_jax(fault_48, tmp_path):
    """tests/test_stream_mesh.py's universe: 2,500 faulted groups,
    `cohort_blocks=2`, two CPU shards (windows [0, 2048) split 1,024 +
    1,024 and [2048, 2500) on the first shard only), 24 ticks in 12-tick
    chunks with the flight ring: equal to the resident `prun_sharded`
    (State, Metrics, Flight), with the reference's stats keys; 24 more
    ticks on the same host wire, one heartbeat per device and window,
    and its first 64 groups (a group's run does not depend on the
    others) equal JAX `sim.run` at 48 ticks."""
    sj, mj = fault_48
    cfg = kmesh.faulted_64_cfg(n_groups=2500)
    scfg = dataclasses.replace(cfg, stream_groups=True, cohort_blocks=2)
    m2 = mesh.make_mesh(devices=("cpu",) * 2)
    st0 = state.init(cfg, device="cpu")
    fl = recorder.flight_init(2500, device="cpu")
    res = kmesh.prun_sharded(cfg, st0, 24, m2, flight=fl)
    stats = {}
    out = cohort.prun_streamed_sharded(scfg, st0, 24, m2, flight=fl,
                                       chunk_ticks=12, stats=stats)
    for a, b, what in zip(res, out, ("state", "metrics", "flight")):
        assert_equal(a, b, what)
    assert {"per_device", "slowest_device", "n_devices",
            "overlap_efficiency_per_device_measured", "cohorts", "launches",
            "h2d_s", "compute_s", "d2h_s", "wall_s",
            "overlap_efficiency_measured"} <= set(stats)
    assert stats["n_devices"] == 2 and stats["cohorts"] == 2
    assert stats["launches"] == 6 and len(stats["per_device"]) == 2
    assert len(stats["overlap_efficiency_per_device_measured"]) == 2
    ab = stream_sched.staging_ablation(kmesh.faulted_64_cfg(cohort_blocks=1),
                                       m2, n_windows=2, repeats=1)
    assert ab["n_devices"] == 2 and ab["windows"] == 2
    assert ab["window_bytes"] == 4 * 2048 * kernel.wire_words_per_group(
        FAULT) and ab["staged_wall_s"] > 0 and ab["naive_wall_s"] > 0

    hw = cohort.host_wire(scfg, st0, mesh=m2)
    assert hw.windows == [(0, 1024), (1024, 2048), (2048, 2500)]
    assert hw.owner == [0, 1, 0] and hw.parts == [[0, 1], [2]]
    cohort.stream_ticks_sharded(scfg, hw, 0, 24, m2, chunk_ticks=12)
    trace.set_heartbeat(trace.Heartbeat(str(tmp_path / "hb.jsonl"),
                                        every=1))
    try:   # one beat per device and window
        cohort.stream_ticks_sharded(scfg, hw, 24, 24, m2, chunk_ticks=12)
    finally:
        trace.set_heartbeat(None)
    eng = cohort.sharded_engine(2)
    beats = [json.loads(x) for x in
             (tmp_path / "hb.jsonl").read_text().splitlines()]
    assert [(b["label"], b["tick"]) for b in beats] == [
        (f"{eng}:c0:d0", 48), (f"{eng}:c0:d1", 48), (f"{eng}:c1:d0", 48)]
    st48, m48, _ = cohort.finish(scfg, hw)
    head = groups.take(st48, m48, None, 0, 64, "cpu")
    assert_same(sj, head[0], "first 64 groups' state at 48")
    for f in ("committed", "leaderless", "safety"):
        assert np.array_equal(np.asarray(getattr(mj, f)),
                              getattr(head[1], f).numpy()), f


def test_reference_checkpoint_continues_on_a_mesh(fault_48, tmp_path):
    """A checkpoint the JAX package wrote at tick 48, loaded onto three
    CPU shards (`checkpoint.load(mesh=...)`), continues 24 ticks through
    `prun_sharded`, which returns the State as shards: joined, equal to
    the unsharded kernel path from the same file."""
    sj, mj = fault_48
    path = tmp_path / "ref.npz"
    jckpt.save(path, sj, 48, mj, cfg=JFAULT)
    shards, t, m = checkpoint.load(path, cfg=FAULT, mesh=CPU3)
    assert t == 48 and [s.alive_prev.shape[0] for s in shards] == [22, 22, 20]
    whole, _, _ = checkpoint.load(path, cfg=FAULT, device="cpu")
    assert_same(sj, groups.cat_states(shards, "cpu"), "loaded shards")
    got = kmesh.prun_sharded(FAULT, shards, 24, CPU3, t, m, chunk_ticks=12)
    # shards in, shards out: each State shard decoded on its device
    assert [s.alive_prev.shape[0] for s in got[0]] == [22, 22, 20]
    got = (groups.cat_states(got[0], "cpu"), got[1])
    want = kernel.prun(FAULT, whole, 24, t, m)
    for a, b, what in zip(got, want, ("state", "metrics")):
        assert_equal(a, b, what)
    st, gm = mesh.run_sharded(FAULT, shards, 24, CPU3, t)
    assert_equal(st, want[0], "run_sharded state")


def test_supported_sums_the_shards_on_a_device():
    """Two shards on one card share its budget: a fleet each of whose
    halves fits a card, but not both together, is refused on one card;
    on two cards the first one still gathers the whole fleet, so it is
    refused there too until the budget holds that; the streamed pipeline
    counts one per shard."""
    cfg = RaftConfig(seed=42)
    g = 100_000
    half = kernel.hbm_bytes(cfg, g // 2)
    budget = half + (half // 2)
    one_card = (torch.device("cuda", 0),) * 2
    two_cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert kernel.mesh_hbm_bytes(cfg, g, one_card) == {one_card[0]: 2 * half}
    assert not kernel.supported(cfg, g, hbm=budget, mesh=one_card)
    end = kernel.mesh_hbm_bytes(cfg, g, two_cards)
    assert end[two_cards[1]] == half and end[two_cards[0]] == max(
        half, kernel.finish_bytes(cfg, g),
        4 * kernel.wire_words_per_group(cfg) * (g + g // 2 + g // 2)
        + 2 * 4 * kernel.acc_words(cfg))
    assert not kernel.supported(cfg, g, hbm=budget, mesh=two_cards)
    assert kernel.supported(cfg, g, hbm=end[two_cards[0]], mesh=two_cards)
    assert not kernel.supported(cfg, g, hbm=budget)
    scfg = dataclasses.replace(cfg, stream_groups=True, cohort_blocks=98)
    win = kernel.cohort_hbm_bytes(scfg, 0, 2)
    assert kernel.mesh_hbm_bytes(scfg, 10 ** 6, one_card) == {
        one_card[0]: 2 * win}
    assert kernel.supported(scfg, 10 ** 6, hbm=win, host=2 ** 40,
                            mesh=two_cards)
    assert not kernel.supported(scfg, 10 ** 6, hbm=win, host=2 ** 40,
                                mesh=one_card)
    # a fleet smaller than one window's first slice holds one shard only
    assert len(kernel.mesh_hbm_bytes(scfg, 1000, two_cards)) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_resident_ceiling_holds_the_gather(n):
    """Over n distinct cards each card's launch fits n x one card's
    ceiling, but the first card gathers the whole fleet and finishes it
    there, so `supported` refuses that fleet, and `mesh_ceiling_groups`
    is `supported`'s exact boundary below it."""
    cfg = RaftConfig(seed=42)
    budget = 10 ** 9
    cards = [torch.device("cuda", i) for i in range(n)]
    one = kernel.hbm_ceiling_groups(cfg, hbm=budget)
    need = kernel.mesh_hbm_bytes(cfg, n * one, cards)
    assert all(need[c] == kernel.hbm_bytes(cfg, one) <= budget
               for c in cards[1:])
    assert not kernel.supported(cfg, n * one, hbm=budget, mesh=cards)
    top = kernel.mesh_ceiling_groups(cfg, cards, hbm=budget)
    assert top < n * one
    assert kernel.supported(cfg, top, hbm=budget, mesh=cards)
    assert not kernel.supported(cfg, top + 1, hbm=budget, mesh=cards)
    need = kernel.mesh_hbm_bytes(cfg, top + 1, cards)
    assert max(need, key=need.get) == cards[0]


def _nbytes(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(x) for x in tree)


@pytest.mark.parametrize("dials", [{}, dict(pack_bools=True, pack_ring=True)],
                         ids=["wide", "packed"])
def test_first_device_holds_what_prun_sharded_makes(monkeypatch, dials):
    """The bytes `mesh_hbm_bytes` budgets on the first device for a
    resident run's end are the tensors `prun_sharded` makes there: the
    gathered wire pair, the working wire `kfinish` unpacks, and the
    State, Metrics and Flight it returns (three CPU shards, flight on).
    A budget one byte short of the model is refused."""
    cfg = dataclasses.replace(FAULT, **dials)
    made = {}

    def wrap(name, mod, keep=lambda out, args: out):
        real = getattr(mod, name)

        def fn(*args, **kw):
            out = real(*args, **kw)
            made[name] = _nbytes(keep(out, args))
            return out
        monkeypatch.setattr(mod, name, fn)

    wrap("gather", kmesh)
    wrap("unpack_wire", kernel,
         lambda out, args: None if out is args[1] else out)
    wrap("kfinish", kernel)
    wrap("kflight", kernel)
    st0 = state.init(cfg, 64, device="cpu")
    fl = recorder.flight_init(64, device="cpu")
    need = kernel.mesh_hbm_bytes(cfg, 64, CPU3, fl.tick.shape[0])
    assert list(need) == [torch.device("cpu")]
    assert kernel.supported(cfg, 64, fl.tick.shape[0], hbm=need[
        torch.device("cpu")], mesh=CPU3)
    assert not kernel.supported(cfg, 64, fl.tick.shape[0], hbm=need[
        torch.device("cpu")] - 1, mesh=CPU3)
    kmesh.prun_sharded(cfg, st0, 4, CPU3, flight=fl)
    assert sum(made.values()) == kernel.finish_bytes(
        cfg, 64, fl.tick.shape[0]) <= need[torch.device("cpu")]


def test_roofline_takes_the_mesh_axis():
    """Both sharded engine strings price as the kernel, and over N
    devices each one's share of the bytes and operations bounds a tick."""
    cfg = RaftConfig(seed=42)
    for eng in (kmesh.sharded_engine(3, "cuda"), cohort.sharded_engine(2)):
        assert roofline.engine_class(eng) == "kernel"
    assert roofline.engine_class(kmesh.sharded_engine(3, "cpu")) == "plain"
    one = roofline.roofline(cfg, 100_000, "cuda", 200, ops=4e9)
    two = roofline.roofline(cfg, 100_000, "cuda-sharded-2dev", 200, ops=4e9,
                            nd=2)
    assert two["bytes_per_tick"] == one["bytes_per_tick"] / 2
    assert two["ops_s_per_tick"] == pytest.approx(one["ops_s_per_tick"] / 2)
    assert two["predicted_rounds_per_sec"] == pytest.approx(
        2 * one["predicted_rounds_per_sec"])
