"""Checkpoints across the two packages, tolerance 0: a file saved by
`raft_tpu.sim.checkpoint` loads in `raft_tpu_torch.sim.checkpoint` and
continues (on the plain tick and on the kernel wrapper) equal to the
reference's uninterrupted run, and the reverse; the files the two
packages write hold the same keys, dtypes and values; the narrow-axis
hop both ways; refusals in the reference's words.

tests/test_checkpoint.py's universe (`CFG`, 16 groups, 100 + 100 ticks).
The reference runs one XLA program, `sim.run` at 100 ticks with its
metrics passed in, which tests/test_checkpoint.py also compiles."""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest

from raft_tpu import sim as jsim
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import checkpoint as jckpt
from raft_tpu.sim.run import metrics_init as jmetrics_init
from raft_tpu.utils.trees import trees_equal_why as jtrees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import checkpoint, kernel, run, state
from test_torch_nemesis import ADMISSION

from jax_programs import release_jax_programs  # noqa: F401

CFG = dict(seed=6, drop_prob=0.05, crash_prob=0.2, crash_epoch=32)
G, HALF = 16, 100
NARROW = dict(narrow_scalars=True, narrow_ring=True, narrow_mailbox=True,
              narrow_clients=True)


def assert_same(jax_tree, torch_tree, what, values_only=False):
    ok, why = jtrees_equal_why(jax.tree.map(np.asarray, jax_tree),
                               state.to_numpy(torch_tree),
                               values_only=values_only)
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def reference():
    """The reference's run to tick 100 and its continuation to 200,
    through one program (metrics passed in)."""
    jcfg = JaxConfig(**CFG)
    s1, m1 = jsim.run(jcfg, jsim.init(jcfg, n_groups=G), HALF, 0,
                      jmetrics_init(G))
    s2, m2 = jsim.run(jcfg, s1, HALF, HALF, m1)
    return jcfg, (s1, m1), (s2, m2)


@pytest.fixture(scope="module")
def ref_file(reference, tmp_path_factory):
    jcfg, (s1, m1), _ = reference
    path = tmp_path_factory.mktemp("ckpt") / "reference.npz"
    jckpt.save(path, s1, HALF, m1, cfg=jcfg)
    return path


@pytest.mark.parametrize("engine", ["run", "prun"])
def test_reference_file_resumes_in_the_port(reference, ref_file, engine):
    _, (s1, m1), (s2, m2) = reference
    cfg = RaftConfig(**CFG)
    st, t, m = checkpoint.load(ref_file, cfg=cfg, device="cpu")
    assert t == HALF
    assert_same(s1, st, "loaded state")
    assert_same(m1, m, "loaded metrics")
    fn = run.run if engine == "run" else kernel.prun
    st2, mm2 = fn(cfg, st, HALF, t, m)
    assert_same(s2, st2, f"{engine} continuation state")
    assert_same(m2, mm2, f"{engine} continuation metrics")
    assert run.unsafe_groups(mm2) == 0 and run.total_rounds(mm2) > 0


@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    """The port's own first 100 ticks, saved by the port."""
    cfg = RaftConfig(**CFG)
    st, m = run.run(cfg, state.init(cfg, G, device="cpu"), HALF, 0,
                    run.metrics_init(G, device="cpu"))
    path = tmp_path_factory.mktemp("ckpt") / "port.npz"
    checkpoint.save(path, st, HALF, m, cfg=cfg)
    return path


def test_port_file_resumes_in_the_reference(reference, port_file):
    jcfg, (s1, m1), (s2, m2) = reference
    st, t, m = jckpt.load(port_file, cfg=jcfg)
    assert t == HALF
    ok, why = jtrees_equal_why((st, m), (s1, m1))
    assert ok, why
    st2, mm2 = jsim.run(jcfg, st, HALF, t, m)
    ok, why = jtrees_equal_why((st2, mm2), (s2, m2))
    assert ok, why


def test_the_two_files_are_the_same(ref_file, port_file):
    """Same keys, dtypes, shapes and values, and the same `__cfg__`
    bytes."""
    with np.load(ref_file) as a, np.load(port_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
    assert any(k.startswith("metrics.") for k in a.files)


def test_names_follow_the_reference(reference):
    _, (s1, m1), _ = reference
    st = state.from_numpy(jax.tree.map(np.asarray, s1), device="cpu")
    assert [n for n, _ in checkpoint.iter_named_leaves(st, "state.")] \
        == [n for n, _ in jckpt.iter_named_leaves(s1, "state.")]


def test_narrow_hop_both_ways(reference, ref_file, tmp_path):
    """A wide reference file loads under the narrow dials at the narrow
    dtypes and continues the same universe; a narrow file saved by the
    port loads wide in the reference and narrow again in both."""
    _, (s1, _), (s2, _) = reference
    ncfg = RaftConfig(**CFG, **NARROW)
    st, t, m = checkpoint.load(ref_file, cfg=ncfg, device="cpu")
    spec = state.narrow_spec(ncfg)
    for name, leaf in checkpoint.iter_named_leaves(st):
        assert leaf.dtype == spec.get(name, leaf.dtype), name
    assert_same(s1, st, "narrow load", values_only=True)
    st2, _ = run.run(ncfg, st, HALF, t, m)
    assert_same(s2, st2, "narrow continuation", values_only=True)

    path = tmp_path / "narrow.npz"
    checkpoint.save(path, st, t, cfg=ncfg)
    wide, t2, _ = jckpt.load(path, cfg=JaxConfig(**CFG))
    assert t2 == t
    ok, why = jtrees_equal_why(wide, s1)
    assert ok, why
    jnarrow, _, _ = jckpt.load(path, cfg=JaxConfig(**CFG, **NARROW))
    mine, _, _ = checkpoint.load(path, cfg=ncfg, device="cpu")
    assert_same(jnarrow, mine, "narrow file, narrow load")


def test_wide_value_past_the_narrow_range_refuses(reference, tmp_path):
    _, (s1, _), _ = reference
    cfg = RaftConfig(**CFG)
    st = state.from_numpy(jax.tree.map(np.asarray, s1), device="cpu")
    term = st.nodes.term.clone()
    term[0, 0] = 1 << 16
    path = tmp_path / "big.npz"
    checkpoint.save(path, st._replace(nodes=st.nodes._replace(term=term)),
                    HALF, cfg=cfg)
    with pytest.raises(ValueError, match="narrow-dtype overflow"):
        checkpoint.load(path, cfg=RaftConfig(**CFG, **NARROW), device="cpu")


def _error(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


def test_refusals_in_the_reference_words(ref_file, tmp_path):
    """A config mismatch, a foreign narrow dtype, a missing field and an
    unknown version raise the same exception with the same message in
    both packages; the layout, residency and narrow dials are not part
    of the match; without a cfg the load is permissive."""
    other = dict(CFG, seed=7)
    assert _error(lambda: checkpoint.load(
        ref_file, cfg=RaftConfig(**other), device="cpu")) == _error(
        lambda: jckpt.load(ref_file, cfg=JaxConfig(**other)))
    assert "cfg mismatch" in _error(lambda: checkpoint.load(
        ref_file, cfg=RaftConfig(**other), device="cpu"))[1]
    dials = dict(CFG, pack_bools=True, pack_ring=True, alias_wire=True,
                 stream_groups=True, donate_scan=True)
    checkpoint.load(ref_file, cfg=RaftConfig(**dials), device="cpu")
    checkpoint.load(ref_file, device="cpu")

    with np.load(ref_file) as z:
        data = {k: z[k] for k in z.files}
    cases = {
        "foreign_dtype": dict(data, **{"state.nodes.term":
                                       data["state.nodes.term"]
                                       .astype(np.int16)}),
        "missing_field": {k: v for k, v in data.items()
                          if k != "state.nodes.commit"},
        "version": dict(data, __version__=np.int64(2)),
    }
    ncfg = dict(CFG, **NARROW)
    for name, d in cases.items():
        path = tmp_path / f"{name}.npz"
        np.savez(path, **d)
        mine = _error(lambda: checkpoint.load(
            path, cfg=RaftConfig(**ncfg), device="cpu"))
        ref = _error(lambda: jckpt.load(path, cfg=JaxConfig(**ncfg)))
        if name == "foreign_dtype":
            # The reference names the expected dtype by its jnp scalar
            # type's repr; the port by its name ("uint16").
            mine, ref = ((e, msg.split(" (")[0]) for e, msg in (mine, ref))
            assert "(uint16)" in _error(lambda: checkpoint.load(
                path, cfg=RaftConfig(**ncfg), device="cpu"))[1]
        assert mine == ref, name


def test_files_predating_a_field_backfill(ref_file, tmp_path):
    """A file whose config predates the nemesis knob resumes under a
    nemesis-free config, in both packages."""
    with np.load(ref_file) as z:
        data = {k: z[k] for k in z.files}
    saved = json.loads(bytes(data["__cfg__"]).decode())
    assert saved.pop("nemesis") == []
    data["__cfg__"] = np.bytes_(json.dumps(saved, sort_keys=True))
    path = tmp_path / "old.npz"
    np.savez(path, **data)
    st, t, _ = checkpoint.load(path, cfg=RaftConfig(**CFG), device="cpu")
    jst, jt, _ = jckpt.load(path, cfg=JaxConfig(**CFG))
    assert t == jt == HALF
    assert_same(jst, st, "backfilled load")


def test_client_state_round_trips_across(tmp_path):
    """A clients-on state with bounded admission: the port's file loads
    in the reference with the client leaves and lanes, and the
    reference's file of that state in the port."""
    cfg, jcfg = RaftConfig(**ADMISSION), JaxConfig(**ADMISSION)
    st, m = run.run(cfg, state.init(cfg, 4, device="cpu"), 30)
    assert st.clients is not None and st.clients.shed is not None
    path = tmp_path / "clients.npz"
    checkpoint.save(path, st, 30, m, cfg=cfg)
    jst, jt, jm = jckpt.load(path, cfg=jcfg)
    assert jt == 30
    assert_same(jst, st, "clients state")
    assert_same(jm, m, "clients metrics")
    path2 = tmp_path / "clients_ref.npz"
    jckpt.save(path2, jst, 30, jm, cfg=jcfg)
    st2, _, m2 = checkpoint.load(path2, cfg=cfg, device="cpu")
    assert_same(jst, st2, "clients state, back")
    assert_same(jm, m2, "clients metrics, back")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_a_latched_narrow_state_is_not_saved(tmp_path):
    ncfg = RaftConfig(**CFG, **NARROW)
    st = state.init(ncfg, 2, device="cpu")
    st = st._replace(group_id=st.group_id | state.NARROW_LATCH)
    with pytest.raises(ValueError, match="narrow-dtype overflow"):
        checkpoint.save(tmp_path / "x.npz", st, 0, cfg=ncfg)
