"""The port's narrow resident form (raft_tpu_torch/sim/state.py
`narrow_spec` and its boundary helpers) against the JAX package,
tolerance 0 and dtype for dtype: the spec name for name, the narrow
`init`, `run.run` and `prun` with every narrow dial and with
`donate_scan` against JAX `run.run` with the same dials, each dial alone
against the wide run's values, and the sticky bit-31 latch with its
refusals at `kfinish` and in the stream driver. The JAX programs are
those tests/test_narrow.py compiles on `kmesh.faulted_64_cfg()`, and the
narrow twin of `workload.clients_64_cfg()`."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu.clients import clients_64_cfg
from raft_tpu.config import NARROW_FIELDS
from raft_tpu.parallel.kmesh import faulted_64_cfg
from raft_tpu.sim import state as jstate
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import kernel, run, state
from jax_programs import release_jax_programs  # noqa: F401

jrun = importlib.import_module("raft_tpu.sim.run")

ALL_DIALS = {f: True for f in NARROW_FIELDS}
DIALS = ("narrow_scalars", "narrow_ring", "narrow_mailbox", "narrow_clients")
JAX_UNIVERSES = {"faulted": faulted_64_cfg, "clients": clients_64_cfg}


def port(jcfg, **kw) -> RaftConfig:
    return RaftConfig(**{**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)}, **kw})


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


def np_dtype(dt) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


@pytest.fixture(scope="module")
def jax_runs():
    """JAX `run.run` over 48 ticks: the wide faulted universe with
    donation, and each universe with every narrow dial (donation
    included), as tests/test_narrow.py runs them."""
    out = {}
    for name, make in JAX_UNIVERSES.items():
        jcfg = make(**ALL_DIALS)
        m0 = jrun.metrics_init(64, clients=name == "clients")
        out[name] = jrun.run(jcfg, jstate.init(jcfg), 48, 0, m0)
    jcfg = faulted_64_cfg(donate_scan=True)
    out["donate"] = jrun.run(jcfg, jstate.init(jcfg), 48, 0,
                             jrun.metrics_init(64))
    return out


@pytest.mark.parametrize("dials", [ALL_DIALS] + [{d: True} for d in DIALS],
                         ids=["all"] + list(DIALS))
@pytest.mark.parametrize("extra", [
    {}, dict(prevote=True, transfer_prob=0.5), dict(k=20, log_cap=8)],
    ids=["base", "prevote_transfer", "k20"])
@pytest.mark.parametrize("universe", list(JAX_UNIVERSES))
def test_narrow_spec_is_the_reference(universe, extra, dials):
    jcfg = JAX_UNIVERSES[universe](**extra, **dials)
    cfg = port(jcfg)
    want = {n: np.dtype(d) for n, d in jstate.narrow_spec(jcfg).items()}
    assert {n: np_dtype(d) for n, d in state.narrow_spec(cfg).items()} \
        == want
    assert {n: np_dtype(d) for n, d in state.full_narrow_spec(cfg).items()} \
        == {n: np.dtype(d) for n, d in jstate.full_narrow_spec(jcfg).items()}
    assert state.narrow_active(cfg) == jstate.narrow_active(jcfg)


def leaf_dtypes(st) -> dict:
    """Dot-path name -> dtype of every leaf of a State."""
    out = {}
    state._map_named(st, "", lambda n, a: out.setdefault(n, a.dtype))
    return out


@pytest.mark.parametrize("universe", list(JAX_UNIVERSES))
def test_narrow_init_is_the_reference(universe):
    """The narrow init is JAX's, leaf for leaf and dtype for dtype: the
    spec's leaves at their narrow dtypes, every other leaf wide."""
    jcfg = JAX_UNIVERSES[universe](**ALL_DIALS)
    cfg = port(jcfg)
    st = state.init(cfg, device="cpu")
    assert_same(jstate.init(jcfg), st, "init")
    spec = state.narrow_spec(cfg)
    got = leaf_dtypes(st)
    wide = leaf_dtypes(state.init(port(JAX_UNIVERSES[universe]()),
                                  device="cpu"))
    assert {n: got[n] for n in spec} == spec
    assert {n: d for n, d in got.items() if n not in spec} == \
        {n: d for n, d in wide.items() if n not in spec}
    assert not state.narrow_overflow(st).any()
    assert leaf_dtypes(state.widen_state(cfg, st)) == wide


@pytest.mark.parametrize("universe", list(JAX_UNIVERSES))
def test_narrow_run_matches_jax_dtypes_included(jax_runs, universe):
    """`run.run` and `prun` (through kinit's widening and kfinish's
    narrowing, on CPU tensors) with every narrow dial and donate_scan
    equal JAX `run.run` with the same dials, State dtypes included."""
    cfg = port(JAX_UNIVERSES[universe](**ALL_DIALS))
    sj, mj = jax_runs[universe]
    st0 = state.init(cfg, device="cpu")
    st, m = run.run(cfg, st0, 48)
    assert_same(sj, st, "run state")
    assert_same(mj, m, "run metrics")
    st, m = kernel.prun(cfg, st0, 48)
    assert_same(sj, st, "prun state")
    assert_same(mj, m, "prun metrics")
    assert st.nodes.term.dtype == torch.uint16
    assert not state.narrow_overflow(st).any()


def test_donate_scan_alone_changes_nothing(jax_runs):
    cfg = port(faulted_64_cfg(donate_scan=True))
    st, m = run.run(cfg, state.init(cfg, device="cpu"), 48)
    assert_same(jax_runs["donate"][0], st, "state")
    assert_same(jax_runs["donate"][1], m, "metrics")


@pytest.mark.parametrize("dial", DIALS)
def test_each_dial_alone_keeps_the_values(jax_runs, dial):
    """One dial on the client universe: `run.run`'s values equal the
    all-dials JAX run's, and its dtypes follow the one dial's spec."""
    cfg = port(clients_64_cfg(**{dial: True}))
    st, m = run.run(cfg, state.init(cfg, device="cpu"), 48)
    sj, mj = jax_runs["clients"]
    ok, why = trees_equal_why(jax.tree.map(np.asarray, sj),
                              state.to_numpy(st), values_only=True)
    assert ok, why
    assert_same(mj, m, "metrics")
    spec = state.narrow_spec(cfg)
    got = leaf_dtypes(st)
    assert spec and {n: got[n] for n in spec} == spec


def _latched(cfg):
    """A narrow state of cfg whose group 3 holds a term past u16,
    narrowed: group 3 latched, the rest clean."""
    wide = state.widen_state(cfg, state.init(cfg, device="cpu"))
    term = wide.nodes.term.clone()
    term[3, 0] = 1 << 16
    return state.narrow_state(cfg, wide._replace(
        nodes=wide.nodes._replace(term=term)))


def test_latch_is_the_reference_and_sticky():
    """Narrowing a term past u16 latches bit 31 of that group's id, as
    JAX's narrow_state does; the latch survives widen/narrow and further
    ticks, and the host boundary refuses it with JAX's words."""
    jcfg = faulted_64_cfg(**ALL_DIALS)
    cfg = port(jcfg)
    narrowed = _latched(cfg)
    jwide = jstate.widen_state(jcfg, jstate.init(jcfg))
    jterm = np.asarray(jwide.nodes.term).copy()
    jterm[3, 0] = 1 << 16
    jnarrowed = jstate.narrow_state(jcfg, jwide._replace(
        nodes=jwide.nodes._replace(term=jax.numpy.asarray(jterm))))
    assert_same(jnarrowed, narrowed, "latched state")
    ov = state.narrow_overflow(narrowed)
    assert ov.nonzero().flatten().tolist() == [3]
    with pytest.raises(ValueError, match=r"narrow-dtype overflow latched in "
                                         r"1 group\(s\) \(first: \[3\]\)"):
        state.check_narrow_overflow(cfg, narrowed)
    again = state.narrow_state(cfg, state.widen_state(cfg, narrowed))
    assert state.narrow_overflow(again)[3]
    stepped = run.run(cfg, narrowed, 2)[0]
    assert state.narrow_overflow(stepped).nonzero().flatten().tolist() == [3]
    state.check_narrow_overflow(port(faulted_64_cfg()), narrowed)  # wide: no


def test_latch_refused_at_kfinish_and_in_the_stream_driver():
    cfg = port(faulted_64_cfg(**ALL_DIALS))
    narrowed = _latched(cfg)
    leaves, g = kernel.kinit(cfg, narrowed)
    leaves = kernel.kstep(cfg, leaves, 0, 2)
    with pytest.raises(ValueError, match="narrow-dtype overflow"):
        kernel.kfinish(cfg, leaves, g)
    # An in-range narrow state whose wide run overflows at kfinish.
    wide = state.widen_state(cfg, state.init(cfg, device="cpu"))
    big = wide._replace(nodes=wide.nodes._replace(
        commit=torch.full_like(wide.nodes.commit, 70_000)))
    leaves, g = kernel.kinit(cfg, big)
    with pytest.raises(ValueError, match="narrow-dtype overflow"):
        kernel.kfinish(cfg, leaves, g)
    with pytest.raises(ValueError, match="narrow-dtype overflow"):
        cohort.prun_streamed(dataclasses.replace(cfg, stream_groups=True),
                             narrowed, 8, device="cpu")
