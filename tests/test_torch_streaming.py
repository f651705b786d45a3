"""Single-card cohort streaming (raft_tpu_torch/parallel/cohort.py)
against the JAX package and the port's resident kernel path, tolerance
0: `prun_streamed` in one cohort at 64 groups equals JAX `run.run`
(the program tests/test_packing.py compiles on
`kmesh.faulted_64_cfg()`); at 2,048 groups with `cohort_blocks=1` (two
windows, several launches each, with and without the flight ring) it
equals the resident `kernel.prun`; the host store is window-major, the
streamed byte model's budgets hold at their boundaries, and more than
one device is refused."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu.parallel.kmesh import faulted_64_cfg
from raft_tpu.sim import state as jstate
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import kernel, state
from jax_programs import release_jax_programs  # noqa: F401

jrun = importlib.import_module("raft_tpu.sim.run")

JFAULT = faulted_64_cfg()
FAULT = RaftConfig(**{f.name: getattr(JFAULT, f.name)
                      for f in dataclasses.fields(JFAULT)})
PACKED = dict(pack_bools=True, pack_ring=True)


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


@pytest.mark.parametrize("knobs", [
    {}, PACKED, dict(PACKED, alias_wire=True, wire_hist=False)],
    ids=["unpacked", "packed", "all_dials"])
def test_single_cohort_matches_jax_run(knobs):
    cfg = dataclasses.replace(FAULT, stream_groups=True, **knobs)
    sj, mj = jrun.run(JFAULT, jstate.init(JFAULT), 48, 0,
                      jrun.metrics_init(64))
    stats = {}
    st, m = cohort.prun_streamed(cfg, state.init(cfg, device="cpu"), 48,
                                 chunk_ticks=24, stats=stats, device="cpu")
    assert_same(sj, st, "state")
    if cfg.wire_hist:
        assert_same(mj, m, "metrics")
    else:   # no histogram tracked: the base's zeros come back
        assert int(m.hist.sum()) == 0
        assert int(m.elections) == int(mj.elections)
        assert torch.equal(m.committed, torch.from_numpy(
            np.array(mj.committed)))
    assert stats["cohorts"] == 1 and stats["launches"] == 2
    assert stats["wall_s"] > 0 and 0 < stats["overlap_efficiency_measured"]


@pytest.mark.parametrize("flight", [False, True], ids=["no_ring", "ring"])
def test_multi_cohort_matches_the_resident_kernel(flight):
    """2,048 groups in two windows of one block each, three launches per
    window, packed and aliased: the streamed run equals the resident
    `prun` on State, Metrics and the flight rings, and a second stream
    continues the same universe."""
    base = dataclasses.replace(FAULT, n_groups=2048)
    cfg = dataclasses.replace(base, stream_groups=True, cohort_blocks=1,
                              alias_wire=True, **PACKED)
    st0 = state.init(base, device="cpu")
    fl = recorder.flight_init(2048, device="cpu") if flight else None
    res = kernel.prun(base, st0, 24, flight=fl)
    stats = {}
    hw = cohort.host_wire(cfg, st0, flight=fl, device="cpu")
    assert hw.windows == [(0, 1024), (1024, 2048)]
    cohort.stream_ticks(cfg, hw, 0, 24, chunk_ticks=8, stats=stats)
    out = cohort.finish(cfg, hw)
    assert stats["cohorts"] == 2 and stats["launches"] == 6
    assert_equal(res[0], out[0], "state")
    assert_equal(res[1], out[1], "metrics")
    if flight:
        assert_equal(res[2], out[2], "flight")
    more = kernel.prun(base, res[0], 8, 24, res[1], res[2] if flight
                       else None)
    cohort.stream_ticks(cfg, hw, 24, 8)
    again = cohort.finish(cfg, hw)   # acc holds all 32 ticks
    assert_equal(more[0], again[0], "state")
    assert_equal(more[1], again[1], "metrics")
    if flight:
        assert_equal(more[2], again[2], "flight")


def test_host_store_is_window_major():
    """Each window's block is a contiguous [P, window] copy of the
    resident wire's columns, all of them views of one host buffer."""
    cfg = dataclasses.replace(FAULT, n_groups=2500, stream_groups=True,
                              cohort_blocks=1, **PACKED)
    st0 = state.init(cfg, device="cpu")
    hw = cohort.host_wire(cfg, st0, device="cpu")
    (wire, _), _ = kernel.kinit(cfg, st0)
    assert hw.windows == cohort.cohort_windows(cfg, 2500) == \
        [(0, 1024), (1024, 2048), (2048, 2500)]
    base = hw.blocks[0].untyped_storage().data_ptr()
    at = 0
    for (s0, s1), block in zip(hw.windows, hw.blocks):
        assert block.is_contiguous() and block.shape == (wire.shape[0],
                                                         s1 - s0)
        assert block.untyped_storage().data_ptr() == base
        assert block.storage_offset() == at
        assert torch.equal(block, wire[:, s0:s1])
        at += block.numel()
    assert 4 * at == kernel.host_bytes(cfg, 2500, state_on_host=False)


def test_streamed_budgets_and_refusals():
    """The streamed ceiling is host-bound in whole blocks (the host copies
    of `host_bytes`) and 0 when one window's pipeline does not fit the
    card; `supported` holds at its boundaries; more than one device
    raises NotImplementedError."""
    cfg = RaftConfig(seed=42, stream_groups=True, cohort_blocks=98,
                     **PACKED)
    assert kernel.window_groups(cfg) == 100_352
    per = kernel.wire_words_per_group(cfg)
    win = kernel.window_groups(cfg)
    assert kernel.cohort_hbm_bytes(cfg) == \
        4 * win * (4 * per + kernel.working_words_per_group(cfg)) \
        + 8 * kernel.acc_words(cfg)
    hbm, host = 80 * 10 ** 9, 96 * 2 ** 30
    top = kernel.streamed_ceiling_groups(cfg, hbm=hbm, host=host)
    assert top % kernel.GB == 0
    assert kernel.host_bytes(cfg, top) <= host \
        < kernel.host_bytes(cfg, top + kernel.GB)
    assert kernel.supported(cfg, top, hbm=hbm, host=host)
    assert not kernel.supported(cfg, top + kernel.GB, hbm=hbm, host=host)
    # a State on the card leaves the host only the pinned wire
    wire_top = kernel.streamed_ceiling_groups(cfg, hbm=hbm, host=host,
                                              state_on_host=False)
    assert wire_top == host // (4 * per * kernel.GB) * kernel.GB > top
    assert kernel.supported(cfg, wire_top, hbm=hbm, host=host,
                            state_on_host=False)
    small = kernel.cohort_hbm_bytes(cfg) - 1
    assert kernel.streamed_ceiling_groups(cfg, hbm=small, host=host) == 0
    assert not kernel.supported(cfg, 1000, hbm=small, host=host)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cohort.cohort_windows(cfg, 1000, n_devices=2)


def test_fresh_host_wire_is_the_init_of_the_fleet():
    """A fresh fleet built a window at a time (`host_wire` without a
    State, `state.init(first_group=...)` per window) holds the same words
    as the wire of the whole fleet's `state.init`."""
    cfg = dataclasses.replace(FAULT, n_groups=2500, stream_groups=True,
                              cohort_blocks=1, **PACKED)
    whole = cohort.host_wire(cfg, state.init(cfg, device="cpu"),
                             device="cpu")
    fresh = cohort.host_wire(cfg, None, device="cpu", n_groups=2500)
    assert fresh.windows == whole.windows
    for a, b in zip(fresh.blocks, whole.blocks):
        assert torch.equal(a, b)
    assert torch.equal(fresh.acc, whole.acc)
