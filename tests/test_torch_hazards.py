"""The stream-ordering hazard prover (raft_tpu_torch/verify/hazards.py):
the real streamed loops, captured through the stream table
(sim/streams.py) with fakes on CPU tensors, are hazard-free over the
JAX package's grid; each synthetic scheduler with one ordering edge
removed is caught by its rule at a line of hazards.py; the put and drain
ranges tile the fleet as the JAX package's captured trace does; and an
observed capture changes no result. No XLA program is compiled: the
JAX package's prover stubs its seams (its import builds one scalar
conversion)."""

from __future__ import annotations

import dataclasses
import os

import pytest

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import kernel, state, streams
from raft_tpu_torch.utils.trees import trees_equal
from raft_tpu_torch.verify import hazards


def test_real_schedulers_prove_clean():
    rep = hazards.prove_schedulers()
    assert rep["hazards"] == [], rep["hazards"][:5]
    assert rep["configs"] >= 90 and rep["events"] > 0
    c = rep["counts"]
    assert c["h2d"] == c["d2h"] > 0 and c["launches"] > c["h2d"]
    assert c["waits"] > 0 and c["record_streams"] > 0 \
        and c["host_syncs"] > 0


@pytest.mark.parametrize("name,drop,rule", hazards.NEGATIVES,
                         ids=[n for n, _, _ in hazards.NEGATIVES])
def test_negative_caught_at_its_line(name, drop, rule):
    """Each buggy scheduler is caught under its own rule, at a line of
    hazards.py that issues the offending operation."""
    events, g, passes = hazards.negative_trace(name)
    found = [h for h in hazards.check_trace(events, g, passes)
             if h.rule == rule]
    assert found, f"{name}: no {rule} hazard"
    fname, _, line = found[0].site.rpartition(":")
    assert os.path.basename(fname) == "hazards.py" and line.isdigit()
    src = open(hazards.__file__).read().splitlines()[int(line) - 1]
    assert "cs." in src or "pending = {}" in src, src


def test_prove_negatives_catches_all():
    rep = hazards.prove_negatives()
    assert rep["missed"] == [] and rep["caught"] == len(hazards.NEGATIVES)
    assert set(rep["rules"].values()) == {r for _, _, r in hazards.NEGATIVES}


@pytest.mark.parametrize("cb,nd,nw", [(1, 1, 1), (1, 1, 3), (2, 2, 2),
                                      (3, 2, 1), (1, 4, 2)])
def test_tiling_matches_reference_trace(cb, nd, nw):
    """At a grid point, the port's h2d and d2h copies move exactly the
    windows the JAX package's captured trace puts and drains (its
    sublanes x 128 groups), each window's device slices tiling it."""
    from raft_tpu.config import RaftConfig as RefConfig
    from raft_tpu.sim.pkernel import LANE
    from raft_tpu.verify import hazards as ref

    rcfg = RefConfig(seed=0, k=3, stream_groups=True, cohort_blocks=cb)
    gs = ref.pkernel_step(rcfg, nd) * nw
    rev = ref._run_real(rcfg, gs, nd, staging=True)
    want = {kind: sorted((a * LANE, b * LANE) for a, b in
                         {e.win for e in rev if e.kind == kind})
            for kind in ("put", "drain")}
    cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=cb)
    g = gs * LANE
    mesh = hazards.meshes(nd)["card" if nd == 1 else "cards"]
    ev = hazards.run_real(cfg, g, mesh, passes=1)
    assert hazards.check_trace(ev, g) == []
    wins = cohort.cohort_windows(cfg, g, nd)
    for kind, ref_kind in (("h2d", "put"), ("d2h", "drain")):
        slices = sorted(e.groups for e in ev if e.kind == kind)
        covered = sorted({w for w in wins for s in slices
                          if w[0] <= s[0] < w[1]})
        assert covered == want[ref_kind]
        for w0, w1 in wins:
            mine = [s for s in slices if w0 <= s[0] < w1]
            assert mine[0][0] == w0 and mine[-1][1] == w1
            assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))


def test_observed_capture_changes_nothing():
    """An observed capture makes every call it records: the CPU streamed
    pipeline under it gives the uncaptured run's bits, and its trace is
    hazard-free with one h2d and one d2h per window."""
    cfg = RaftConfig(seed=3, k=3, log_cap=8, compact_every=4,
                     drop_prob=0.05, crash_prob=0.2, crash_epoch=16)
    scfg = dataclasses.replace(cfg, stream_groups=True, cohort_blocks=1)
    g = kernel.GB + 200
    st = state.init(cfg, g, device="cpu")
    plain = cohort.prun_streamed(scfg, st, 4, chunk_ticks=2, device="cpu")
    events = []
    with hazards.capture(events, observe=True):
        seen = cohort.prun_streamed(scfg, st, 4, chunk_ticks=2,
                                    device="cpu")
    assert trees_equal(plain, seen)
    assert hazards.check_trace(events, g) == []
    n = hazards.counts(events)
    assert n["h2d"] == n["d2h"] == 2 and n["launches"] == 4


def test_capture_restores_the_table():
    real = streams.cuda
    with pytest.raises(RuntimeError):
        with hazards.capture([]):
            assert streams.cuda is not real
            raise RuntimeError("boom")
    assert streams.cuda is real


def test_check_trace_names_a_coverage_gap():
    cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=1)
    g = 2 * kernel.GB
    ev = hazards.run_real(cfg, g, hazards.meshes(1)["card"], passes=1)
    rules = {h.rule for h in hazards.check_trace(ev, g + 1)}
    assert rules == {"put-coverage", "drain-coverage"}
