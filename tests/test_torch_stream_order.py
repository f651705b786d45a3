"""The streamed pipeline's accumulator on the stream that uses it
(`parallel/cohort.py`, `sim/streams.py`, `verify/hazards.py`): a
shard's first accumulator comes from `kernel.kinit` on its card's
current stream, and when shards share a card their launches run on
streams of their own, so the driver marks it for the shard's stream
(`record_stream`) before the first launch's output replaces it. The
CPU capture shows that order; the prover catches the free without it,
at the line that drops it; an observed capture sees `kinit`'s pair
allocated through the table. No JAX program is compiled."""

from __future__ import annotations

import dataclasses
import os

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import kernel, state
from raft_tpu_torch.verify import hazards


def _acc_events(events, serial):
    return [(e.kind, e.stream, e.site) for e in events
            if serial in e.buffers]


def test_shared_card_accumulator_is_recorded_before_its_free():
    cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=1)
    mesh = (torch.device("cuda", 0),) * 2
    g = 2 * kernel.window_groups(cfg, 2)
    events = []
    with hazards.capture(events) as rec:
        hw = hazards._fake_wire(cfg, g, mesh, rec)
        firsts = [rec._buf(a) for a in hw.accs]
        cohort.stream_ticks(cfg, hw, 0, 2, 1)
    assert hazards.check_trace(events, g) == []
    for serial in firsts:
        kinds = _acc_events(events, serial)
        assert [k for k, _, _ in kinds] == ["alloc", "record_stream",
                                            "launch", "free"], kinds
        alloc, rec_s, launch, free = kinds
        assert alloc[1] == "cuda:0/default" != rec_s[1] == launch[1]
        assert rec_s[2].startswith("cohort.py:") \
            and free[2].startswith("cohort.py:")


def test_lone_shard_accumulator_needs_no_record_stream():
    cfg = RaftConfig(seed=0, k=3, stream_groups=True, cohort_blocks=1)
    g = 2 * kernel.window_groups(cfg)
    events = hazards.run_real(cfg, g, hazards.meshes(1)["card"], passes=1)
    assert hazards.check_trace(events, g) == []
    assert hazards.counts(events)["record_streams"] == 2   # the drains'


def test_accumulator_negative_named_at_its_line():
    events, g, passes = hazards.negative_trace("acc_no_record_stream")
    found = [h for h in hazards.check_trace(events, g, passes)
             if h.rule == "cross-stream-free"]
    assert found
    fname, _, line = found[0].site.rpartition(":")
    assert os.path.basename(fname) == "hazards.py"
    src = open(hazards.__file__).read().splitlines()[int(line) - 1]
    assert "cs.kstep(cfg, (d, hw.accs[j])" in src, src
    assert "default" in found[0].detail
    rep = hazards.prove_negatives()
    assert rep["caught"] == len(hazards.NEGATIVES) == 7


def test_observed_capture_sees_kinit_allocations():
    cfg = RaftConfig(seed=3, k=3, log_cap=8, compact_every=4)
    scfg = dataclasses.replace(cfg, stream_groups=True, cohort_blocks=1)
    g = kernel.GB + 40
    st = state.init(cfg, g, device="cpu")
    events = []
    with hazards.capture(events, observe=True):
        cohort.prun_streamed(scfg, st, 2, device="cpu")
    allocs = [e for e in events if e.kind == "alloc"
              and e.site.startswith("cohort.py:")]
    # one wire pair per window's slice, from host_wire's kinit
    assert len(allocs) == 2 * 2
    assert hazards.check_trace(events, g) == []
