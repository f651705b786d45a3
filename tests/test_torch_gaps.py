"""The host's gaps between a traced run's spans (`obs.trace.covered`):
inside `kernel.krun` and a streamed window's launches, the time between
one chunk span or heartbeat and the next is a `gap <label>` span, so a
run's chunk spans, heartbeats and gaps sum to its wall exactly. The
clock is a fake one that steps by a known amount at every read, so the
sums are exact integers. No JAX program is compiled."""

from __future__ import annotations

import dataclasses
import itertools

import pytest

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import trace
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import kernel, state

CFG = RaftConfig(seed=5, k=3, log_cap=8, compact_every=4, drop_prob=0.05,
                 crash_prob=0.2, crash_epoch=16)


@pytest.fixture
def fake_clock(monkeypatch, tmp_path):
    """A tracer whose clock advances 7 us at every read, installed with a
    heartbeat; both removed after."""
    ticks = itertools.count(0, 7)
    t = trace.Tracer()
    monkeypatch.setattr(t, "now_us", lambda: float(next(ticks)))
    trace.set_tracer(t)
    trace.set_heartbeat(trace.Heartbeat(str(tmp_path / "hb.jsonl"),
                                        every=1))
    try:
        yield t
    finally:
        trace.set_tracer(None)
        trace.set_heartbeat(None)


def _parts(t):
    out = {}
    for e in t.events:
        if e["ph"] != "X":
            continue
        kind = ("gap" if e["cat"] == trace.CAT_GAP else
                "chunk" if e["name"].startswith("chunk ") else
                "heartbeat" if e["name"].startswith("heartbeat ") else
                "other")
        out.setdefault(kind, []).append(e)
    return out


def _tile(spans):
    """The spans, in time order, touch end to start: (first ts, last
    end)."""
    spans = sorted(spans, key=lambda e: e["ts"])
    for a, b in zip(spans, spans[1:]):
        assert a["ts"] + a["dur"] == b["ts"], (a["name"], b["name"])
    return spans[0]["ts"], spans[-1]["ts"] + spans[-1]["dur"]


def test_krun_spans_gaps_and_heartbeats_sum_to_its_wall(fake_clock):
    t = fake_clock
    leaves, g = kernel.kinit(CFG, state.init(CFG, 8, device="cpu"))
    with trace.span("run"):
        kernel.krun(CFG, leaves, 0, 12, 4, label="r")
    run = [e for e in t.events if e["name"] == "run"][0]
    p = _parts(t)
    assert len(p["chunk"]) == len(p["heartbeat"]) == 3
    assert len(p["gap"]) == 7 and all(e["name"] == "gap r"
                                      for e in p["gap"])
    top = p["chunk"] + p["heartbeat"] + p["gap"]
    t0, t1 = _tile(top)
    assert sum(e["dur"] for e in top) == t1 - t0
    # the run's own span is wider by its two clock reads only
    assert run["ts"] < t0 and t1 < run["ts"] + run["dur"]
    assert run["dur"] - (t1 - t0) == 2 * 7


def test_streamed_window_gaps_cover_its_launches(fake_clock):
    t = fake_clock
    cfg = dataclasses.replace(CFG, stream_groups=True, cohort_blocks=1)
    g = kernel.GB + 20   # two windows
    cohort.prun_streamed(cfg, state.init(cfg, g, device="cpu"), 6,
                         chunk_ticks=3, device="cpu")
    p = _parts(t)
    assert len(p["chunk"]) == 4 and len(p["heartbeat"]) == 2
    for ci in (0, 1):
        label = f"{cohort.ENGINE}:c{ci}"
        gaps = [e for e in p["gap"] if e["name"] == f"gap {label}"]
        mine = [e for e in p["chunk"] if e["args"]["cohort"] == ci] + [
            e for e in p["heartbeat"] if e["name"] == f"heartbeat {label}"]
        assert len(gaps) == 4   # before, between two chunks, before the
        t0, t1 = _tile(gaps + mine)   # heartbeat, after it
        assert sum(e["dur"] for e in gaps + mine) == t1 - t0


def test_nested_blocks_and_no_tracer():
    assert trace.covered("x") is trace._NULL
    t = trace.Tracer()
    trace.set_tracer(t)
    try:
        with trace.covered("outer"):
            with trace.covered("inner"):
                with trace.chunk_span("plain", 0, 1):
                    with trace.chunk_span("plain", 0, 1):   # nested: no gap
                        pass
    finally:
        trace.set_tracer(None)
    gaps = [e["name"] for e in t.events if e["cat"] == trace.CAT_GAP]
    assert gaps == ["gap outer", "gap outer"]
    assert trace.validate_trace(t.to_json()) == []
