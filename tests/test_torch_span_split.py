"""`scripts/torch_span_split.py`: the idle card of a benchmark cell's
universes split by the program's spans. Its readers on a hand-written
Chrome trace (two universes, program spans, device ops, the host's
launch and synchronising calls) give hand-computed values, and the
split sums to the unsplit idle total; on the CPU (the plain tick in the
kernel's place) a short run of each cell carries every span it must and
the tracer changes no synchronising call; on a card (`-m cuda`) every
profiled universe of a short run carries every span, the kernel's
`kstep alloc` and `kstep launch` included. Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_span_split.py
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from raftbench import spec

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_span_split as split  # noqa: E402

CELLS = ("raft5.steady", "raft5-sessions.clients-jepsen")
SEED = 2 ** 31 + 12345


def X(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _universe(at: float, init_kernel: bool, flight: bool) -> list:
    """One universe of 100 us from `at`: phases, program spans, device
    ops on card 0, host calls."""
    P = split.PHASE_PREFIX
    R = "raft_tpu_torch."
    ev = [X(split.UNIVERSE, "user_annotation", at, 100),
          X(P + "init", "user_annotation", at, 30),
          X(P + "prun", "user_annotation", at + 30, 60),
          X(P + "fetch", "user_annotation", at + 90, 10)]
    spans = [("state.init", 2, 18), ("run.metrics_init", 20, 5),
             ("recorder.flight_init", 25, 3), ("prun", 32, 56),
             ("kinit", 33, 12), ("run.metrics_init", 34, 2),
             ("kinit encode", 36, 8), ("chunk cuda [0,600)", 46, 4),
             ("kstep alloc", 46, 1), ("kstep launch", 47, 2),
             ("kfinish", 52, 28), ("kfinish overflow check", 52, 1),
             ("kfinish decode", 55, 24)] + (
                 [("kflight", 81, 5)] if flight else [])
    ev += [X(R + n, "user_annotation", at + a, d) for n, a, d in spans]
    ops = ([("fill", "kernel", 10, 5)] if init_kernel else []) + [
        ("cat", "kernel", 40, 4), ("fused_chunk_kernel", "kernel", 48, 44),
        ("Memcpy DtoH", "gpu_memcpy", 93, 4)]
    ev += [X(n, c, at + a, d, device=0) for n, c, a, d in ops]
    calls = ([("cudaLaunchKernel", 10)] if init_kernel else []) + [
        ("cudaMemsetAsync", 21), ("cuLaunchKernel", 29),
        ("cudaLaunchKernel", 37), ("cudaLaunchKernelExC", 47.5),
        ("cudaDeviceSynchronize", 53), ("cudaMemcpyAsync", 91),
        ("cudaStreamSynchronize", 95)]
    ev += [X(n, "cuda_runtime", at + a, 0.5) for n, a in calls]
    return ev


def test_readers_on_a_hand_written_trace():
    obj = {"traceEvents": _universe(0, True, True)
           + _universe(200, False, False)}
    rows = split.per_universe(split.read_trace(obj), [0])
    first = {"init": 4, "init/state.init": 13, "init/run.metrics_init": 5,
             "init/recorder.flight_init": 3, "prun": 2, "prun/prun": 2,
             "prun/kinit": 2, "prun/run.metrics_init": 2,
             "prun/kinit encode": 4, "prun/kstep alloc": 1,
             "prun/kstep launch": 1, "fetch": 4}
    assert rows[0]["idle"] == pytest.approx(first)
    # without the init kernel, [10, 15) is idle too, in state.init
    assert rows[1]["idle"] == pytest.approx(
        dict(first, **{"init/state.init": 18}))
    for r, total in zip(rows, (43, 48)):
        assert r["idle_total"] == pytest.approx(total)
        assert sum(r["idle"].values()) == pytest.approx(total)
    assert [r["init_idle"] for r in rows] == pytest.approx([21, 26])
    assert [r["boundary_idle"] for r in rows] == pytest.approx([12, 12])
    # the launches inside the top-level init spans and prun: not the
    # one before the spans, nor the fetch's copy
    assert [r["launches"] for r in rows] == [4, 3]
    assert rows[0]["syncs"] == {"init": 0, "prun": 1, "fetch": 1}
    s = split.summarize(rows, [100.0, 100.0])
    assert s["init_idle_ms"] == pytest.approx((21 + 0.9 * 5) / 1e3)
    assert s["boundary_idle_ms"] == pytest.approx(0.012)
    assert s["host_launches_per_universe"] == 3.5
    assert s["idle_split_sum_ms"] == pytest.approx(s["idle_total_ms"])
    assert s["idle_total_ms"] == pytest.approx(45.5 / 1e3)
    assert s["busy_ms_per_universe"] == pytest.approx((100 - 45.5) / 1e3)
    need = split.required_spans(spec.cell(CELLS[0]), on_card=True)
    assert "chunk cuda [0,600)" in need and "kstep launch" in need
    missing = [sorted(set(need) - set(r["spans"])) for r in rows]
    assert missing == [[], ["kflight"]]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert split.main(["--workload", CELLS[0], "--seed", "1"]) == 2


def _short(name: str, groups: int, ticks: int):
    return dataclasses.replace(spec.cell(name), groups=groups, ticks=ticks)


def _check(out: dict, universes: int) -> None:
    """A short run's readings: no fault, every kind's universes run, the
    split idle summing to the total, and the program's labels only with
    the tracer on."""
    assert split.faults(out) == [] and out["missing_spans"] == {}
    assert [out["kinds"][k]["universes"] for k in split.KINDS] == [
        universes * out["rounds"]] * len(split.KINDS)
    on = out["kinds"]["profiled-on"]
    assert on["idle_split_sum_ms"] == pytest.approx(on["idle_total_ms"])
    assert any(k.startswith("prun/kinit") for k in on["idle_ms_per_universe"])
    off = out["kinds"]["profiled-off"]
    assert not [k for k in off["idle_ms_per_universe"] if "/" in k]


@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_cpu(name):
    cell = _short(name, 8, 6)
    out = split.measure(cell, SEED, 1, 1, devices=["cpu"], warmup=False)
    assert out["device"] == "cpu"
    assert "chunk plain [0,6)" in out["required_spans"]
    _check(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_every_traced_universe_carries_every_span_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cell = _short(name, 2_000, 60)
    out = split.measure(cell, SEED, 3, 1)
    assert "kstep launch" in out["required_spans"]
    _check(out, 3)
    on = out["kinds"]["profiled-on"]
    assert on["host_launches_per_universe"] >= 1
    assert on["busy_ms_per_universe"] > 0
