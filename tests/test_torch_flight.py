"""The port's flight recorder (raft_tpu_torch.obs.recorder) against the
JAX package's, tolerance 0, on tests/test_obs.py's universe at the
shapes it compiles (`run_recorded` over 40 ticks, and 24 then 16):
State, Metrics and the six rings of `run_recorded`, a resumed recording,
the rings through the kernel wrapper on CPU tensors (`kinit(flight=)`,
chunked `kstep`, `kflight`, `prun(flight=)`), and the host-side rows
and dump. A client universe's rings through the wrapper equal the
port's own `run_recorded`."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu import sim as jsim
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.obs import recorder as jrecorder
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.sim import kernel, state

OBS = dict(n_groups=8, k=3, seed=21, drop_prob=0.05, crash_prob=0.2,
           crash_epoch=16, log_cap=8, compact_every=4)
JCFG, CFG = JaxConfig(**OBS), RaftConfig(**OBS)


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def recorded():
    """JAX `run_recorded` over 40 ticks, and over 24 then 16, as
    tests/test_obs.py runs them."""
    st0 = jsim.init(JCFG)
    full = jobs.run_recorded(JCFG, st0, 40)
    st2, m2, f2 = jobs.run_recorded(JCFG, st0, 24)
    return full, (st2, m2, f2), jobs.run_recorded(JCFG, st2, 16, 24, m2, f2)


def test_run_recorded_matches_jax(recorded):
    sj, mj, fj = recorded[0]
    st, m, f = recorder.run_recorded(CFG, state.init(CFG, device="cpu"), 40)
    for want, got, what in ((sj, st, "state"), (mj, m, "metrics"),
                            (fj, f, "flight")):
        assert_same(want, got, what)
    rows = recorder.flight_rows(f)
    assert rows == jobs.flight_rows(fj)
    assert len(rows) == 40 and sum(r["elections"] for r in rows) > 0
    assert all(r["unsafe_groups"] == 0 for r in rows)


def test_flight_init_matches_jax():
    assert_same(jobs.flight_init(5), recorder.flight_init(5, device="cpu"),
                "flight_init")
    assert recorder.FLIGHT_LEAVES == jrecorder.FLIGHT_LEAVES
    assert recorder.PRESENCE_FIELDS == jrecorder.PRESENCE_FIELDS
    assert recorder.RING == jrecorder.RING


def test_resumed_recording_matches_jax(recorded):
    """24 + 16 ticks on the port from init, and 16 more ticks on the port
    from the JAX recording carried across at tick 24, both equal the JAX
    continuation."""
    (sj, mj, fj), (sj24, mj24, fj24) = recorded[2], recorded[1]
    st, m, f = recorder.run_recorded(CFG, state.init(CFG, device="cpu"), 24)
    st, m, f = recorder.run_recorded(CFG, st, 16, 24, m, f)
    for want, got, what in ((sj, st, "state"), (mj, m, "metrics"),
                            (fj, f, "flight")):
        assert_same(want, got, what)
    carried = [state.from_numpy(jax.tree.map(np.asarray, x), device="cpu")
               for x in (sj24, mj24, fj24)]
    st, m, f = recorder.run_recorded(CFG, carried[0], 16, 24, *carried[1:])
    assert_same(fj, f, "flight resumed from the carried recording")
    assert_same(sj, st, "state resumed from the carried recording")


def test_kernel_wrapper_carries_the_flight(recorded):
    sj, mj, fj = recorded[0]
    st0 = state.init(CFG, device="cpu")
    leaves, g = kernel.kinit(CFG, st0,
                             flight=recorder.flight_init(8, device="cpu"))
    for at, n in ((0, 17), (17, 23)):
        leaves = kernel.kstep(CFG, leaves, at, n)
    st, m = kernel.kfinish(CFG, leaves, g)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert_same(fj, kernel.kflight(CFG, leaves, g), "flight")
    out = kernel.prun(CFG, st0, 40, flight=recorder.flight_init(8,
                                                                device="cpu"))
    assert len(out) == 3
    assert_same(fj, out[2], "prun flight")
    assert kernel.kflight(CFG, kernel.kinit(CFG, st0)[0], g) is None


def test_dump_flight_prints_the_jax_rows(recorded):
    fj = recorded[0][2]
    f = state.from_numpy(jax.tree.map(np.asarray, fj), device="cpu")
    got, want = [], []
    rows = recorder.dump_flight(f, 5, label="t", log=got.append)
    assert rows == jobs.dump_flight(fj, 5, label="t", log=want.append)
    assert got == want and len(got) == 41


def test_kernel_wrapper_flight_with_clients_matches_run_recorded():
    """Client lanes and the flight ring on one wire (no JAX: the port's
    own `run_recorded` is held to the reference above and in
    test_torch_clients.py)."""
    cfg = RaftConfig(n_groups=12, k=3, seed=29, log_cap=8, compact_every=4,
                     sessions=True, cmds_per_tick=0, client_rate=0.3,
                     client_slots=3, client_retry_backoff=5, drop_prob=0.05,
                     crash_prob=0.2, crash_epoch=16, partition_prob=0.2,
                     partition_epoch=16, client_queue_cap=2)
    st0 = state.init(cfg, device="cpu")
    want = recorder.run_recorded(cfg, st0, 70)
    leaves, g = kernel.kinit(cfg, st0,
                             flight=recorder.flight_init(12, device="cpu"))
    for at, n in ((0, 30), (30, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
    got = kernel.kfinish(cfg, leaves, g) + (kernel.kflight(cfg, leaves, g),)
    for a, b in zip(want, got):
        ok, why = trees_equal_why(state.to_numpy(a), state.to_numpy(b))
        assert ok, why
    assert kernel.kacked(cfg, leaves, g) > 0
