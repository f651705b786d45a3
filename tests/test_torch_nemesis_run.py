"""The port's tick, loop and kernel wrapper under nemesis programs against
the JAX package, tolerance 0, on the programs tests/test_nemesis.py
compiles (so the suite's compile cache serves both files):

- the all-kinds program over 120 ticks at 8 groups (`trace`, as
  `obs.triage.oracle_divergence` runs it): the port's per-tick
  `step.tick` states against the `[T, G, K]` observables, and the final
  State;
- the gray mix (`run.run` over 40 ticks and its 40-tick continuation,
  one program):
  full State and Metrics of `run.run`, `kernel.prun` and chunked
  `kstep` on CPU tensors;
- the pressure mix with bounded-admission clients (`run.run` over 48
  ticks at 16 groups): full State and Metrics of `run.run` and
  `kernel.prun` on CPU tensors, with sheds and a clean exactly-once
  report."""

from __future__ import annotations

import importlib

import jax
import numpy as np
import pytest

from raft_tpu import nemesis as jnem
from raft_tpu import sim as jsim
from raft_tpu.clients import exactly_once_report as jexactly_once_report
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch import nemesis
from raft_tpu_torch.clients import workload
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, run, state
from test_torch_nemesis import ADMISSION, BASE, all_kinds, port_trace

jrun = importlib.import_module("raft_tpu.sim.run")


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


def test_all_kinds_per_tick_observables_and_state():
    ticks, g = 120, 8
    jcfg = JaxConfig(**BASE, nemesis=all_kinds(jnem, ticks))
    sj, obs = jrun.trace(jcfg, jsim.init(jcfg, n_groups=g), ticks)
    cfg = RaftConfig(**BASE, nemesis=all_kinds(nemesis, ticks))
    st, mine = port_trace(cfg, g, ticks)
    assert set(obs) == set(mine) - {"rng_draws"}
    for f, want in obs.items():
        want = np.asarray(want)
        got = mine[f].astype(want.dtype)
        if not np.array_equal(got, want):
            t, gi, k = (int(x) for x in np.argwhere(got != want)[0])
            pytest.fail(f"{f} diverges at tick {t}, group {gi}, node {k}: "
                        f"port {got[t, gi, k]}, JAX {want[t, gi, k]}")
    assert_same(sj, st, "final state")
    assert int(mine["term"].max()) > 2 and int(mine["commit"].max()) > 0


@pytest.fixture(scope="module")
def gray():
    """JAX `run.run` on the gray mix, 40 ticks as tests/test_nemesis.py's
    checkpoint test runs it, then 40 more through the same program."""
    jcfg = JaxConfig(**BASE, nemesis=jnem.gray_mix(80))
    sj, mj = jrun.run(jcfg, jsim.init(jcfg, n_groups=8), 40, 0,
                      jrun.metrics_init(8))
    cont = jrun.run(jcfg, sj, 40, 40, mj)
    cfg = RaftConfig(**BASE, nemesis=nemesis.gray_mix(80))
    return cfg, (sj, mj), cont


def test_gray_mix_run_and_continuation(gray):
    cfg, (sj, mj), (sj2, mj2) = gray
    st, m = run.run(cfg, state.init(cfg, 8, device="cpu"), 40, 0,
                    run.metrics_init(8, device="cpu"))
    assert_same(sj, st, "state, 40 ticks")
    assert_same(mj, m, "metrics, 40 ticks")
    st2, m2 = run.run(cfg, st, 40, 40, m)
    assert_same(sj2, st2, "state, 80 ticks")
    assert_same(mj2, m2, "metrics, 80 ticks")
    assert run.unsafe_groups(m2) == 0 and int(m2.elections) > 0


def test_gray_mix_kernel_wrapper_on_cpu(gray):
    cfg, (sj, mj), (sj2, mj2) = gray
    st0 = state.init(cfg, 8, device="cpu")
    st, m = kernel.prun(cfg, st0, 40, 0, run.metrics_init(8, device="cpu"))
    assert_same(sj, st, "prun state")
    assert_same(mj, m, "prun metrics")
    leaves, g = kernel.kinit(cfg, st0)
    for at, n in ((0, 17), (17, 23), (40, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
    st2, m2 = kernel.kfinish(cfg, leaves, g)
    assert_same(sj2, st2, "chunked kstep state")
    assert_same(mj2, m2, "chunked kstep metrics")


@pytest.fixture(scope="module")
def pressure():
    """JAX `run.run` on test_nemesis.py's `_admission_cfg(48)`, 16 groups."""
    jcfg = JaxConfig(**ADMISSION, nemesis=jnem.pressure_mix(48))
    sj, mj = jrun.run(jcfg, jsim.init(jcfg, n_groups=16), 48, 0,
                      jrun.metrics_init(16, clients=True))
    cfg = RaftConfig(**ADMISSION, nemesis=nemesis.pressure_mix(48))
    return jcfg, cfg, (sj, mj)


@pytest.mark.parametrize("engine", ["run", "prun"])
def test_pressure_mix_with_admission(pressure, engine):
    jcfg, cfg, (sj, mj) = pressure
    st0 = state.init(cfg, 16, device="cpu")
    m0 = run.metrics_init(16, clients=True, device="cpu")
    fn = run.run if engine == "run" else kernel.prun
    st, m = fn(cfg, st0, 48, 0, m0)
    assert_same(sj, st, f"{engine} state")
    assert_same(mj, m, f"{engine} metrics")
    assert run.unsafe_groups(m) == 0
    assert int(st.clients.shed.sum()) > 0, "nothing shed: the cap is untested"
    ok, why = workload.exactly_once_report(cfg, st, m)
    assert ok, why
    assert (ok, why) == jexactly_once_report(jcfg, sj, mj)
