"""The port's loop and kernel wrapper with scheduled clients against the
JAX package, tolerance 0, at the shapes tests/test_clients.py compiles
(`clients_64_cfg()`: `run.run` over 120 ticks, and the admission-capped
universe over 24): full State and Metrics of `run.run` and of chunked
`kinit`/`kstep`/`kfinish` on CPU tensors, the wire's `kacked`/`kretries`
against JAX's `total_client_ops`/`total_client_retries`, the client
readouts, and `exactly_once_report`'s verdicts on clean and corrupted
states."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu import sim as jsim
from raft_tpu.clients import clients_64_cfg
from raft_tpu.clients import workload as jworkload
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.clients import workload
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, run, state

jrun = importlib.import_module("raft_tpu.sim.run")

JCFG = clients_64_cfg()
CFG = RaftConfig(**{f.name: getattr(JCFG, f.name)
                    for f in dataclasses.fields(JCFG)})
TICKS = 120


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def run120():
    """JAX `run.run` over 120 ticks, as tests/test_clients.py runs it."""
    return jrun.run(JCFG, jsim.init(JCFG), TICKS)


def test_run_matches_jax_run(run120):
    sj, mj = run120
    st, m = run.run(CFG, state.init(CFG, device="cpu"), TICKS)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert run.total_client_ops(m) == jrun.total_client_ops(mj) > 0
    assert run.total_client_retries(m) == jrun.total_client_retries(mj) > 0
    assert run.unsafe_groups(m) == 0
    for q in (0.5, 0.99):
        assert run.latency_quantile(m.client_hist, q) == \
            jrun.latency_quantile(mj.client_hist, q)
        assert run.latency_censored(m.client_hist, q) == \
            jrun.latency_censored(mj.client_hist, q)


def test_chunked_kstep_counts_match_jax(run120):
    sj, mj = run120
    leaves, g = kernel.kinit(CFG, state.init(CFG, device="cpu"))
    at = 0
    for n in (40, 33, 47):
        leaves = kernel.kstep(CFG, leaves, at, n)
        at += n
    st, m = kernel.kfinish(CFG, leaves, g)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert kernel.kacked(CFG, leaves, g) == jrun.total_client_ops(mj)
    assert kernel.kretries(CFG, leaves, g) == jrun.total_client_retries(mj)
    np.testing.assert_array_equal(
        kernel.khist(CFG, leaves, g, name="client_hist"),
        np.asarray(mj.client_hist))
    np.testing.assert_array_equal(kernel.khist(CFG, leaves, g),
                                  np.asarray(mj.hist))


def test_admission_capped_run_matches_jax_and_sheds():
    """cap 2, 24 ticks: tests/test_clients.py's admission universe."""
    jcfg = dataclasses.replace(JCFG, client_queue_cap=2)
    cfg = dataclasses.replace(CFG, client_queue_cap=2)
    sj, mj = jrun.run(jcfg, jsim.init(jcfg), 24)
    st0 = state.init(cfg, device="cpu")
    st, m = run.run(cfg, st0, 24)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert int(st.clients.shed.sum()) > 0, "nothing shed - the cap is untested"
    st2, m2 = kernel.prun(cfg, st0, 24)
    assert_same(sj, st2, "kernel.prun state")
    assert_same(mj, m2, "kernel.prun metrics")
    assert workload.exactly_once_report(cfg, st, m) == \
        jworkload.exactly_once_report(jcfg, sj, mj)


def _corrupt(tree, kind):
    """A numpy State / Metrics pair with one exactly-once accounting
    broken."""
    st, m = tree
    table = np.array(st.nodes.session_seq)
    applied = np.array(st.nodes.applied)
    if kind == "phantom":
        table[:, 0, 0] = st.clients.done[:, 0] + 7
    elif kind == "divergent":
        applied[:, 1] = applied[:, 0]
        table[:, 1, 0] = table[:, 0, 0] - 1
    elif kind == "lagging":
        top = applied.argmax(axis=1)
        table[np.arange(len(top)), top, 0] = -5
    elif kind == "acked":
        m = m._replace(client_acked=np.asarray(m.client_acked) + 1)
    nodes = st.nodes._replace(session_seq=table, applied=applied)
    return st._replace(nodes=nodes), m


@pytest.mark.parametrize("kind", ["clean", "phantom", "divergent", "lagging",
                                  "acked"])
def test_exactly_once_report_verdicts_match_jax(run120, kind):
    sj, mj = _corrupt(jax.tree.map(np.asarray, run120), kind)
    st = state.from_numpy(sj, device="cpu")
    m = state.from_numpy(mj, device="cpu")
    want = jworkload.exactly_once_report(JCFG, sj, mj)
    assert workload.exactly_once_report(CFG, st, m) == want
    assert want[0] == (kind == "clean"), want
    assert workload.workload_params(CFG) == jworkload.workload_params(JCFG)
