"""The check fails what it must: the control (the reference with election
safety broken, in the program's place) and the program with its timed
path broken underneath, each driven through a whole run on the CPU (the
harness's look for a card skipped), must come out not correct. The faults
a cell can have: a step that returns its state unchanged; half of the
batch left out; (sharded cells) the exchange between cards left out; an
answer altered where it is produced.

    python -m pytest raftbench/tests -q
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from raftbench import control, run, spec
from raftbench.runner import tree_leaves
from raftbench.system import System
from raft_tpu_torch.parallel import kmesh
from raft_tpu_torch.sim import kernel

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def tiny(name: str, groups: int = 8, ticks: int = 40) -> spec.Cell:
    c = spec.cell(name)
    return dataclasses.replace(c, groups=groups * c.chips, ticks=ticks)


def tiny_sharded(groups: int = 4, ticks: int = 40) -> spec.Cell:
    """The sharded cell, raft5.steady.x4, at `groups` a device."""
    return tiny("raft5.steady.x4", groups, ticks)


def _run(cell, seed, system_cls, **kw):
    """One run of one window universe (no warm-up) on the CPU."""
    return run.run_cell(cell, seed, 0.0, False, devices=["cpu"] * cell.chips,
                        system_cls=system_cls, warmup=False, **kw)


@contextlib.contextmanager
def patched(obj, name, value):
    keep = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, keep)


class StateUnchanged(System):
    """prun returns its inputs: no tick ran."""

    def prun(self, st, m, f):
        return st, m, f


class HalfBatch(System):
    """The second half of the groups is left out: it keeps its start."""

    def prun(self, st, m, f):
        h = self.groups // 2
        keep = [{k: v.clone() for k, v in tree_leaves(t).items()}
                for t in (st, m, f)]
        out = super().prun(st, m, f)
        for t, before in zip(out, keep):
            for k, v in tree_leaves(t).items():
                if k in ("hist", "elections", "max_latency", "client_hist",
                         "client_max_lat"):
                    continue
                if t is out[2]:
                    v[:, h:] = before[k][:, h:]
                else:
                    v[h:] = before[k][h:]
        return out


class NoExchange(System):
    """The gather to the first card takes the first shard only: the
    others' wires and accumulators never arrive."""

    def prun(self, st, m, f):
        def gather(cfg, shards, device):
            wire, acc = shards[0]
            g = sum(w.shape[1] for w, _ in shards)
            whole = torch.zeros((wire.shape[0], g), dtype=wire.dtype,
                                device=device)
            whole[:, :wire.shape[1]].copy_(wire)
            return whole, kmesh.reduce_acc(cfg, [acc], device)

        with patched(kmesh, "gather", gather):
            return super().prun(st, m, f)


class AnswerAltered(System):
    """Every launch's committed lane comes out one too high."""

    def prun(self, st, m, f):
        step = kernel.kstep

        def kstep(cfg, leaves, t0, n_ticks):
            out = step(cfg, leaves, t0, n_ticks)
            kernel.klane(cfg, out, out[0].shape[1], "committed").add_(1)
            return out

        with patched(kernel, "kstep", kstep):
            return super().prun(st, m, f)


FAULTS = {"unchanged": StateUnchanged, "half": HalfBatch,
          "altered": AnswerAltered}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["raft5.steady",
                                  "raft5-sessions.clients-jepsen"])
def test_a_broken_timed_path_is_not_correct(name, fault, seed):
    out = _run(tiny(name), seed, FAULTS[fault], samples_per_universe=8)
    assert out["correct"] is False
    assert out["checks"]["groups_mismatched"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "exchange"])
def test_a_broken_sharded_path_is_not_correct(fault, seed):
    broken = dict(FAULTS, exchange=NoExchange)[fault]
    out = _run(tiny_sharded(), seed, broken,
               samples_per_universe=16)
    assert out["correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
def test_the_sound_program_is_correct_on_the_same_sizes(seed):
    for name in ("raft5.steady", "raft5-sessions.clients-jepsen"):
        assert _run(tiny(name), seed, System,
                    samples_per_universe=8)["correct"] is True
    assert _run(tiny_sharded(), seed, System,
                samples_per_universe=16)["correct"] is True


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["raft5.steady",
                                  "raft5-sessions.clients-jepsen"])
def test_the_control_is_not_correct(name, seed):
    out = _run(tiny(name, groups=64), seed, control.ControlSystem,
               samples_per_universe=32)
    assert out["correct"] is False
    assert out["checks"]["groups_mismatched"]["value"] > 0
