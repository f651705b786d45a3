"""scripts/torch_kernel_sweep.py against the JAX package's
scripts/kernel_sweep.py: the same covering array and the same universes,
field for field, on the plain, --clients, --packed and --nemesis axes
(the reference's module only builds configs here: nothing is compiled);
a broken covering array raises; the sweep's CPU plumbing (the plain
engine in the kernel's place) exits 0, and 1 naming the universe when
a bit of the engine's output is flipped."""

from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.sim import kernel

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
sweep = importlib.import_module("torch_kernel_sweep")
ref = importlib.import_module("kernel_sweep")


def _fields(cfg) -> dict:
    """A config's fields, its nemesis program as clause tuples."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["nemesis"] = [tuple(c) for c in cfg.nemesis]
    return out


def test_covering_array_is_the_reference():
    assert sweep.FACTORS == ref.FACTORS and sweep.ROWS == ref.ROWS
    sweep._check_pairwise(sweep.ROWS)
    broken = sweep.ROWS[:1] + tuple(
        r[:4] + (0,) for r in sweep.ROWS[1:])   # partition never on
    with pytest.raises(AssertionError, match="partition"):
        sweep._check_pairwise(broken)


@pytest.mark.parametrize("axis", [{}, {"clients": True}, {"packed": True},
                                  {"clients": True, "packed": True}],
                         ids=["plain", "clients", "packed", "both"])
def test_sweep_configs_equal_the_reference(axis):
    mine = list(sweep.sweep_configs(1000, **axis))
    theirs = list(ref.sweep_configs(1000, **axis))
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        assert _fields(a) == _fields(b)


def test_nemesis_cells_equal_the_reference(monkeypatch):
    """The reference's nemesis cells, caught at their oracle check (no
    engine runs: a recorded divergence moves it to the next cell)."""
    import raft_tpu.obs.triage as rtriage
    seen = []

    def caught(cfg, n_groups, ticks, oracle_groups=None):
        seen.append((cfg, ticks))
        return {"tick": 0, "group": 0, "node": 0, "field": "x", "cpu": 0,
                "jax": 1}
    monkeypatch.setattr(rtriage, "oracle_divergence", caught)
    assert ref.nemesis_cell(1000, 16, 64, interpret=True) == 1
    mine = sweep.nemesis_configs(1000, 64)
    assert [t for _, t in seen] == [120] * 4
    assert [n for n, _ in mine] == ["gray-mix", "disk-full", "compaction",
                                    "pressure-mix+admission"]
    for (_, a), (b, _) in zip(mine, seen):
        assert _fields(a) == _fields(b)


def test_cpu_sweep_exits_0(capsys):
    assert sweep.main(["--device", "cpu", "--groups", "4",
                       "--ticks", "16"]) == 0
    out = capsys.readouterr().out
    assert out.count(": ok safety=ok") == 6


def test_flipped_bit_exits_1_naming_the_universe(monkeypatch, capsys):
    """A bit of the engine's output State flipped in universe 2 only:
    the sweep names that universe and its divergent leaf, and exits 1."""
    real = kernel.prun

    def flipped(cfg, st, n_ticks, *a, **kw):
        out = real(cfg, st, n_ticks, *a, **kw)
        if cfg.seed == 1002:
            out[0].nodes.term[1, 2] ^= 1
        return out
    monkeypatch.setattr(kernel, "prun", flipped)
    assert sweep.main(["--device", "cpu", "--groups", "4",
                       "--ticks", "16"]) == 1
    out = capsys.readouterr().out
    bad = [ln for ln in out.splitlines() if "DIVERGED" in ln]
    assert len(bad) == 1 and bad[0].startswith(
        "[2] seed=1002 k=5 L=16 prevote+reconfig+partition: DIVERGED")
    assert "nodes.term" in bad[0]


def test_card_sweep_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert sweep.main(["--groups", "4", "--ticks", "16"]) == 2


def test_the_reference_own_unsafe_group():
    """The sweep's one safety finding: in the --clients axis's
    reads+partition universe, group 377 breaks leader completeness at
    tick 105 (a term-6 leader whose log ends at 13 while 15 is
    committed), and it is the model's own: the CPU oracle (the JAX
    package's `core/`, ported) steps in lockstep with the plain tick up
    to it, and the JAX package's run drops the same group (chip_smoke.py
    `SWEEP_KNOWN_UNSAFE`, ROADMAP queue 3). Run as that one group."""
    from raft_tpu_torch.core.cluster import Cluster
    from raft_tpu_torch.sim import check, state, step
    from raft_tpu_torch.sim.run import TRACE_FIELDS

    cfg = list(sweep.sweep_configs(1000, clients=True))[5]
    assert sweep.universe_name(5, clients=True) == "reads+partition+clients"
    oracle = Cluster(cfg, group=377)
    st = state.init(cfg, 1, device="cpu", first_group=377)
    for t in range(106):
        oracle.tick()
        st = step.tick(cfg, st, t)
        for f in TRACE_FIELDS:
            assert [int(getattr(v, f)) for v in oracle.snapshot()] == \
                getattr(st.nodes, f)[0].tolist(), (t, f)
        broken = [k for k, ok in check.predicate_report(
            st, cfg.log_cap).items() if not bool(ok[0])]
        assert broken == ([] if t < 105 else ["leader_completeness"]), t
    assert st.nodes.role[0].tolist() == [0, 0, 0, 0, 2]
    assert int(st.nodes.last_index[0, 4]) == 13 \
        < int(st.nodes.commit[0].max()) == 15
