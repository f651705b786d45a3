"""The port's bounded model checker and mutant catalog
(raft_tpu_torch/verify/mcheck.py, mutants.py) held to the JAX
package's: the same smoke result, the same kill of every catalog mutant
(predicate family, tick and counterexample schedule), the unmutated
oracle clean on every waypoint drive, and reproducers that replay in
either package and through scripts/torch_nemesis_search.py --replay.
Both checkers are pure Python; nothing here compiles an XLA program."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from raft_tpu.verify import mcheck as ref_mcheck
from raft_tpu.verify import mutants as ref_mutants
from raft_tpu_torch.core.node import Node
from raft_tpu_torch.verify import mcheck, mutants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [m.name for m in ref_mutants.MUTANTS]


def _result(r) -> dict:
    out = {k: getattr(r, k) for k in ("ok", "states", "transitions",
                                      "depth", "complete", "pruned")}
    if r.violation is not None:
        out.update({k: r.violation[k] for k in ("tick", "predicates",
                                                "schedule")})
    return out


def test_smoke_equals_reference():
    """The audit smoke: clean, exhaustive, and the same states,
    transitions and depth as the JAX package's checker."""
    got, want = mcheck.smoke(), ref_mcheck.smoke()
    assert got.ok and got.complete, got.violation
    assert _result(got) == _result(want)


def test_catalog_equals_reference():
    """Same names in the same order, mirrors, expectations, bounds and
    waypoint prefixes."""
    assert [m.name for m in mutants.MUTANTS] == NAMES
    for m in mutants.MUTANTS:
        r = ref_mutants.by_name(m.name)
        assert (m.mirror, m.expect, m.doc) == (r.mirror, r.expect, r.doc)
        assert dataclasses.asdict(m.bounds) == dataclasses.asdict(r.bounds)
        assert m.prefix == r.prefix
        assert issubclass(m.node_cls, Node)


@pytest.mark.parametrize("name", NAMES)
def test_mutant_killed_like_reference_and_oracle_clean(name):
    """The port's checker kills the port's mutant with the reference's
    predicates, at its tick, with its counterexample schedule and state
    counts; the port's unmutated oracle survives the same drive,
    exhaustively."""
    m, r = mutants.by_name(name), ref_mutants.by_name(name)
    got = mcheck.check(m.bounds, m.node_cls, prefix=m.prefix)
    want = ref_mcheck.check(r.bounds, r.node_cls, prefix=r.prefix)
    assert not got.ok, f"{name}: mutant survived its recorded bounds"
    assert m.expect in got.violation["predicates"]
    assert _result(got) == _result(want)
    clean = mcheck.check(m.bounds, Node, prefix=m.prefix)
    assert clean.ok, f"{name}: the real oracle tripped on the kill drive"
    assert clean.complete


@pytest.mark.parametrize("name", ["commit_off_by_one", "shed_then_apply"])
def test_narrow_views_kill_alike(name):
    """With the predicates on the port's narrow-native views the kill is
    the same (the width-robustness the smoke's agreement walk checks)."""
    m = mutants.by_name(name)
    wide = mcheck.check(m.bounds, m.node_cls, prefix=m.prefix)
    narrow = mcheck.check(m.bounds, m.node_cls, prefix=m.prefix,
                          narrow=True)
    assert _result(narrow) == _result(wide)


def test_narrow_view_dtypes_follow_the_port_spec():
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.sim.state import full_narrow_spec
    spec = full_narrow_spec(RaftConfig())
    for name, dt in mcheck._NARROW_VIEW_DTYPES.items():
        assert spec[f"nodes.{name}"] == dt
    assert "digest" not in mcheck._NARROW_VIEW_DTYPES


def _artifact(pkg_mcheck, pkg_mutants, name="commit_off_by_one"):
    m = pkg_mutants.by_name(name)
    r = pkg_mcheck.check(m.bounds, m.node_cls, prefix=m.prefix)
    return pkg_mcheck.reproducer(r, m.bounds, mutant=m.name)


def test_reproducers_identical_and_replay_across_packages(tmp_path):
    """A reproducer is the reference's JSON byte for byte, and one
    written by either package replays in the other."""
    mine, theirs = _artifact(mcheck, mutants), _artifact(ref_mcheck,
                                                         ref_mutants)
    p_mine, p_theirs = tmp_path / "port.json", tmp_path / "ref.json"
    mcheck.save_reproducer(mine, str(p_mine))
    ref_mcheck.save_reproducer(theirs, str(p_theirs))
    assert p_mine.read_bytes() == p_theirs.read_bytes()
    rep = mcheck.replay(mcheck.load_reproducer(str(p_theirs)))
    assert rep["tick"] == theirs["violation"]["tick"]
    assert "predicates." + rep["predicates"][0] == \
        theirs["violation"]["leaf"]
    rep = ref_mcheck.replay(ref_mcheck.load_reproducer(str(p_mine)))
    assert rep["tick"] == mine["violation"]["tick"]


def test_load_rejects_foreign_kind_and_replay_detects_drift(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"kind": "nemesis-reproducer"}))
    with pytest.raises(ValueError):
        mcheck.load_reproducer(str(path))
    art = _artifact(mcheck, mutants)
    with pytest.raises(AssertionError):
        mcheck.replay(art, node_cls=Node)   # the clean oracle: no kill


def test_nemesis_search_replays_mcheck_artifacts(tmp_path):
    """scripts/torch_nemesis_search.py --replay takes a model-checker
    reproducer: rc 0 when it reproduces, rc 1 when it drifted; no card
    needed."""
    art = _artifact(ref_mcheck, ref_mutants)
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    ref_mcheck.save_reproducer(art, str(good))
    art["violation"]["tick"] += 1
    ref_mcheck.save_reproducer(art, str(bad))
    script = os.path.join(ROOT, "scripts", "torch_nemesis_search.py")
    for path, rc in ((good, 0), (bad, 1)):
        out = subprocess.run([sys.executable, script, "--replay", str(path)],
                             cwd=ROOT, capture_output=True, text=True)
        assert out.returncode == rc, out.stdout + out.stderr
