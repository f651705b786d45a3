"""scripts/torch_nemesis_fleet.py: its triage gives the JAX package's
(`scripts/nemesis_fleet.py`) dedupe and ranking on the same hunt
records; a two-seed fleet on the CPU (real `torch_nemesis_search.py`
children on the plain engine) writes one record per hunt and a summary
and exits 0; children that report the same (leaf, tick) violation make
one finding and rc 3, a dead child rc 1 (stub children the fleet is
pointed at). No JAX program is compiled."""

from __future__ import annotations

import importlib
import json
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
fleet = importlib.import_module("torch_nemesis_fleet")
ref = importlib.import_module("nemesis_fleet")


def _rec(seed, rc=0, score=None, leaf=None, tick=None, clauses=0):
    v = None if leaf is None else {"tick": tick, "leaf": leaf,
                                   "program_hash": f"h{seed}",
                                   "clauses": clauses}
    return {"kind": "fleet-hunt", "seed": seed, "rc": rc, "budget": 2,
            "groups": 2, "ticks": 16, "wall_s": 1.0, "best_score": score,
            "corpus_new": 0, "artifact": None if v is None else f"a{seed}",
            "violation": v}


RECORDS = [_rec(0, score=3.5), _rec(1, rc=3, score=9.0, leaf=".nodes.term",
                                    tick=12, clauses=4),
           _rec(2, rc=3, score=2.0, leaf=".nodes.term", tick=12, clauses=2),
           _rec(3, rc=3, leaf=".nodes.commit", tick=7, clauses=5),
           _rec(4, rc=1), _rec(5, score=11.25),
           _rec(6, rc=3, score=1.0, leaf=".nodes.term", tick=12, clauses=2)]


@pytest.mark.parametrize("n", [0, 1, 3, len(RECORDS)])
def test_triage_equals_the_reference(n):
    assert fleet.triage(RECORDS[:n]) == ref.triage(RECORDS[:n])
    if n == len(RECORDS):
        s = fleet.triage(RECORDS)
        assert s["violations_total"] == 4 and s["violations_unique"] == 2
        assert [v["seed"] for v in s["unique_violations"]] == [3, 2]
        assert [r["seed"] for r in s["ranked_seeds"]] == [5, 1, 0, 2, 6]
        assert s["child_failures"] == [4]


def test_two_seed_cpu_fleet(tmp_path):
    report = tmp_path / "fleet.jsonl"
    rc = fleet.main(["--device", "cpu", "--seeds", "2", "--budget", "2",
                     "--groups", "2", "--ticks", "16",
                     "--corpus", str(tmp_path / "corpus"),
                     "--out-dir", str(tmp_path), "--report", str(report)])
    assert rc == 0
    recs = [json.loads(x) for x in report.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["fleet-hunt"] * 2 + [
        "fleet-summary"]
    assert [r["seed"] for r in recs[:2]] == [0, 1]
    assert all(r["rc"] == 0 and r["best_score"] is not None
               for r in recs[:2])
    assert recs[2]["hunts"] == 2 and recs[2]["corpus_size"] > 0


STUB = textwrap.dedent('''
    import argparse, json, sys
    ap = argparse.ArgumentParser()
    for a in ("--seed", "--budget", "--groups", "--ticks", "--corpus",
              "--out", "--device"):
        ap.add_argument(a)
    ap.add_argument("--check-kernel", action="store_true")
    a = ap.parse_args()
    seed = int(a.seed)
    if seed == 9:
        sys.exit(7)
    n = 3 if seed == 0 else 1
    json.dump({"program": [[0]] * n, "program_hash": "p%d" % seed,
               "violation": {"tick": 21, "leaf": ".nodes.term"}},
              open(a.out, "w"))
    print("best score %d.5: stub (device %s, check %s)"
          % (seed, a.device, a.check_kernel), file=sys.stderr)
    sys.exit(3)
''')


def test_same_violation_twice_is_one_finding(tmp_path, monkeypatch):
    stub = tmp_path / "stub_search.py"
    stub.write_text(STUB)
    monkeypatch.setattr(fleet, "_SEARCH", str(stub))
    report = tmp_path / "fleet.jsonl"
    args = ["--device", "cpu", "--check-kernel", "--budget", "2",
            "--corpus", str(tmp_path / "c"), "--out-dir", str(tmp_path),
            "--report", str(report)]
    assert fleet.main(args + ["--seeds", "2"]) == 3
    summary = json.loads(report.read_text().splitlines()[-1])
    assert summary["violations_total"] == 2
    assert summary["unique_violations"] == [{
        "leaf": ".nodes.term", "tick": 21, "seed": 1,
        "artifact": str(tmp_path / "NEMESIS_repro_seed1.json"),
        "program_hash": "p1", "clauses": 1}]
    assert [r["seed"] for r in summary["ranked_seeds"]] == [1, 0]
    assert fleet.main(args + ["--seeds", "1", "--seed-base", "9"]) == 1
