"""The port's shrinker and reproducer artifacts against the JAX
package's, tolerance 0 (reports and artifacts as strings): the shrinker
on tests/test_nemesis.py's seeded violation, artifacts replayed across
the two packages, and the checked-in `NEMESIS_repro_example.json`
replayed in the port.

The reference's shrinker runs on the port's engines (every candidate a
CPU run), and the reference's engines on the shrink's two ends, the
starting and the minimal program: two of the nine single-tick XLA
programs tests/test_nemesis.py compiles for the same shrink, which
would take ~20 s each on a cold compile cache."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

from raft_tpu import nemesis as jnem
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.nemesis import search as jsearch
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.nemesis import search as nsearch
from test_torch_nemesis import BASE

from jax_programs import release_jax_programs  # noqa: F401

EXAMPLE = Path(__file__).resolve().parent.parent \
    / "NEMESIS_repro_example.json"


TICKS, CORRUPT_T, GROUPS = 24, 9, 4


def _seeded(mod):
    return mod.program(
        mod.slow_follower(0, TICKS, p=0.7),
        mod.flaky_link(0, TICKS, p=0.9, burst_epoch=8, burst_p=0.6))


def _port_repro(base):
    pair = nsearch.term_corruption_pair(CORRUPT_T, group=0, node=1)
    return nsearch.divergence_repro(base, pair, GROUPS, TICKS, chunk=1,
                                    device="cpu")


def _jax_repro(base):
    pair = jsearch.term_corruption_pair(CORRUPT_T, group=0, node=1)
    return jsearch.divergence_repro(base, pair, GROUPS, TICKS, chunk=1)


@pytest.fixture(scope="module")
def shrunk():
    """The port's shrinker and the reference's, both on the port's
    engines (each candidate's report kept), on tests/test_nemesis.py's
    seeded violation."""
    base, jbase = RaftConfig(**BASE), JaxConfig(**BASE)
    inner, reports = _port_repro(base), {}

    def repro(prog):
        key = tuple(tuple(c) for c in prog)
        if key not in reports:
            reports[key] = inner(prog)
        return reports[key]

    mine = nsearch.shrink(_seeded(nemesis), repro)
    ref = jsearch.shrink(_seeded(jnem), repro)
    return base, jbase, mine, ref, reports


def test_shrink_matches_the_reference(shrunk):
    """The same minimal program and report from both shrinkers, and the
    reference's engines report the same as the port's at both ends."""
    _, jbase, (mini, rep), (jmini, jrep), reports = shrunk
    assert mini == jmini
    assert rep == jrep   # tick, boundary, leaf and the leaf report
    assert rep["tick"] == CORRUPT_T and rep["leaf"] == ".nodes.term"
    assert len(mini) == 1 and mini[0][1] <= CORRUPT_T < mini[0][2]
    assert len(reports) == 9   # candidates tried, the two ends included
    assert sum(r is None for r in reports.values()) == 3
    jrepro = _jax_repro(jbase)
    start = tuple(tuple(c) for c in _seeded(jnem))
    assert jrepro(start) == reports[start]
    assert jrepro(jmini) == rep


def _artifact(search_mod, base, mini, rep):
    return search_mod.reproducer(
        dataclasses.replace(base, nemesis=mini), TICKS, rep,
        engines="torch-vs-seeded-corruption",
        inject={"kind": "term_flip", "tick": CORRUPT_T, "group": 0,
                "node": 1, "bump": 4},
        n_groups=GROUPS, note="seeded")


def test_artifacts_replay_across_the_packages(shrunk, tmp_path):
    """The port writes the artifact the reference writes, byte for byte;
    the port's file replays through the reference's `verify_reproducer`,
    and the reference's through the port's."""
    base, jbase, (mini, rep), (jmini, jrep), _ = shrunk
    art = _artifact(nsearch, base, mini, rep)
    jart = _artifact(jsearch, jbase, jmini, jrep)
    assert json.dumps(art, sort_keys=True) == json.dumps(jart,
                                                         sort_keys=True)
    mine_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    nsearch.save_reproducer(str(mine_path), art)
    jsearch.save_reproducer(str(ref_path), jart)
    assert mine_path.read_bytes() == ref_path.read_bytes()

    jcfg, jloaded = jsearch.load_reproducer(str(mine_path))
    fresh = jsearch.verify_reproducer(jloaded, _jax_repro(jbase))
    assert fresh["tick"] == CORRUPT_T
    cfg, loaded = nsearch.load_reproducer(str(ref_path))
    assert cfg.nemesis == jcfg.nemesis == mini
    fresh = nsearch.verify_reproducer(loaded, _port_repro(base))
    assert fresh["leaf_report"] == rep["leaf_report"]

    drifted = dict(art, violation=dict(art["violation"], tick=CORRUPT_T + 1))
    with pytest.raises(AssertionError, match="drifted"):
        nsearch.verify_reproducer(drifted, _port_repro(base))
    nsearch.save_reproducer(str(tmp_path / "bad.json"),
                            dict(art, program_hash="00000000"))
    with pytest.raises(ValueError, match="program_hash"):
        nsearch.load_reproducer(str(tmp_path / "bad.json"))


def test_the_checked_in_example_replays_in_the_port():
    """Same tick, leaf and leaf report as the reference recorded."""
    cfg, art = nsearch.load_reproducer(str(EXAMPLE))
    inj = art["inject"]
    pair = nsearch.term_corruption_pair(inj["tick"], inj["group"],
                                        inj["node"], inj["bump"])
    repro = nsearch.divergence_repro(cfg, pair, art["n_groups"],
                                     art["n_ticks"], device="cpu")
    rep = nsearch.verify_reproducer(art, repro)
    assert rep["tick"] == art["violation"]["tick"] == 13
    assert rep["leaf_report"] == art["violation"]["leaf_report"]
