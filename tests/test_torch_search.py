"""The port's nemesis search (`raft_tpu_torch.nemesis.search`) against
the JAX package's, tolerance 0 (scores as exact floats): the mutator,
draws and coverage keys over 200 steps, and `run_signals` and a budget-2
hunt at tests/test_nemesis.py's exact shapes (three scored runs, XLA
programs that file also compiles); a clean universe has no unsafe tick;
the corpus files are the reference's, byte for byte."""

from __future__ import annotations

import os

from raft_tpu import nemesis as jnem
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.nemesis import search as jsearch
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.nemesis import search as nsearch
from test_torch_nemesis import BASE

from jax_programs import release_jax_programs  # noqa: F401


def test_mutation_draws_and_keys_match_the_reference():
    """200 chained mutations from the gray mix (every op, every clause
    kind's menu), the raw draws, and the score and coverage key of
    synthetic signals."""
    prog, jprog = nemesis.gray_mix(16), jnem.gray_mix(16)
    kinds = set()
    for step in range(200):
        for i in (0, 1, 2, 10, 11, 12, 13, 14, 15, 16, 99):
            assert nsearch._draw(5, step, i) == jsearch._draw(5, step, i)
        prog = nsearch.mutate(prog, 16, 5, step)
        jprog = jsearch.mutate(jprog, 16, 5, step)
        assert prog == jprog, step
        assert RaftConfig(**BASE, nemesis=prog).nemesis \
            == JaxConfig(**BASE, nemesis=jprog).nemesis
        kinds.update(c[0] for c in prog)
        sig = {k: (step * (i + 3)) % (17 + i) for i, k in enumerate(
            ("unsafe_groups", "elections", "max_leaderless", "committed",
             "stalled_groups", "dual_leader_groups", "term_spread",
             "storm_ticks"))}
        assert nsearch.coverage_key(sig) == jsearch.coverage_key(sig)
        assert nsearch.near_miss_score(sig) == jsearch.near_miss_score(sig)
    assert len(kinds) == 8   # every clause kind was drawn


def test_run_signals_match_the_reference():
    """tests/test_nemesis.py's `test_run_signals_and_scoring_shapes`
    universe."""
    cfg = RaftConfig(**BASE, nemesis=nemesis.gray_mix(16))
    mine = nsearch.run_signals(cfg, 8, 16, device="cpu")
    ref = jsearch.run_signals(JaxConfig(**BASE, nemesis=jnem.gray_mix(16)),
                              8, 16)
    assert mine == ref
    assert all(type(v) is int for v in mine.values())
    assert mine["elections"] > 0


def test_budget_two_hunt_matches_the_reference():
    """tests/test_nemesis.py's `test_search_is_deterministic` hunt."""
    mine = nsearch.search(RaftConfig(**BASE), 8, 16, budget=2, seed=3,
                          device="cpu")
    ref = jsearch.search(JaxConfig(**BASE), 8, 16, budget=2, seed=3)
    assert mine["corpus"] == ref["corpus"]
    assert [nemesis.program_hash(p) for p in mine["corpus"]] \
        == [jnem.program_hash(p) for p in ref["corpus"]]
    assert mine["coverage"] == ref["coverage"]
    assert mine["best"] == ref["best"]
    assert mine["best_score"] == ref["best_score"]
    assert mine["violations"] == ref["violations"]
    assert len(mine["corpus"]) >= 2


def test_a_clean_universe_has_no_unsafe_tick():
    cfg = RaftConfig(**BASE, nemesis=nemesis.gray_mix(32))
    assert nsearch.first_unsafe_tick(cfg, 8, 32, device="cpu") is None
    assert nsearch.safety_repro(RaftConfig(**BASE), 8, 32, device="cpu")(
        nemesis.pressure_mix(32)) is None


def test_corpus_files_match_the_reference(tmp_path):
    progs = [nemesis.gray_mix(16), nemesis.pressure_mix(24),
             nsearch.mutate(nemesis.gray_mix(16), 16, 1, 2)]
    assert nsearch.save_corpus(str(tmp_path / "a"), progs) == 3
    jsearch.save_corpus(str(tmp_path / "b"), progs)
    for f in sorted(os.listdir(tmp_path / "a")):
        assert (tmp_path / "a" / f).read_bytes() \
            == (tmp_path / "b" / f).read_bytes()
    assert nsearch.load_corpus(str(tmp_path / "b")) \
        == jsearch.load_corpus(str(tmp_path / "a"))
    assert nsearch.load_corpus(str(tmp_path / "none")) == []
