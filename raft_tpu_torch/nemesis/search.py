"""Coverage-guided adversarial search + auto-shrinking reproducers
(DESIGN.md §14), on the port's engines: the plain PyTorch tick and the
fused-chunk CUDA kernel.

The searcher mutates gray-failure programs and scores each candidate
run by safety-fold NEAR-MISSES and flight-ring health — election
storms, leaderless stalls, dual-leader coexistence (distinct terms;
same-term would be a violation), term inflation, commit stalls — the
signals real fleets page on. A candidate that lights up a new coverage
signature joins the corpus; a candidate that actually drops the
per-tick safety bit is a VIOLATION and goes to the shrinker.

Everything here is deterministic: mutation choices are
`utils.rng.hash_u32` draws keyed on (search seed, step) — the repo's
"all randomness is a pure function of (seed, tag, coords)" rule applied
to the search itself, so a hunt (and a shrink) replays exactly from its
seed, on any device and in either package: the JAX package's search
draws the same mutations and scores the same signals.

Shrinking: greedy clause-drops then span-halvings, re-checking the
caller's `repro(program) -> report | None` after each candidate edit,
until no single edit still reproduces. Clause cids are never
renumbered (see nemesis/program.py), so a surviving clause's
schedule is bit-identical in the minimal program — the reason a shrunk
reproducer replays to the SAME tick and leaf. Reports come from
`obs.triage.bisect_divergence` (engine-vs-engine divergence) or from
`first_unsafe_tick` (single-engine safety-fold violations, named per
predicate via `check.predicate_report`); a minimal reproducer is
serialized as a self-contained JSON artifact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.nemesis.program import (clock_skew, compaction_pressure,
                                      crash_storm, describe,
                                      disk_full_follower, flaky_link,
                                      from_json, gray_mix,
                                      partition_wave, program,
                                      program_hash, slow_follower,
                                      to_json, wan_delay)
from raft_tpu_torch.utils import rng

_SEARCH_TAG = 0x4E454D53   # "NEMS": domain-separates search draws


def _draw(seed: int, step: int, i: int) -> int:
    return rng.hash_u32(_SEARCH_TAG, seed, step, i)


def _pick(seed, step, i, menu):
    return menu[_draw(seed, step, i) % len(menu)]


# ------------------------------------------------------------- scoring


def _np(a):
    return a.detach().cpu().numpy()


def run_signals(cfg: RaftConfig, n_groups: int, n_ticks: int,
                device="cuda") -> dict:
    """One scored run of the plain tick with the flight recorder on
    `device` (the searcher's engine): host-int health signals from the
    metrics fold, the endpoint state, and the flight ring."""
    from raft_tpu_torch.obs.recorder import flight_rows, run_recorded
    from raft_tpu_torch.sim import state

    fin, met, ring = run_recorded(
        cfg, state.init(cfg, n_groups, device=device), n_ticks)
    safety = _np(met.safety)
    committed = _np(met.committed)
    term = _np(fin.nodes.term).astype(np.int64)
    # Transient dual-leader windows out of the flight ring's per-tick
    # per-group alive-leader counts (last RING recorded ticks), not
    # just the endpoint state — a program that provokes the window
    # mid-run and converges by the end must still score.
    ring_leaders = _np(ring.leaders)
    recorded = _np(ring.tick) >= 0
    dual = ((ring_leaders >= 2) & recorded).any(axis=0)
    rows = flight_rows(ring)
    return {
        "unsafe_groups": int((safety == 0).sum()),
        "elections": int(_np(met.elections)),
        "max_leaderless": int(_np(met.max_latency)),
        "committed": int(committed.astype(np.int64).sum()),
        "stalled_groups": int((committed == 0).sum()),
        # Near-miss: >= 2 alive leaders in one group at ANY recorded
        # tick (necessarily in DISTINCT terms, or the safety bit would
        # have latched) — the state one message away from split-brain.
        "dual_leader_groups": int(dual.sum()),
        "term_spread": int((term.max(axis=1) - term.min(axis=1)).max()),
        # Flight-ring health (the r12 heartbeat's storm signal): ticks
        # whose fleet-wide election completions exceed half the fleet.
        "storm_ticks": sum(1 for r in rows
                           if r["elections"] > n_groups // 2),
    }


def near_miss_score(sig: dict) -> float:
    """Higher = closer to the edge. An actual violation dominates
    everything (the searcher still shrinks it, not just ranks it)."""
    return (1000.0 * sig["unsafe_groups"]
            + 8.0 * sig["dual_leader_groups"]
            + 2.0 * sig["storm_ticks"]
            + 1.0 * sig["max_leaderless"]
            + 1.0 * sig["term_spread"]
            + 0.5 * sig["stalled_groups"]
            + 0.05 * sig["elections"])


def coverage_key(sig: dict) -> tuple:
    """Quantized signature: a candidate joins the corpus iff its key is
    new (log2 buckets keep the key space small but direction-sensitive)."""
    def b(x):
        return int(x).bit_length()
    return (min(sig["unsafe_groups"], 1), sig["dual_leader_groups"],
            b(sig["storm_ticks"]), b(sig["max_leaderless"]),
            b(sig["term_spread"]), b(sig["stalled_groups"]),
            b(sig["elections"]))


# ------------------------------------------------------------ mutation

# Per-kind parameter menus the deterministic mutator draws from.
_MENUS = {
    "slow": dict(p=(0.5, 0.7, 0.9), direction=(1, 2, 3)),
    "flaky": dict(p=(0.7, 0.9, 1.0), burst_epoch=(4, 8, 16),
                  burst_p=(0.3, 0.6, 1.0)),
    "wan": dict(sites=(2, 3), p=(0.3, 0.5, 0.8)),
    "skew": dict(amount=(-6, -3, 4, 8, 16), node_p=(0.3, 0.6, 1.0)),
    "storm": dict(p=(0.2, 0.4, 0.6), epoch=(2, 4, 8)),
    "wave": dict(period=(8, 16, 32), width_frac=(0.25, 0.5, 0.75),
                 leak_p=(0.6, 1.0)),
    # r20 storage-pressure kinds (DESIGN.md §19): the searcher mutates
    # over the durability seam too — disk-full windows that park a
    # node at its durable prefix and compaction stalls that fill the
    # log_cap ring compose with the delivery/timer kinds above into
    # exactly the mixed programs the hand-written tests never try.
    "disk": dict(p=(0.5, 0.8, 1.0), epoch=(4, 8, 16)),
    "compact": dict(p=(0.3, 0.5, 0.8), epoch=(4, 8, 16)),
}


def _new_clause(horizon: int, seed: int, step: int):
    """A fresh hash-drawn clause spanning a random sub-window of
    [0, horizon)."""
    t0 = _draw(seed, step, 10) % max(1, horizon - 8)
    t1 = t0 + 8 + _draw(seed, step, 11) % max(1, horizon - t0 - 7)
    groups = _pick(seed, step, 12, (1.0, 1.0, 0.5))
    which = _pick(seed, step, 13, tuple(_MENUS))
    menu = _MENUS[which]
    if which == "slow":
        return slow_follower(t0, t1, p=_pick(seed, step, 14, menu["p"]),
                             direction=_pick(seed, step, 15,
                                             menu["direction"]),
                             groups=groups)
    if which == "flaky":
        return flaky_link(t0, t1, p=_pick(seed, step, 14, menu["p"]),
                          burst_epoch=_pick(seed, step, 15,
                                            menu["burst_epoch"]),
                          burst_p=_pick(seed, step, 16, menu["burst_p"]),
                          groups=groups)
    if which == "wan":
        return wan_delay(t0, t1,
                         sites=_pick(seed, step, 14, menu["sites"]),
                         p=_pick(seed, step, 15, menu["p"]), groups=groups)
    if which == "skew":
        return clock_skew(t0, t1,
                          amount=_pick(seed, step, 14, menu["amount"]),
                          node_p=_pick(seed, step, 15, menu["node_p"]),
                          groups=groups)
    if which == "storm":
        return crash_storm(t0, t1, p=_pick(seed, step, 14, menu["p"]),
                           epoch=_pick(seed, step, 15, menu["epoch"]),
                           groups=groups)
    if which == "disk":
        return disk_full_follower(t0, t1,
                                  p=_pick(seed, step, 14, menu["p"]),
                                  epoch=_pick(seed, step, 15,
                                              menu["epoch"]),
                                  groups=groups)
    if which == "compact":
        return compaction_pressure(t0, t1,
                                   p=_pick(seed, step, 14, menu["p"]),
                                   epoch=_pick(seed, step, 15,
                                               menu["epoch"]),
                                   groups=groups)
    period = _pick(seed, step, 14, menu["period"])
    width = max(1, int(period * _pick(seed, step, 15, menu["width_frac"])))
    return partition_wave(t0, t1, period=period, width=width,
                          leak_p=_pick(seed, step, 16, menu["leak_p"]),
                          groups=groups)


def mutate(prog: tuple, horizon: int, seed: int, step: int) -> tuple:
    """One deterministic mutation: add / drop / narrow-a-span / flip an
    intensity. Surviving clauses keep their cids (and hence their exact
    schedules)."""
    op = _draw(seed, step, 0) % 4
    if op == 1 and len(prog) > 1:
        i = _draw(seed, step, 1) % len(prog)
        return prog[:i] + prog[i + 1:]
    if op == 2 and prog:
        i = _draw(seed, step, 1) % len(prog)
        c = tuple(prog[i])
        if c[2] - c[1] >= 2:
            mid = (c[1] + c[2]) // 2
            half = ((c[1], mid) if _draw(seed, step, 2) & 1
                    else (mid, c[2]))
            return prog[:i] + (c[:1] + half + c[3:],) + prog[i + 1:]
    if op == 3 and prog:
        i = _draw(seed, step, 1) % len(prog)
        c = tuple(prog[i])
        p = (min(0xFFFFFFFF, c[4] * 2 + 1) if _draw(seed, step, 2) & 1
             else c[4] // 2)
        return prog[:i] + (c[:4] + (p,) + c[5:],) + prog[i + 1:]
    return program(*prog, _new_clause(horizon, seed, step))


# -------------------------------------------------------------- search


def search(base_cfg: RaftConfig, n_groups: int, n_ticks: int,
           budget: int, seed: int = 0, start: tuple | None = None,
           log=None, seed_corpus: list | None = None,
           device="cuda") -> dict:
    """The coverage-guided loop: `budget` mutate-run-score steps from a
    seed corpus. Returns {corpus, coverage, best, best_score,
    violations} — `violations` are (program, signals) pairs whose runs
    dropped the per-tick safety bit (shrink them with `shrink`).
    Deterministic in (base_cfg, n_groups, n_ticks, budget, seed,
    start, seed_corpus) on every device. Each step runs the plain tick
    over `n_groups` x `n_ticks` on `device`.

    `seed_corpus`: programs from a PERSISTED corpus (`load_corpus`) to
    seed the mutation pool — a resumed hunt starts from every
    coverage-novel program earlier hunts found instead of the canonical
    gray mix. Seeded programs are mutation parents only (not re-run, so
    resuming costs no extra runs until mutation reaches them)."""
    corpus = (list(seed_corpus) if seed_corpus
              else [start if start is not None else gray_mix(n_ticks)])
    coverage: dict = {}
    violations: list = []
    best, best_score = corpus[0], float("-inf")
    for step in range(budget):
        parent = corpus[_draw(seed, step, 99) % len(corpus)]
        cand = mutate(parent, n_ticks, seed, step)
        cfg = dataclasses.replace(base_cfg, nemesis=cand)
        sig = run_signals(cfg, n_groups, n_ticks, device=device)
        key = coverage_key(sig)
        score = near_miss_score(sig)
        fresh = key not in coverage
        if fresh:
            coverage[key] = score
            corpus.append(cand)
        if score > best_score:
            best, best_score = cand, score
        if sig["unsafe_groups"] > 0:
            violations.append((cand, sig))
        if log is not None:
            log(f"[{step:3d}] score={score:8.1f} "
                f"{'NEW-COVERAGE ' if fresh else ''}"
                f"{'VIOLATION ' if sig['unsafe_groups'] else ''}"
                f"{describe(cand)}")
    return {"corpus": corpus, "coverage": coverage, "best": best,
            "best_score": best_score, "violations": violations}


# ---------------------------------------------------- violation triage


def first_unsafe_tick(cfg: RaftConfig, n_groups: int, n_ticks: int,
                      chunk: int = 16, device="cuda"):
    """First tick whose post-state violates `check.tick_safety`, with
    the violated predicate(s) named (`check.predicate_report`) — the
    single-engine analogue of `obs.triage.bisect_divergence`, sharing
    its report shape so reproducer artifacts are schema-identical.
    Returns None when the whole run is clean."""
    from raft_tpu_torch.sim import check, state
    from raft_tpu_torch.sim.run import metrics_init, run

    cur = state.init(cfg, n_groups, device=device)
    curm = metrics_init(n_groups, clients=cfg.clients_u32 != 0,
                        device=device)
    t, end = 0, n_ticks
    while t < end:
        n = min(chunk, end - t)
        nxt, nxtm = run(cfg, cur, n, t, curm)
        if int((nxtm.safety == 0).sum()) == 0:
            cur, curm, t = nxt, nxtm, t + n
            continue
        for dt in range(n):
            cur, curm = run(cfg, cur, 1, t + dt, curm)
            rep = {name: _np(v) for name, v in check.predicate_report(
                state.widen_state(cfg, cur), cfg.log_cap).items()}
            names = [name for name, v in rep.items() if not v.all()]
            if names:
                grp = int(np.argwhere(~rep[names[0]])[0][0])
                return {"tick": t + dt,
                        "leaf_report": f"safety predicate "
                                       f"{'+'.join(names)} violated "
                                       f"(first group {grp})",
                        "leaf": names[0], "predicates": names,
                        "boundary": (t, t + n)}
        raise AssertionError(
            "safety bit latched over the chunk but no tick-by-tick "
            "re-execution violated a predicate — the engine is not "
            "deterministic in (state, t0)")
    return None


def _leaf_of(report: dict) -> str:
    """The divergent-leaf path out of a triage report (its own `leaf`
    key, else parsed from trees_equal_why's message)."""
    if "leaf" in report:
        return report["leaf"]
    why = report["leaf_report"]
    if "first divergent leaf: " in why:
        return why.split("first divergent leaf: ")[1].split(" — ")[0]
    return why


def plain_engine(cfg: RaftConfig):
    """The plain tick as an `(state, n, t) -> state` runner."""
    from raft_tpu_torch.sim.run import run
    return lambda s, n, t: run(cfg, s, n, t)[0]


def kernel_engine(cfg: RaftConfig):
    """The fused-chunk kernel as an `(state, n, t) -> state` runner: one
    launch of n ticks on a wire built afresh from the State (so the
    State passed in is never written). On CPU tensors `kernel.prun`
    runs the kernel's plain version."""
    from raft_tpu_torch.sim import kernel
    return lambda s, n, t: kernel.prun(cfg, s, n, t)[0]


def plain_vs_kernel(cfg: RaftConfig):
    """The engine pair of the cross-engine check: the plain tick vs the
    fused-chunk kernel."""
    return plain_engine(cfg), kernel_engine(cfg)


def divergence_repro(base_cfg: RaftConfig, engine_pair, n_groups: int,
                     n_ticks: int, chunk: int = 16, device="cuda"):
    """repro builder over `obs.triage.bisect_divergence`:
    `engine_pair(cfg) -> (engine_a, engine_b)`, each an
    `(state, n, t) -> state` runner (`plain_vs_kernel`, or a clean
    engine vs a corruption-injecting wrapper), both started from one
    State on `device`."""
    from raft_tpu_torch.obs.triage import bisect_divergence
    from raft_tpu_torch.sim import state

    def repro(prog):
        cfg = dataclasses.replace(base_cfg, nemesis=tuple(prog))
        ea, eb = engine_pair(cfg)
        rep = bisect_divergence(ea, eb,
                                state.init(cfg, n_groups, device=device),
                                n_ticks, chunk=chunk)
        if rep is not None:
            rep = {**rep, "leaf": _leaf_of(rep)}
        return rep
    return repro


def safety_repro(base_cfg: RaftConfig, n_groups: int, n_ticks: int,
                 chunk: int = 16, device="cuda"):
    """repro builder over `first_unsafe_tick` (single-engine safety
    violations — what the search loop feeds the shrinker)."""
    def repro(prog):
        cfg = dataclasses.replace(base_cfg, nemesis=tuple(prog))
        return first_unsafe_tick(cfg, n_groups, n_ticks, chunk=chunk,
                                 device=device)
    return repro


def term_corruption_pair(tick: int, group: int = 0, node: int = 1,
                         bump: int = 4, only_under_nemesis: bool = True,
                         engine=plain_engine):
    """The SEEDED safety violation (`torch_nemesis_search.py
    --seed-violation`): an `engine_pair` whose second engine is the
    clean `engine` (`plain_engine` or `kernel_engine`) plus one injected
    fault —
    `nodes.term[group, node] += bump` as the run crosses `tick` — so
    `divergence_repro`'s bisect must name exactly that tick and the
    `.nodes.term` leaf. `bump` defaults comfortably above 1: terms are
    monotone under message exchange, so a +1 flip can be ABSORBED
    within the very tick it lands (a higher-term message heals it and
    the run never diverges). With `only_under_nemesis` (the default)
    the fault arms only while SOME clause's span covers the tick, the
    shape of a real gray-failure-triggered bug: the shrinker then
    converges to the one narrowed clause that keeps the bug alive
    instead of the empty program. The bump is made on a copy of the
    term tensor: the State passed in, which the clean engine also
    starts from, is never written."""
    def pair(cfg):
        run = engine(cfg)
        armed = (not only_under_nemesis) \
            or any(c[1] <= tick < c[2] for c in cfg.nemesis)

        def corrupt(s, n, t):
            if not armed or not t <= tick < t + n:
                return run(s, n, t)
            # Tick by tick through the window holding the injection, as
            # the bisection re-executes it.
            for tt in range(t, t + n):
                if tt == tick:
                    term = s.nodes.term.clone()
                    term[group, node] += bump
                    s = s._replace(nodes=s.nodes._replace(term=term))
                s = run(s, 1, tt)
            return s
        return run, corrupt
    return pair


# ------------------------------------------------------------ shrinker


def shrink(prog: tuple, repro, log=None):
    """Greedy minimization: repeatedly try dropping a clause, then
    halving a clause's span, keeping any edit after which
    `repro(program)` still returns a report — to a fixpoint where no
    single edit reproduces. Deterministic (fixed edit order, no draws);
    cids survive edits, so the minimal program's surviving schedules
    are bit-identical to the original's. Returns (minimal_program,
    final_report)."""
    prog = tuple(tuple(c) for c in prog)
    report = repro(prog)
    if report is None:
        raise ValueError("shrink: the starting program does not reproduce")
    changed = True
    while changed:
        changed = False
        for i in range(len(prog)):
            cand = prog[:i] + prog[i + 1:]
            rep = repro(cand)
            if rep is not None:
                if log is not None:
                    log(f"shrink: dropped clause cid={prog[i][7]} -> "
                        f"{len(cand)} clause(s), still reproduces at "
                        f"tick {rep['tick']}")
                prog, report, changed = cand, rep, True
                break
        if changed:
            continue
        for i, c in enumerate(prog):
            if c[2] - c[1] < 2:
                continue
            mid = (c[1] + c[2]) // 2
            for half in ((c[1], mid), (mid, c[2])):
                cand = prog[:i] + (c[:1] + half + c[3:],) + prog[i + 1:]
                rep = repro(cand)
                if rep is not None:
                    if log is not None:
                        log(f"shrink: narrowed clause cid={c[7]} span to "
                            f"[{half[0]}, {half[1]}), still reproduces "
                            f"at tick {rep['tick']}")
                    prog, report, changed = cand, rep, True
                    break
            if changed:
                break
    return prog, report


# ---------------------------------------------------- corpus persistence


def save_corpus(dirpath: str, corpus) -> int:
    """Persist a search corpus (r18: `--corpus DIR`): one JSON file per
    coverage-novel program, named by program hash — idempotent across
    runs (re-saving a program overwrites identical bytes), so repeated
    hunts into the same DIR accumulate coverage monotonically."""
    import os
    os.makedirs(dirpath, exist_ok=True)
    for prog in corpus:
        h = program_hash(prog)
        with open(os.path.join(dirpath, f"corpus_{h}.json"), "w") as fh:
            json.dump({"schema": ARTIFACT_SCHEMA,
                       "kind": "nemesis-corpus-entry",
                       "program": to_json(prog),
                       "program_hash": h}, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return len(corpus)


def load_corpus(dirpath: str) -> list:
    """Reload a persisted corpus (sorted by filename, so the seeded
    mutation pool is deterministic); [] when DIR is absent or holds no
    entries. Entries failing the hash self-check are skipped loudly
    rather than poisoning a deterministic hunt."""
    import glob
    import os
    import sys
    progs = []
    for path in sorted(glob.glob(os.path.join(dirpath, "corpus_*.json"))):
        with open(path) as fh:
            entry = json.load(fh)
        if entry.get("kind") != "nemesis-corpus-entry":
            continue
        prog = from_json(entry["program"])
        if program_hash(prog) != entry.get("program_hash"):
            print(f"[corpus] {path}: hash mismatch, skipping",
                  file=sys.stderr)
            continue
        progs.append(prog)
    return progs


# ----------------------------------------------------------- artifacts

ARTIFACT_SCHEMA = 1


def reproducer(cfg: RaftConfig, n_ticks: int, report: dict,
               engines: str, note: str = "",
               inject: dict | None = None,
               n_groups: int | None = None) -> dict:
    """The minimal-reproducer JSON artifact: self-contained (full
    config incl. the program, both hashed), replayable, and diffable —
    the thing a violation checks in next to its fix. `inject` records
    a SEEDED fault's parameters (`term_corruption_pair`) so a replayer
    can rebuild the corrupting engine; None = the violation was real.
    `n_groups` is the RUN's group count (the violating group must
    exist in the replay universe — `RaftConfig.n_groups` is the
    oracle's per-Cluster default, not the batched run shape)."""
    from raft_tpu_torch.obs.manifest import config_hash
    return {
        "schema": ARTIFACT_SCHEMA, "kind": "nemesis-reproducer",
        "config": dataclasses.asdict(cfg),
        "config_hash": config_hash(cfg),
        "program": to_json(cfg.nemesis),
        "program_hash": program_hash(cfg.nemesis),
        "n_ticks": int(n_ticks),
        "n_groups": None if n_groups is None else int(n_groups),
        "engines": engines,
        "inject": inject,
        "violation": {"tick": int(report["tick"]),
                      "leaf": _leaf_of(report),
                      "leaf_report": report["leaf_report"],
                      "boundary": list(report["boundary"])},
        "note": note,
    }


def save_reproducer(path: str, artifact: dict) -> str:
    with open(path, "w") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def load_reproducer(path: str):
    """(cfg, artifact) from a saved reproducer. The program rides
    inside the config dict (normalized by RaftConfig.__post_init__);
    the separate `program` list is checked against it."""
    with open(path) as fh:
        artifact = json.load(fh)
    if artifact.get("schema") != ARTIFACT_SCHEMA:
        raise ValueError(f"unknown reproducer schema "
                         f"{artifact.get('schema')!r}")
    cfg = RaftConfig(**artifact["config"])
    if cfg.nemesis != from_json(artifact["program"]):
        raise ValueError("reproducer program list disagrees with the "
                         "embedded config's nemesis field")
    if artifact["program_hash"] != program_hash(cfg.nemesis):
        raise ValueError("reproducer program_hash does not match its "
                         "program")
    return cfg, artifact


def verify_reproducer(artifact: dict, repro) -> dict:
    """Replay: run the caller's repro on the artifact's program and
    require the SAME violation tick and leaf. Returns the fresh report
    (raises on silence or drift — a reproducer that stopped reproducing
    is itself a finding)."""
    cfg = RaftConfig(**artifact["config"])
    rep = repro(cfg.nemesis)
    if rep is None:
        raise AssertionError("reproducer no longer reproduces (clean run)")
    want = artifact["violation"]
    if rep["tick"] != want["tick"] or _leaf_of(rep) != want["leaf"]:
        raise AssertionError(
            f"reproducer drifted: replay names tick {rep['tick']} leaf "
            f"{_leaf_of(rep)!r}, artifact recorded tick {want['tick']} "
            f"leaf {want['leaf']!r}")
    return rep
