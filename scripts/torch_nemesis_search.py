"""Coverage-guided adversarial nemesis search on the PyTorch port
(raft_tpu_torch.nemesis.search): the counterpart of
scripts/nemesis_search.py, on the card unless `--device cpu` is given.

Mutates gray-failure programs over a faulted base universe, scores each
candidate run of the plain tick by safety-fold near-misses and
flight-ring health, and keeps a corpus of coverage-novel programs. A
candidate that drops the per-tick safety bit is shrunk (clause drops and
span halvings) to a minimal reproducer and written as a JSON artifact.
The hunt is deterministic in --seed, on every device and in either
package.

    # hunt (rc 3 and an artifact on a violation, rc 0 on a clean budget):
    python scripts/torch_nemesis_search.py --groups 16 --ticks 64 --budget 24
    # replay a reproducer (rc 1 if it stopped reproducing or names
    # another tick or leaf):
    python scripts/torch_nemesis_search.py --replay NEMESIS_repro_example.json
    # cross-engine check of the best program: the plain tick against the
    # fused-chunk CUDA kernel, any divergence bisected and shrunk:
    python scripts/torch_nemesis_search.py --budget 12 --check-kernel
    # the same on the CPU, where the kernel's plain version stands in:
    python scripts/torch_nemesis_search.py --device cpu --check-kernel

A model-checker reproducer (`verify/mcheck.py`, from either package)
replays on the checker's universe, the CPU oracle, whatever `--device`.

Exit codes: 0 clean, 1 a replay that drifted, 2 a refused request (no
CUDA device, an incomplete artifact), 3 a violation or an engine
divergence found.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable as `python scripts/...`

import torch  # noqa: E402

from raft_tpu_torch.config import RaftConfig  # noqa: E402
from raft_tpu_torch.nemesis import describe, program_hash  # noqa: E402
from raft_tpu_torch.nemesis import search as nsearch  # noqa: E402

# Engine names written into the artifacts this script writes.
SEEDED, SAFETY, KERNEL = ("torch-vs-seeded-corruption", "torch-safety-fold",
                          "torch-vs-cuda-kernel")
# Artifacts of a cross-engine divergence, from either package.
KERNEL_ENGINES = (KERNEL, "xla-vs-pallas-interpret")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def base_config(seed: int) -> RaftConfig:
    """The search's base universe (scripts/nemesis_search.py's): light
    always-on churn, so clauses compose with a live fault background,
    and a small ring."""
    return RaftConfig(seed=seed, k=3, log_cap=8, compact_every=4,
                      drop_prob=0.03, crash_prob=0.1, crash_epoch=24)


def artifact_kind(path: str):
    with open(path) as fh:
        return json.load(fh).get("kind")


def replay_mcheck(path: str) -> int:
    """A model-checker counterexample: its explicit schedule replays on
    the checker's own universe (the CPU oracle), on no device."""
    from raft_tpu_torch.verify import mcheck
    art = mcheck.load_reproducer(path)
    missing = [k for k in ("bounds", "schedule", "violation", "n_ticks")
               if k not in art]
    if missing:
        log(f"{path}: not a complete verify/mcheck reproducer (no "
            f"{missing})")
        return 2
    log(f"replaying {path} on the model checker's universe: "
        f"{art['n_ticks']} scheduled tick(s), mutant "
        f"{art.get('mutant')!r}, expecting tick "
        f"{art['violation']['tick']} leaf {art['violation']['leaf']!r}")
    try:
        rep = mcheck.replay(art)
    except AssertionError as e:
        log(f"REPLAY FAILED: {e}")
        return 1
    log(f"replay ok: tick {rep['tick']} — {rep['predicates']}")
    return 0


def replay(path: str, n_groups: int, device: str) -> int:
    cfg, artifact = nsearch.load_reproducer(path)
    n_ticks = artifact["n_ticks"]
    # The artifact's own run shape wins: the violating group must exist.
    n_groups = artifact.get("n_groups") or n_groups
    log(f"replaying {path} on {device}: {len(cfg.nemesis)} clause(s), "
        f"program {artifact['program_hash']}, engines "
        f"{artifact['engines']!r}, expecting tick "
        f"{artifact['violation']['tick']} leaf "
        f"{artifact['violation']['leaf']!r}")
    inject = artifact.get("inject")
    if inject is not None:
        # A seeded violation: rebuild the corrupting engine from the
        # recorded parameters and bisect it against the clean tick.
        pair = nsearch.term_corruption_pair(
            inject["tick"], inject["group"], inject["node"],
            inject.get("bump", 4))
        repro = nsearch.divergence_repro(cfg, pair, n_groups, n_ticks,
                                         device=device)
    elif artifact["engines"] in KERNEL_ENGINES:
        repro = nsearch.divergence_repro(cfg, nsearch.plain_vs_kernel,
                                         n_groups, n_ticks, device=device)
    else:
        repro = nsearch.safety_repro(cfg, n_groups, n_ticks, device=device)
    try:
        rep = nsearch.verify_reproducer(artifact, repro)
    except AssertionError as e:
        log(f"REPLAY FAILED: {e}")
        return 1
    log(f"replay ok: tick {rep['tick']} — {rep['leaf_report']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--budget", type=int, default=24,
                    help="mutate-run-score steps")
    ap.add_argument("--seed", type=int, default=0,
                    help="search seed (mutations AND the base universe)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (default cuda; pass cpu "
                         "to run without a card)")
    ap.add_argument("--out", default="NEMESIS_repro.json",
                    help="where a shrunk violation artifact is written")
    ap.add_argument("--replay", default=None, metavar="ARTIFACT",
                    help="replay a reproducer artifact instead of "
                         "searching (rc 1 on drift)")
    ap.add_argument("--corpus", default=None, metavar="DIR",
                    help="persist/reload the coverage corpus: seed the "
                         "hunt from every program in DIR, write every "
                         "coverage-novel program back")
    ap.add_argument("--check-kernel", action="store_true",
                    help="after the hunt, run the best program through "
                         "the fused-chunk kernel (on the CPU its plain "
                         "version) and bisect any divergence from the "
                         "plain tick")
    ap.add_argument("--seed-violation", type=int, default=None,
                    metavar="TICK",
                    help="skip the hunt: inject a known safety violation "
                         "(term bump at TICK, armed only while a clause "
                         "is active) under the gray mix, shrink it, write "
                         "the artifact and verify it replays")
    args = ap.parse_args(argv)

    if args.replay and artifact_kind(args.replay) == "mcheck-reproducer":
        return replay_mcheck(args.replay)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: pass --device cpu to run on the CPU")
        return 2

    if args.replay:
        return replay(args.replay, args.groups, args.device)

    base = base_config(args.seed)
    if args.seed_violation is not None:
        from raft_tpu_torch.nemesis import gray_mix
        t = args.seed_violation
        prog = gray_mix(args.ticks)
        pair = nsearch.term_corruption_pair(t)
        repro = nsearch.divergence_repro(base, pair, args.groups, args.ticks,
                                         chunk=1, device=args.device)
        log(f"seeded violation: term bump at tick {t} (armed under the "
            f"program) over {describe(prog)} — shrinking")
        mini, rep = nsearch.shrink(prog, repro, log=log)
        artifact = nsearch.reproducer(
            dataclasses.replace(base, nemesis=mini), args.ticks, rep,
            engines=SEEDED,
            inject={"kind": "term_flip", "tick": t, "group": 0, "node": 1,
                    "bump": 4},
            n_groups=args.groups,
            note=f"seeded self-test: torch_nemesis_search --seed-violation "
                 f"{t} --seed {args.seed}")
        nsearch.save_reproducer(args.out, artifact)
        log(f"minimal reproducer ({len(mini)} clause(s), program "
            f"{program_hash(mini)}) -> {args.out}: tick {rep['tick']} "
            f"leaf {rep['leaf']}")
        nsearch.verify_reproducer(artifact, repro)
        log("replay verified: same tick + leaf")
        return 0

    seed_corpus = None
    if args.corpus:
        seed_corpus = nsearch.load_corpus(args.corpus)
        if seed_corpus:
            log(f"corpus: seeded {len(seed_corpus)} program(s) from "
                f"{args.corpus}")
    log(f"hunting on {args.device}: {args.groups} groups x {args.ticks} "
        f"ticks per candidate, budget {args.budget}, seed {args.seed}")
    res = nsearch.search(base, args.groups, args.ticks, args.budget,
                         seed=args.seed, log=log, seed_corpus=seed_corpus,
                         device=args.device)
    log(f"corpus: {len(res['corpus'])} program(s), "
        f"{len(res['coverage'])} coverage signature(s); best score "
        f"{res['best_score']:.1f}: {describe(res['best'])}")
    if args.corpus:
        n = nsearch.save_corpus(args.corpus, res["corpus"])
        log(f"corpus: persisted {n} program(s) -> {args.corpus}")

    rc = 0
    if res["violations"]:
        prog, sig = res["violations"][0]
        log(f"VIOLATION: {sig['unsafe_groups']} unsafe group(s) under "
            f"{describe(prog)} — shrinking")
        repro = nsearch.safety_repro(base, args.groups, args.ticks,
                                     device=args.device)
        mini, rep = nsearch.shrink(prog, repro, log=log)
        artifact = nsearch.reproducer(
            dataclasses.replace(base, nemesis=mini), args.ticks, rep,
            engines=SAFETY, n_groups=args.groups,
            note=f"found by torch_nemesis_search --seed {args.seed} "
                 f"--budget {args.budget}")
        nsearch.save_reproducer(args.out, artifact)
        log(f"minimal reproducer ({len(mini)} clause(s), program "
            f"{program_hash(mini)}) -> {args.out}: tick {rep['tick']} "
            f"— {rep['leaf_report']}")
        rc = 3

    if args.check_kernel:
        log(f"cross-engine check on {args.device}: the best program through "
            f"the fused-chunk kernel vs the plain tick")
        repro = nsearch.divergence_repro(base, nsearch.plain_vs_kernel,
                                         args.groups, args.ticks,
                                         device=args.device)
        rep = repro(res["best"])
        if rep is None:
            log("engines bit-identical under the best program")
        else:
            mini, rep = nsearch.shrink(res["best"], repro, log=log)
            artifact = nsearch.reproducer(
                dataclasses.replace(base, nemesis=mini), args.ticks, rep,
                engines=KERNEL, n_groups=args.groups,
                note="engine divergence found by --check-kernel")
            out = args.out.replace(".json", "_divergence.json")
            nsearch.save_reproducer(out, artifact)
            log(f"ENGINE DIVERGENCE shrunk -> {out}: tick {rep['tick']} "
                f"leaf {rep['leaf']}")
            rc = 3
    return rc


if __name__ == "__main__":
    sys.exit(main())
