"""Budgeted multi-seed nemesis fleet of the PyTorch/CUDA port: one
`scripts/torch_nemesis_search.py` hunt per seed, each its own process
(a wedged candidate cannot take the fleet down), all into one shared
`--corpus`, so every hunt after the first starts from every
coverage-novel program the earlier ones found. Then the fleet triages
what it produced:

- violations are deduped by their (divergent leaf, tick) signature,
  keeping the reproducer with the fewest clauses per signature;
- clean hunts are ranked by their best near-miss score (each child's
  `best score` line), so the next fleet's budget and `--check-kernel`
  go to the seeds closest to the edge.

One JSONL report: one record per hunt, then a summary record.

    python3 scripts/torch_nemesis_fleet.py --seeds 8 --budget 12 \\
        --groups 1024 --ticks 64 --corpus corpus/ --report fleet.jsonl
    python3 scripts/torch_nemesis_fleet.py --device cpu --budget 2 \\
        --groups 2 --ticks 16        # the plain engine on the CPU

`--check-kernel` and `--device` pass through to every hunt; without
`--device cpu` the hunts run on the card (rc 2 here without one). rc 3
if any hunt found a violation (the deduped artifacts are the findings),
rc 1 if a child died abnormally, rc 0 on a clean fleet.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

_SEARCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_nemesis_search.py")

# The child's corpus and score line (logged on every clean exit); a hunt
# without one ranks last.
_SCORE_RE = re.compile(r"best score (-?[\d.]+):")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _corpus_size(dirpath: str) -> int:
    return len(glob.glob(os.path.join(dirpath, "corpus_*.json")))


def run_hunt(seed: int, args) -> dict:
    """One child hunt: its own process, its own artifact path, the
    shared corpus directory. Returns the fleet report's record."""
    out = os.path.join(args.out_dir, f"NEMESIS_repro_seed{seed}.json")
    cmd = [sys.executable, _SEARCH, "--seed", str(seed),
           "--budget", str(args.budget), "--groups", str(args.groups),
           "--ticks", str(args.ticks), "--corpus", args.corpus,
           "--out", out, "--device", args.device]
    if args.check_kernel:
        cmd.append("--check-kernel")
    before = _corpus_size(args.corpus)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"  [seed {seed}] {line}")
    m = _SCORE_RE.search(proc.stderr)
    rec = {"kind": "fleet-hunt", "seed": seed, "rc": proc.returncode,
           "budget": args.budget, "groups": args.groups,
           "ticks": args.ticks, "wall_s": round(wall, 2),
           "best_score": float(m.group(1)) if m else None,
           "corpus_new": _corpus_size(args.corpus) - before,
           "artifact": None, "violation": None}
    if proc.returncode == 3 and os.path.exists(out):
        with open(out) as fh:
            art = json.load(fh)
        rec["artifact"] = out
        rec["violation"] = {"tick": art["violation"]["tick"],
                            "leaf": art["violation"]["leaf"],
                            "program_hash": art["program_hash"],
                            "clauses": len(art["program"])}
    elif proc.returncode not in (0, 3):
        rec["stderr_tail"] = proc.stderr.splitlines()[-5:]
    return rec


def triage(records: list) -> dict:
    """The fleet's summary: violations deduped by (leaf, tick), keeping
    the fewest-clause reproducer of each signature, and the hunts ranked
    by best near-miss score."""
    by_sig: dict = {}
    for r in records:
        v = r["violation"]
        if v is None:
            continue
        key = (v["leaf"], v["tick"])
        cur = by_sig.get(key)
        if cur is None or v["clauses"] < cur["violation"]["clauses"]:
            by_sig[key] = r
    ranked = sorted((r for r in records if r["best_score"] is not None),
                    key=lambda r: -r["best_score"])
    return {
        "kind": "fleet-summary",
        "hunts": len(records),
        "violations_total": sum(1 for r in records if r["violation"]),
        "violations_unique": len(by_sig),
        "unique_violations": [
            {"leaf": leaf, "tick": tick,
             "seed": r["seed"], "artifact": r["artifact"],
             "program_hash": r["violation"]["program_hash"],
             "clauses": r["violation"]["clauses"]}
            for (leaf, tick), r in sorted(by_sig.items())],
        "ranked_seeds": [{"seed": r["seed"],
                          "best_score": r["best_score"]}
                         for r in ranked],
        "child_failures": [r["seed"] for r in records
                           if r["rc"] not in (0, 3)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4,
                    help="fleet size: hunts run seeds "
                         "[--seed-base, --seed-base + N)")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--budget", type=int, default=12,
                    help="mutate-run-score steps per hunt")
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="every hunt's device (cpu: the plain engine)")
    ap.add_argument("--corpus", default="nemesis_corpus",
                    help="the shared corpus directory: every hunt seeds "
                         "from it and writes its novel programs back")
    ap.add_argument("--report", default="fleet_report.jsonl",
                    help="JSONL fleet report: one record per hunt and a "
                         "summary")
    ap.add_argument("--out-dir", default=".",
                    help="where the per-seed violation artifacts land")
    ap.add_argument("--check-kernel", action="store_true",
                    help="pass --check-kernel to every hunt (each hunt's "
                         "best program through the kernel against the "
                         "plain tick)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            log("torch_nemesis_fleet: CUDA is not available (pass --device "
                "cpu to hunt on the CPU)")
            return 2

    os.makedirs(args.corpus, exist_ok=True)
    os.makedirs(args.out_dir, exist_ok=True)
    seeds = range(args.seed_base, args.seed_base + args.seeds)
    log(f"fleet: {args.seeds} hunt(s) x budget {args.budget} "
        f"({args.groups} groups x {args.ticks} ticks per candidate on "
        f"{args.device}), shared corpus {args.corpus!r} "
        f"({_corpus_size(args.corpus)} program(s) seeded)")
    records = []
    with open(args.report, "a") as rep:
        for seed in seeds:
            rec = run_hunt(seed, args)
            records.append(rec)
            rep.write(json.dumps(rec, sort_keys=True) + "\n")
            rep.flush()
            tag = ("VIOLATION" if rec["violation"]
                   else "died" if rec["rc"] not in (0, 3) else "clean")
            log(f"[seed {seed}] {tag} rc={rec['rc']} "
                f"score={rec['best_score']} "
                f"corpus+{rec['corpus_new']} ({rec['wall_s']}s)")
        summary = triage(records)
        summary["corpus_size"] = _corpus_size(args.corpus)
        rep.write(json.dumps(summary, sort_keys=True) + "\n")
    log(f"fleet report -> {args.report}: "
        f"{summary['violations_total']} violation(s), "
        f"{summary['violations_unique']} unique by (leaf, tick); "
        f"corpus {summary['corpus_size']} program(s)")
    for v in summary["unique_violations"]:
        log(f"  finding: leaf={v['leaf']!r} tick={v['tick']} "
            f"program {v['program_hash']} ({v['clauses']} clause(s)) "
            f"-> {v['artifact']}")
    if summary["child_failures"]:
        log(f"  child hunt(s) died abnormally: "
            f"{summary['child_failures']}")
        return 1
    return 3 if summary["violations_unique"] else 0


if __name__ == "__main__":
    sys.exit(main())
