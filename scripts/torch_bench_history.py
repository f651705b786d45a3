#!/usr/bin/env python
"""Trend table and regression gate over a run manifest of the PyTorch
port (`raft_tpu_torch.obs.history`).

    python scripts/torch_bench_history.py --manifest runs.jsonl
    python scripts/torch_bench_history.py --manifest runs.jsonl --check \\
        [--threshold 0.15] [--baseline known.json]
    python scripts/torch_bench_history.py --manifest runs.jsonl \\
        --write-baseline known.json

Reads the manifest JSONL the caller names (records written by
`obs.manifest.emit_manifest`), prints one block per series, and with
`--check` exits 2 when a series' latest point fell more than
`--threshold` below its best earlier point. With `--baseline FILE`, a
regression the file records passes unless its drop deepened more than
`BASELINE_SLACK_PCT` points past the recorded one; `--write-baseline`
records the current regressions and exits 0. Exits 1 when the manifest
holds no rate measured on a card. Pure file parsing: no card, no
kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from raft_tpu_torch.obs import history  # noqa: E402

# A baselined regression may deepen this many percentage points past its
# recorded drop before it counts as new again.
BASELINE_SLACK_PCT = 1.0


def _reg_key(r: dict) -> str:
    """A regressing series' identity in the baseline file."""
    return f"{r['segment']}|{r['engine']}|{r['unit']}"


def split_known(regs: list, baseline: dict) -> tuple[list, list]:
    """(new, known): a regression is known iff the baseline records its
    series and its drop has not deepened past the recorded one plus
    BASELINE_SLACK_PCT."""
    new, known = [], []
    for r in regs:
        rec = baseline.get(_reg_key(r))
        if rec is not None and \
                r["drop_pct"] <= rec["drop_pct"] + BASELINE_SLACK_PCT:
            known.append(r)
        else:
            new.append(r)
    return new, known


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--manifest", required=True,
                    help="the run manifest JSONL to read")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 when a series regresses past the threshold")
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="relative drop that counts as a regression "
                         "(default 0.15)")
    ap.add_argument("--json", action="store_true",
                    help="print the rows and regressions as JSON")
    ap.add_argument("--baseline", default=None,
                    help="JSON file of known regressions")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="record the current regressions as known, exit 0")
    args = ap.parse_args(argv)

    rows = history.load_history(args.manifest)
    if not rows:
        print(f"no rate measured on a card in {args.manifest!r}",
              file=sys.stderr)
        return 1
    regs = history.regressions(rows, threshold=args.threshold)
    if args.write_baseline:
        base = {_reg_key(r): {"drop_pct": r["drop_pct"], "best": r["best"],
                              "latest": r["latest"],
                              "best_source": r["best_source"],
                              "latest_source": r["latest_source"]}
                for r in regs}
        with open(args.write_baseline, "w") as f:
            json.dump({"threshold": args.threshold,
                       "slack_pct": BASELINE_SLACK_PCT, "known": base}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(base)} known regression(s) to "
              f"{args.write_baseline}", file=sys.stderr)
        return 0
    baseline = {}
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)["known"]
    new, known = split_known(regs, baseline)
    if args.json:
        print(json.dumps({"rows": rows, "regressions": regs,
                          "new_regressions": new}, indent=1))
    else:
        print(history.trend_table(rows))
        print(f"{len(rows)} points across {len(history.series(rows))} "
              f"series")
    for r in known:
        print(f"known regression (baselined): {r['segment']} "
              f"[{r['engine']}] -{r['drop_pct']}% vs best ancestor",
              file=sys.stderr)
    if new:
        for r in new:
            print(f"REGRESSION: {r['segment']} [{r['engine']}] "
                  f"{r['latest']:,.1f} {r['unit']} ({r['latest_source']}) "
                  f"is -{r['drop_pct']}% vs best ancestor "
                  f"{r['best']:,.1f} ({r['best_source']}); "
                  f"threshold {r['threshold_pct']}%", file=sys.stderr)
        if args.check:
            return 2
    elif args.check:
        extra = f" ({len(known)} baselined)" if known else ""
        print(f"regression check clean at threshold {args.threshold}"
              f"{extra}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
