"""Bench history: the rate-bearing records of a run manifest
(`obs.manifest`) as one trajectory, with a trend table and a regression
gate (the JAX package's `obs/history.py`, same row schema and gate).

Each row::

    {"source": file, "round": None, "segment": str,
     "engine": "kernel" | "plain", "unit": "rounds/s" | ...,
     "value": float, "n_groups": int | None, "extra": {...}}

A series is (segment, engine class, unit), ordered by the records'
`unix_time`; the gate compares each series' latest point with its best
earlier one. Only records measured on a card (`device` starting with
"cuda") at a real shape (at least `QUICK_GROUP_FLOOR` groups) join the
trajectory: a CPU or smoke-size record would always be a series' latest
point and trip, or mask, the gate. Skipped records are announced on
stderr. The port's history reads no `BENCH_r*.json` or `MULTICHIP_*.json`:
those hold the JAX package's numbers from another accelerator.
"""

from __future__ import annotations

import json
import os
import sys

from raft_tpu_torch.obs.manifest import ALL_KEYS
from raft_tpu_torch.obs.roofline import engine_class

# Records below this group count are smoke shapes, not trajectory points
# (the smallest real run is election rounds at 10,000 groups).
QUICK_GROUP_FLOOR = 10_000

# Manifest segment name -> (rate key, unit).
_MANIFEST_RATES = {
    "throughput": ("rounds_per_sec", "rounds/s"),
    "config-4 fault run": ("rounds_per_sec", "rounds/s"),
    "config-5 fault mix": ("rounds_per_sec", "rounds/s"),
    "election-rounds": ("elections_per_sec", "elections/s"),
    "reads": ("reads_per_sec", "reads/s"),
    "client-slo fault mix": ("client_ops_per_sec", "ops/s"),
}


def backfill_record(rec: dict) -> dict:
    """A manifest record with every registry key (`obs.manifest`)
    present, null where the record predates it. Returns a new dict."""
    out = dict(rec)
    for k in ALL_KEYS:
        out.setdefault(k, None)
    return out


def _row(source, segment, engine, unit, value, n_groups, **extra) -> dict:
    return {"source": os.path.basename(str(source)), "round": None,
            "segment": segment, "engine": engine_class(engine),
            "unit": unit, "value": float(value),
            "n_groups": int(n_groups) if n_groups is not None else None,
            "extra": extra}


def rate_of(rec: dict):
    """(rate key, unit) of a rate-bearing record, else None."""
    rate = _MANIFEST_RATES.get(rec.get("segment"))
    return rate if rate is not None and rec.get(rate[0]) is not None \
        else None


def parse_manifest_file(path: str) -> list[dict]:
    """One row per rate-bearing record of a manifest JSONL, each record
    backfilled first; records off the card or at a smoke shape are
    skipped, and the skip is announced on stderr. A torn line is
    ignored."""
    rows, skipped = [], 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = backfill_record(json.loads(line))
            except json.JSONDecodeError:
                continue
            rate = rate_of(rec)
            if rate is None:
                continue
            g = rec.get("n_groups")
            if not (rec.get("device") or "").startswith("cuda") or (
                    g is not None and g < QUICK_GROUP_FLOOR):
                skipped += 1
                continue
            rows.append(_row(path, rec["segment"], rec.get("engine"),
                             rate[1], rec[rate[0]], g,
                             unix_time=rec.get("unix_time"),
                             attainment_pct=rec.get("attainment_pct"),
                             bound=rec.get("bound")))
    if skipped:
        print(f"[bench-history] {os.path.basename(str(path))}: skipped "
              f"{skipped} off-card/smoke-shape record(s), not trajectory "
              f"points", file=sys.stderr)
    return rows


def load_history(manifest: str) -> list[dict]:
    """Every row of the manifest file `manifest`, sorted by series and
    then by emission time."""
    rows = parse_manifest_file(manifest)
    rows.sort(key=lambda r: (r["segment"], r["engine"],
                             r["extra"].get("unix_time") or 0))
    return rows


def series(rows: list[dict]) -> dict:
    """Rows grouped by series identity (segment, engine, unit), order
    kept."""
    out: dict = {}
    for r in rows:
        out.setdefault((r["segment"], r["engine"], r["unit"]),
                       []).append(r)
    return out


def trend_table(rows: list[dict]) -> str:
    """One block per series, one line per point, with its change against
    the previous point and against the best before it."""
    lines = []
    for (segment, engine, unit), pts in sorted(series(rows).items()):
        lines.append(f"{segment} [{engine}] ({unit})")
        best = None
        for i, r in enumerate(pts):
            rnd = (f"r{r['round']:02d}" if r["round"] is not None
                   else "manif")
            d_prev = d_best = ""
            if best is not None:
                prev = pts[i - 1]["value"]
                d_prev = f"{100 * (r['value'] - prev) / prev:+7.1f}% prev"
                d_best = f"{100 * (r['value'] - best) / best:+7.1f}% best"
            g = f"{r['n_groups']:>7}" if r["n_groups"] else "      ?"
            lines.append(f"  {rnd}  {g} groups  {r['value']:>14,.1f}  "
                         f"{d_prev:>14}  {d_best:>14}")
            best = r["value"] if best is None else max(best, r["value"])
        lines.append("")
    return "\n".join(lines)


def regressions(rows: list[dict], threshold: float = 0.15) -> list[dict]:
    """Series whose latest point fell more than `threshold` below the
    best point before it. A unit ending in "ticks" (a latency) would
    regress upward; none is trended, so such series are skipped."""
    out = []
    for (segment, engine, unit), pts in sorted(series(rows).items()):
        if len(pts) < 2 or unit.endswith("ticks"):
            continue
        latest = pts[-1]
        best = max(pts[:-1], key=lambda r: r["value"])
        drop = (best["value"] - latest["value"]) / best["value"]
        if drop > threshold:
            out.append({
                "segment": segment, "engine": engine, "unit": unit,
                "latest": latest["value"],
                "latest_source": latest["source"], "best": best["value"],
                "best_source": best["source"],
                "drop_pct": round(100 * drop, 1),
                "threshold_pct": round(100 * threshold, 1),
            })
    return out
