"""What decides `correct`: the groups the timed path ran, a sample of them
drawn from the seed, against the plain reference.

Every universe of the window keeps, for `SAMPLES_PER_UNIVERSE` groups
drawn from (seed, universe), what the program produced: the whole State,
the per-group Metrics lanes and the flight-ring columns. Once the window
has closed, at most `MAX_UNIVERSES` of the universes (drawn from the
seed) are judged: the reference rebuilds those groups from the config,
their universe's seed and their global ids, runs them over the same ticks
in worker processes on the CPU (`refworker`, one batch of groups a
universe seed), and every leaf must be equal (u32 leaves compared as
u32, bools as 0/1). A group's trajectory depends only on the config, the
seed and its global id, so a sample stands for its universe.

Each universe's universe-wide Metrics (the election count and histogram,
the longest streak, the ack histogram and longest ack) are sums and
maxima over all its groups, which the sample cannot rebuild: they are
held only to their identities, checked on the whole universe as it comes
back. The election histogram sums to the election count, the longest
streak lies in the histogram's highest bucket, and with clients the ack
histogram sums to the acked ops.

The numbers compared, each with its limit (all exact, limit 0): the
sampled groups that differ from the reference, and the identity breaks.
A group the reference also makes unsafe is the semantics' own, and is
counted on a line of its own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from raftbench import spec
from raftbench.refworker import PER_GROUP_LANES, U32_LEAVES

SAMPLES_PER_UNIVERSE = 2
MAX_UNIVERSES = 128
MAX_WORKERS = 8
U32_MASK = 0xFFFFFFFF


def positions(seed: int, universe: int, groups: int,
              per_universe: int = SAMPLES_PER_UNIVERSE) -> np.ndarray:
    """The sampled positions of one universe, drawn from (seed, universe)."""
    rng = np.random.default_rng([spec.config_seed(seed), universe, 0x5EED])
    n = min(per_universe, groups)
    return np.sort(rng.choice(groups, size=n, replace=False))


def judged(seed: int, n_universes: int) -> list:
    """The universes whose samples are judged: all of them, or
    `MAX_UNIVERSES` drawn from the seed."""
    if n_universes <= MAX_UNIVERSES:
        return list(range(n_universes))
    rng = np.random.default_rng([spec.config_seed(seed), 0xC4EC])
    return sorted(rng.choice(n_universes, size=MAX_UNIVERSES,
                             replace=False).tolist())


def identity_breaks(host: dict, clients: bool) -> list:
    """The universe-wide Metrics identities a universe's host copy breaks
    (names; empty when all hold)."""
    out = []
    hist = host["metrics.hist"].numpy().astype(np.int64)
    elections = int(host["metrics.elections"])
    if int(hist.sum()) != elections:
        out.append("hist sums to the elections")
    out += _top_bucket(hist, int(host["metrics.max_latency"]),
                       "longest election streak")
    if clients:
        chist = host["metrics.client_hist"].numpy().astype(np.int64)
        acked = int(host["metrics.client_acked"].numpy().astype(
            np.int64).sum())
        if int(chist.sum()) != acked:
            out.append("ack hist sums to the acked ops")
        out += _top_bucket(chist, int(host["metrics.client_max_lat"]),
                           "longest ack")
    return out


def _top_bucket(hist: np.ndarray, longest: int, what: str) -> list:
    nz = np.flatnonzero(hist)
    top = int(nz[-1]) if nz.size else 0
    if top < hist.size - 1 and longest != top:
        return [f"{what} in the top bucket"]
    if top == hist.size - 1 and longest < top:
        return [f"{what} in the top bucket"]
    return []


class Samples:
    """The program's outputs for the sampled groups of every universe."""

    def __init__(self, seed: int):
        self.seed = seed
        self.by_universe = {}
        self.identity = []   # (universe, break)

    def keep(self, universe: int, seed: int, first_group: int,
             pos: np.ndarray, state: dict, host: dict,
             clients: bool) -> None:
        """Keep universe `universe`'s sampled groups (positions `pos`):
        `state` {leaf: host tensor [n, ...]} of the sample, `host` the
        whole universe's Metrics and ring on the host, `seed` the
        universe's seed."""
        rec = {"seed": seed, "group_ids": (first_group + pos).tolist()}
        rec.update({"state." + k: v.numpy().copy() for k, v in state.items()})
        for k, v in host.items():
            name = k.split(".", 1)[1]
            if k.startswith("metrics.") and name in PER_GROUP_LANES:
                rec[k] = v.numpy()[pos].copy()
            elif k.startswith("flight."):
                rec[k] = v.numpy()[:, pos].copy()
        self.by_universe[universe] = rec
        self.identity += [(universe, b) for b in identity_breaks(host,
                                                                 clients)]

    def judged(self) -> list:
        """The judged universes' records, those of one universe seed
        together (the order of `batches`)."""
        recs = [self.by_universe[u]
                for u in judged(self.seed, len(self.by_universe))]
        return sorted(recs, key=lambda r: r["seed"])


def batches(records: list) -> list:
    """[(universe seed, [group id, ...])] of `records` (in the order of
    `Samples.judged`), one batch a seed, in the records' order."""
    out = []
    for r in records:
        if not out or out[-1][0] != r["seed"]:
            out.append((r["seed"], []))
        out[-1][1].extend(r["group_ids"])
    return out


def _norm(name: str, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a).astype(np.int64)
    return a & U32_MASK if name in U32_LEAVES else a


def compare(program: list, reference: dict) -> dict:
    """The sampled groups, program against reference. `program`: the
    judged universes' records (`Samples.judged`), in order; `reference`:
    the reference's arrays over the same groups in the same order.
    Returns {"compared", "mismatched", "unsafe_both", "details"}."""
    n = sum(len(r["group_ids"]) for r in program)
    bad = np.zeros(n, dtype=bool)
    details = []
    at = 0
    for rec in program:
        k = len(rec["group_ids"])
        for name, ref in reference.items():
            if not name.startswith(("state.", "metrics.", "flight.")):
                continue
            ref_part = ref[:, at:at + k] if name.startswith("flight.") \
                else ref[at:at + k]
            got = rec.get(name)
            leaf = name.split(".", 1)[1]
            if got is None or got.shape != ref_part.shape:
                bad[at:at + k] = True
                details.append(f"{name}: missing or shaped "
                               f"{None if got is None else got.shape}, "
                               f"reference {ref_part.shape}")
                continue
            a, b = _norm(leaf, got), _norm(leaf, ref_part)
            if name.startswith("flight."):
                a, b = a.T, b.T
            diff = (a != b).reshape(k, -1).any(axis=1)
            if diff.any():
                bad[at:at + k] |= diff
                j = int(np.flatnonzero(diff)[0])
                details.append(f"{name}: group {rec['group_ids'][j]} "
                               f"differs")
        at += k
    ref_safe = reference["metrics.safety"]
    got_safe = np.concatenate([r["metrics.safety"] for r in program]) \
        if program else np.zeros(0)
    unsafe_both = int(((ref_safe == 0) & (got_safe == 0)).sum())
    return {"compared": n, "mismatched": int(bad.sum()),
            "unsafe_both": unsafe_both, "details": details}


def workers(n_groups: int) -> int:
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return max(1, min(MAX_WORKERS, cores - 1, n_groups))


def jobs(batches: list, n_workers: int) -> list:
    """[(fields, [group id, ...])]: each batch of `batches` ([(fields,
    group ids)], one config a batch) split into about its share of
    `n_workers` parts, at least one, in order."""
    total = sum(len(ids) for _, ids in batches)
    out = []
    for fields, ids in batches:
        n = max(1, round(n_workers * len(ids) / total))
        out += [(fields, p.tolist()) for p in np.array_split(
            np.asarray(ids, dtype=np.int64), n) if p.size]
    return out


def run_reference(batches: list, ticks: int, ring: int,
                  n_workers: int | None = None) -> dict:
    """The reference over `batches` ([(RaftConfig fields, group ids)]),
    split over worker processes on the CPU (each waited for). Returns the
    arrays joined in the batches' order, "ops" summed and
    "group_bytes"."""
    n_workers = n_workers or workers(sum(len(ids) for _, ids in batches))
    parts = jobs(batches, n_workers)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    outs = []
    with tempfile.TemporaryDirectory(prefix="raftbench-ref-") as tmp:
        procs = []
        try:
            for j, (fields, part) in enumerate(parts):
                job = Path(tmp) / f"job{j}.json"
                job.write_text(json.dumps({"fields": fields, "ticks": ticks,
                                           "ring": ring,
                                           "group_ids": part}))
                out = Path(tmp) / f"out{j}.npz"
                outs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "raftbench.refworker", str(job),
                     str(out)], cwd=spec.ROOT, env=env,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                    text=True))
            errs = [p.communicate()[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [e for p, e in zip(procs, errs) if p.returncode != 0]
        if failed:
            raise RuntimeError("reference worker failed:\n" + failed[0][-4000:])
        loaded = [dict(np.load(o)) for o in outs]
    joined = {}
    for name in loaded[0]:
        if name == "ops":
            joined[name] = float(sum(d[name] for d in loaded))
        elif name == "group_bytes":
            joined[name] = int(loaded[0][name])
        elif name.startswith("flight."):
            joined[name] = np.concatenate([d[name] for d in loaded], axis=1)
        else:
            joined[name] = np.concatenate([d[name] for d in loaded], axis=0)
    return joined
