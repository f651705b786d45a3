"""Static audit of the port: prove, before anything runs on a card,
that the plain tick, the CUDA kernel's wire, the CPU oracle, the
checkpoint format and the manifest schema agree, and that the streamed
pipelines order their copies and launches safely (the JAX package's
`analysis/`).

- `contracts`: the leaf-contract passes (wire registries and the
  kernel's field enum, the gating table, the shard rule, checkpoint
  coverage and backfills, packing, narrowing, nemesis, streaming,
  manifests, rng/trng parity), and `kernel_plan_problems`, which asks
  the card's launcher;
- `bytemodel`: the derived byte model, reconciled with the kernel's;
- `lint`: the AST rules over the tick and launch path (tagged
  randomness, no host sync on a tensor's value, the elementwise client
  transition, no untagged widening).

Entry points: `audit_report()` (a machine-readable dict),
`audit_problems()` (flat strings), `startup_audit()` (raise on drift:
a benchmark calls it first, so no number is published off a drifted
layout), and `scripts/torch_static_audit.py` / the
`raft-tpu-torch-audit` console script (exit status is the verdict).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.analysis import bytemodel, contracts, lint

__all__ = ["audit_report", "audit_problems", "startup_audit",
           "bytemodel", "contracts", "lint"]

LEVELS = ("static", "full", "deep")


def audit_report(level: str = "full") -> dict:
    """Run every pass; return the report.

    `level="static"` skips the behavioural passes (checkpoint, packing,
    narrowing and paging round trips on tiny CPU states), the cheap form
    a benchmark's start takes; `"full"` is the script's default; `"deep"`
    adds the verification passes: the model checker's smoke (the clean
    oracle exhaustively at tiny scope, the narrow-width agreement and a
    canary mutant's kill, `verify/mcheck.py`) and the stream-ordering
    hazard prover over its grid with its negatives (`verify/hazards.py`).
    None of them needs a card. The one pass that does,
    `contracts.kernel_plan_problems`, asks the launcher of each build a
    run loads, so it runs after the builds (chip_smoke.py phase (k2)):
    the report names it skipped."""
    if level not in LEVELS:
        raise ValueError(f"unknown audit level {level!r}")
    from raft_tpu_torch.obs.recorder import RING
    problems = contracts.contract_problems(
        include_behavioral=(level != "static"))
    byte_models = {}
    for label, cfg in bytemodel.audit_cfgs():
        for ring in (RING, 0):
            model = bytemodel.derived_wire_model(cfg, ring)
            problems += [f"byte model [{label}, ring={ring}]: {p}"
                         for p in model["problems"]]
            if ring:
                byte_models[label] = model
    problems += bytemodel.wire_pin_problems()
    problems += bytemodel.narrow_model_problems()
    findings = lint.lint_default()
    report = {"level": level, "problems": problems,
              "lint": [f.as_dict() for f in findings],
              "byte_model": byte_models}
    report["kernel_plan"] = {
        "skipped": ("no CUDA device" if not torch.cuda.is_available() else
                    "runs after the builds: contracts.kernel_plan_problems")}
    if level == "deep":
        from raft_tpu_torch.verify import hazards, mcheck
        smoke = mcheck.smoke()
        if not (smoke.ok and smoke.complete):
            problems.append("mcheck smoke: clean oracle not exhaustively "
                            f"verified at smoke scope ({smoke.summary()})")
        haz = hazards.prove_schedulers()
        problems += [f"scheduler hazard: {h}" for h in haz["hazards"]]
        neg = hazards.prove_negatives()
        if neg["missed"]:
            problems.append("hazard prover failed to catch synthetic "
                            "negatives: " + ", ".join(neg["missed"]))
        report["verify"] = {
            "mcheck_smoke": smoke.summary(),
            "hazard_configs": haz["configs"],
            "hazard_events": haz["events"],
            "hazard_counts": haz["counts"],
            "negatives_caught": neg["caught"],
            "negatives": len(hazards.NEGATIVES),
            "negative_sites": {n: f"{neg['rules'][n]} at {s}"
                               for n, s in neg["sites"].items()},
        }
    report["ok"] = not problems and not findings
    return report


def audit_problems(level: str = "full") -> list[str]:
    """Every problem as one flat list of strings (lint findings as
    file:line)."""
    rep = audit_report(level=level)
    return rep["problems"] + [str(lint.Finding(**f)) for f in rep["lint"]]


def startup_audit(level: str = "static", log=None) -> None:
    """The pre-flight gate of a benchmark: raise `RuntimeError` listing
    every drift, so no number is published off a drifted layout. Runs
    no kernel and needs no card."""
    probs = audit_problems(level=level)
    if probs:
        raise RuntimeError(
            "static audit failed — refusing to run on a drifted layout "
            "(scripts/torch_static_audit.py for the report):\n  "
            + "\n  ".join(probs))
    if log is not None:
        log(f"static audit ok ({level}): contracts, byte model and lint "
            f"all clean")
