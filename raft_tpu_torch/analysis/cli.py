"""`raft-tpu-torch-audit` console entry and the body of
`scripts/torch_static_audit.py`.

Exit status is the verdict: 0 when every contract holds, 1 on drift
(each problem printed, naming the leaf and the registry). `--json`
prints the whole report; `--inject-drift LEAF` is the self-test: it
audits a PerNode that grew a fake leaf, and a history whose backfill
drops the streamed-mesh keys, and must exit non-zero naming both.
"""

from __future__ import annotations

import argparse
import json
import sys


def _inject_drift(leaf: str) -> int:
    import types

    from raft_tpu_torch.analysis import contracts
    from raft_tpu_torch.obs import history, manifest
    from raft_tpu_torch.sim.state import PerNode

    problems = contracts.wire_registry_problems(
        pernode_fields=PerNode._fields + (leaf,))
    for p in problems:
        print(f"CONTRACT DRIFT: {p}")
    if not any(leaf in p for p in problems):
        print("SELF-TEST FAILED: injected drift went undetected")
        return 2

    def drifted_backfill(rec):
        out = history.backfill_record(rec)
        for k in manifest.STREAM_MESH_KEYS:
            out.pop(k, None)
        return out

    stub = types.SimpleNamespace(backfill_record=drifted_backfill)
    mesh = [p for p in contracts.manifest_problems(history_mod=stub)
            if "stream_slowest_device" in p]
    for p in mesh:
        print(f"CONTRACT DRIFT (synthetic history): {p}")
    if not mesh:
        print("SELF-TEST FAILED: a backfill dropping STREAM_MESH_KEYS went "
              "undetected by manifest_problems")
        return 2
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="raft-tpu-torch-audit",
        description="Static audit of the PyTorch port: State and wire "
                    "registries vs the kernel's field enum, the gating "
                    "table, the shard rule, checkpoint coverage, the "
                    "derived byte model and the lint; with --level deep "
                    "the model checker's smoke and the stream-ordering "
                    "hazard prover. rc != 0 on any drift.")
    ap.add_argument("--json", action="store_true",
                    help="print the whole machine-readable report")
    ap.add_argument("--level", choices=("static", "full", "deep"),
                    default="full",
                    help="'static' skips the behavioural round trips; "
                         "'deep' adds the model checker's smoke and the "
                         "hazard prover (no card needed)")
    ap.add_argument("--deep", action="store_true",
                    help="alias for --level deep")
    ap.add_argument("--bytes", action="store_true",
                    help="also print the per-leaf derived byte table")
    ap.add_argument("--inject-drift", metavar="LEAF", default=None,
                    help="self-test: audit a PerNode that grew this fake "
                         "leaf (must exit non-zero naming it)")
    args = ap.parse_args(argv)
    if args.deep:
        args.level = "deep"
    if args.inject_drift:
        return _inject_drift(args.inject_drift)

    from raft_tpu_torch import analysis
    from raft_tpu_torch.analysis import lint

    report = analysis.audit_report(level=args.level)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
        return 0 if report["ok"] else 1
    for p in report["problems"]:
        print(f"CONTRACT DRIFT: {p}")
    for f in report["lint"]:
        print(f"LINT: {lint.Finding(**f)}")
    if args.bytes:
        for label, model in report["byte_model"].items():
            print(f"derived wire model [{label}]: "
                  f"{model['wire_bytes_derived']} B/group at rest, "
                  f"{model['working_bytes_derived']} working")
            for row in sorted(model["leaves"],
                              key=lambda r: -r["rest_words"]):
                print(f"  {4 * row['rest_words']:6d} B  {row['name']:34s} "
                      f"{row['dtype']}")
    print(f"kernel plan: skipped ({report['kernel_plan']['skipped']})")
    if report["ok"]:
        hb = report["byte_model"]["headline"]["wire_bytes_derived"]
        cb = report["byte_model"]["clients"]["wire_bytes_derived"]
        print(f"static audit ok ({args.level}): contracts (wire registries "
              f"and fused_chunk.cu's field enum, gating, shard rule, "
              f"checkpoint coverage) + byte model (headline {hb} B/group, "
              f"clients {cb} B/group with the flight ring, derived == "
              f"kernel) + lint all clean")
        if "verify" in report:
            v = report["verify"]
            print(f"verification ok (deep): mcheck smoke "
                  f"[{v['mcheck_smoke']}] + hazard prover "
                  f"({v['hazard_configs']} scheduler configs, "
                  f"{v['hazard_events']} events {v['hazard_counts']}, "
                  f"0 hazards, {v['negatives_caught']}/{v['negatives']} "
                  f"negatives caught: {v['negative_sites']})")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
