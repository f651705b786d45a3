"""Layout report of the PyTorch/CUDA port: the bytes a group costs and
what the card's layout makes of them (the JAX package's
`scripts/layout_probe.py` ported).

- `--bytes-only`: per-leaf bytes per group of the State (a one-group
  `state.init`, walked leaf by leaf) and of the kernel wire at rest,
  and the group ceiling each gives per card, from the byte model
  (`kernel.hbm_ceiling_groups`, `mesh_ceiling_groups`,
  `streamed_ceiling_groups`, `analysis/bytemodel.py`) against this
  card's budget (`kernel.hbm_budget`, `kernel.host_budget`). Without a
  card the budgets are the audit's (`bytemodel.AUDIT_HBM_BYTES`,
  `AUDIT_HOST_BYTES`), and the report says so. The port's State holds
  the three u32 leaves as int64 (`bytemodel.resident_bytes_model`'s
  `u32_widening_bytes`); nothing else differs from the JAX package's
  report.
- The default run adds the card's counterpart of the JAX package's
  G-major against G-minor timing (a question of XLA's (8, 128) tiles,
  which this card does not have): the kernel's layout in shared memory,
  bytes per group by leaf (`kernel.shared_words_per_group`; the
  double-buffered mailbox and ring rows twice), and, on a card, for
  each dial and run the groups per block and per SM from the launcher's
  occupancy query (`kernel.launch_plan`) and the waves 100,000 groups
  take over the card's SMs. It changes no kernel.
- `--ablate`: per layout dial, the wire's bytes per group, its
  residency, the modelled ceiling and the kernel's measured ticks/s on
  the card at `--ablate-groups` and `--ablate-ticks` (CUDA events); then
  the narrow dials' table (resident bytes per group per dial, from the
  byte model, with the kernel's measured ticks/s from the narrow
  State).
- `--staging-ablation`: the streamed pipeline's h2d copies from the
  pinned host wire against a pageable copy of it, over every visible
  card (`parallel/stream_sched.py` `staging_ablation`).

    python3 scripts/torch_layout_probe.py --bytes-only   # any machine
    python3 scripts/torch_layout_probe.py [--ablate | --staging-ablation]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raft_tpu_torch.analysis import bytemodel  # noqa: E402
from raft_tpu_torch.config import RaftConfig  # noqa: E402
from raft_tpu_torch.obs.recorder import FLIGHT_LEAVES, RING  # noqa: E402
from raft_tpu_torch.sim import kernel, state  # noqa: E402

OCCUPANCY_GROUPS = 100_000


def budgets() -> tuple:
    """(device bytes, host bytes, where they come from): this card's and
    host's budgets, or without a card the audit's."""
    if torch.cuda.is_available():
        return (kernel.hbm_budget(), kernel.host_budget(),
                f"{torch.cuda.get_device_name(0)}: kernel.hbm_budget(), "
                f"kernel.host_budget()")
    return (bytemodel.AUDIT_HBM_BYTES, bytemodel.AUDIT_HOST_BYTES,
            "no card: the audit's budgets (bytemodel.AUDIT_HBM_BYTES, "
            "AUDIT_HOST_BYTES)")


def state_leaf_rows(cfg: RaftConfig) -> list:
    """[(bytes per group, leaf name, dtype, per-group shape), ...] of a
    one-group State, largest first (the JAX package's order)."""
    rows = []

    def visit(name, a):
        rows.append((a.element_size() * a[0].numel(), name,
                     str(a.dtype).replace("torch.", ""),
                     list(a.shape[1:])))
        return a

    state._map_named(state.init(cfg, 1, device="cpu"), "", visit)
    return sorted(rows, reverse=True)


def bytes_per_group_report(cfg: RaftConfig | None = None) -> dict:
    """Print, and return, the per-leaf bytes per group of the State and
    the wire, and the ceilings they give per card."""
    cfg = cfg or RaftConfig(seed=42)
    hbm, host, where = budgets()
    rows = state_leaf_rows(cfg)
    total = sum(b for b, *_ in rows)
    flight = 4 * len(FLIGHT_LEAVES) * RING
    print(f"bytes/group, headline config (k={cfg.k}, L={cfg.log_cap}, "
          f"E={cfg.max_entries_per_msg}):")
    for b, name, dt, shp in rows:
        print(f"  {b:6d} B  {name:28s} {dt}{shp}")
    widening = bytemodel.resident_bytes_model(cfg)["u32_widening_bytes"]
    print(f"  state total: {total} B/group (+ flight recorder {flight} "
          f"B/group when recording; {widening} B of it the three u32 leaves "
          f"held as int64)")
    wire = 4 * kernel.wire_words_per_group(cfg, RING)
    wire_nf = 4 * kernel.wire_words_per_group(cfg)
    acc = 4 * kernel.acc_words(cfg)
    print(f"kernel wire form: {wire} B/group with the flight ring "
          f"({wire_nf} B without), of which flight {wire - wire_nf} B; the "
          f"histograms live in one fleet-wide acc of {acc} B, not per group")
    ceilings = {
        "resident_flight_on": kernel.hbm_ceiling_groups(cfg, RING, hbm),
        "resident_flight_off": kernel.hbm_ceiling_groups(cfg, 0, hbm),
        "state_only": hbm // total}
    for n in (4, 8):
        cards = [torch.device("cuda", i) for i in range(n)]
        ceilings[f"x{n}_gathered"] = kernel.mesh_ceiling_groups(
            cfg, cards, hbm=hbm)
        ceilings[f"x{n}_shards_out"] = kernel.mesh_ceiling_groups(
            cfg, cards, hbm=hbm, shards_out=True)
    scfg = dataclasses.replace(cfg, stream_groups=True)
    for ring, label in ((RING, "on"), (0, "off")):
        ceilings[f"streamed_flight_{label}"] = \
            kernel.streamed_ceiling_groups(scfg, ring, hbm, host)
    print(f"G ceiling per card of {hbm:,d} B device memory and {host:,d} B "
          f"host memory ({where}):")
    print(f"  kernel wire (flight on):  {ceilings['resident_flight_on']:>12,d}"
          f" groups\n  kernel wire (flight off): "
          f"{ceilings['resident_flight_off']:>12,d} groups\n  state only "
          f"(the plain loop's resident set): {ceilings['state_only']:>12,d} "
          f"groups")
    for n in (4, 8):
        print(f"  x{n} cards, resident: {ceilings[f'x{n}_gathered']:>12,d} "
              f"groups gathered on the first card, "
              f"{ceilings[f'x{n}_shards_out']:>12,d} returning shards")
    print(f"  streamed (one host, flight on / off): "
          f"{ceilings['streamed_flight_on']:,d} / "
          f"{ceilings['streamed_flight_off']:,d} groups")
    models = {}
    for label, c in (("clients-off", cfg),
                     ("clients-on", bytemodel.clients_cfg()),
                     ("packed, bools+ring", dataclasses.replace(
                         cfg, pack_bools=True, pack_ring=True))):
        m = bytemodel.derived_wire_model(c)
        models[label] = m["wire_bytes_derived"]
        verdict = ("derived == pinned" if not m["problems"]
                   else "; ".join(m["problems"]))
        print(f"derived wire model [{label}]: {m['wire_bytes_derived']} "
              f"B/group ({verdict})")
    return {"leaves": rows, "state_total": total, "flight": flight,
            "u32_widening_bytes": widening, "wire_flight_on": wire,
            "wire_flight_off": wire_nf, "ceilings": ceilings,
            "budgets": {"hbm": hbm, "host": host, "from": where},
            "wire_models": models}


def shared_leaf_bytes(cfg: RaftConfig) -> dict:
    """{leaf: shared bytes per group} of the kernel's layout: each wire
    field's rows (the double-buffered ones twice), and the padding and
    nemesis participation words as "padding"; sums to
    `4 * kernel.shared_words_per_group(cfg)`."""
    out = {f: 4 * kernel._rows(cfg, f) * (2 if f in kernel._DB else 1)
           for f in kernel._physical(cfg, 0)}
    out["padding"] = 4 * kernel.shared_words_per_group(cfg) - sum(
        out.values())
    return out


def occupancy_runs() -> list:
    """(label, cfg) of the occupancy table: each layout dial of the
    headline, then chip_smoke.py's runs by build."""
    import chip_smoke
    base = RaftConfig(seed=42)
    rows = [(f"headline {label}", dataclasses.replace(base, **knobs))
            for label, knobs, _ in ABLATION_ROWS]
    rows += [(label, cfg) for label, cfg, *_ in chip_smoke.all_runs()
             if label != "headline"]
    return rows


def occupancy_table() -> list:
    """Print, and return, shared bytes per group and, on a card, groups
    per block, per SM and the waves of 100,000 groups for each row of
    `occupancy_runs`."""
    on_card = torch.cuda.is_available()
    runs = occupancy_runs()
    if on_card:
        kernel.build(sorted({kernel.features(c) for _, c in runs}))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
    head = shared_leaf_bytes(runs[0][1])
    print(f"shared memory per group, headline ({sum(head.values())} B; "
          f"the mailbox and ring rows are double-buffered):")
    for name, b in sorted(head.items(), key=lambda kv: -kv[1]):
        print(f"  {b:6d} B  {name}")
    print(f"occupancy at {OCCUPANCY_GROUPS:,d} groups"
          + (f" ({torch.cuda.get_device_name(0)}, {sms} SMs; "
             f"kernel.launch_plan):" if on_card else
             " (no card: groups per block and per SM need the launcher's "
             "occupancy query, not measured):"))
    out = []
    for label, cfg in runs:
        row = {"run": label, "shared_bytes_per_group": kernel.shared_bytes(
            cfg)}
        if on_card:
            plan = kernel.launch_plan(cfg, OCCUPANCY_GROUPS)
            per_wave = plan["groups_per_sm"] * sms
            row.update(plan, waves=OCCUPANCY_GROUPS / per_wave)
            print(f"  {label:28s} {row['shared_bytes_per_group']:6d} B/group"
                  f"  {plan['groups_per_block']:3d}/block "
                  f"{plan['groups_per_sm']:3d}/SM  "
                  f"{row['waves']:6.2f} waves")
        else:
            print(f"  {label:28s} {row['shared_bytes_per_group']:6d} B/group")
        out.append(row)
    return out


# One row per layout-dial combination, cumulative: each row's change
# against the previous is that encoding's price. (label, dials, flight).
ABLATION_ROWS = (
    ("baseline", {}, True),
    ("+pack_bools", dict(pack_bools=True), True),
    ("+pack_ring", dict(pack_bools=True, pack_ring=True), True),
    ("+alias_wire", dict(pack_bools=True, pack_ring=True,
                         alias_wire=True), True),
    ("+wire_hist off", dict(pack_bools=True, pack_ring=True,
                            alias_wire=True, wire_hist=False), True),
    ("+flight off (all dials)", dict(pack_bools=True, pack_ring=True,
                                     alias_wire=True, wire_hist=False),
     False),
)
NARROW_ABLATION_ROWS = (
    ("wide", {}),
    ("+narrow_scalars", dict(narrow_scalars=True)),
    ("+narrow_ring", dict(narrow_scalars=True, narrow_ring=True)),
    ("+narrow_mailbox", dict(narrow_scalars=True, narrow_ring=True,
                             narrow_mailbox=True)),
    ("+narrow_clients", dict(narrow_scalars=True, narrow_ring=True,
                             narrow_mailbox=True, narrow_clients=True)),
    ("+donate_scan (all dials)", dict(narrow_scalars=True,
                                      narrow_ring=True,
                                      narrow_mailbox=True,
                                      narrow_clients=True,
                                      donate_scan=True)),
)


def measure_ticks_per_sec(cfg: RaftConfig, n_groups: int, ticks: int,
                          flight: bool) -> float:
    """The kernel's steady ticks/s on the card: two 200-tick launches of
    warm-up, then `ticks` in 200-tick launches timed by CUDA events."""
    from raft_tpu_torch.obs.recorder import flight_init
    chunk = 200
    fl = flight_init(n_groups, device="cuda") if flight else None
    leaves = kernel.kinit(cfg, state.init(cfg, n_groups, device="cuda"),
                          flight=fl)[0]
    leaves = kernel.krun(cfg, leaves, 0, 2 * chunk, chunk)
    n = max(1, ticks // chunk)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    kernel.krun(cfg, leaves, 2 * chunk, n * chunk, chunk)
    e1.record()
    torch.cuda.synchronize()
    return n * chunk / (e0.elapsed_time(e1) / 1e3)


def ablation_table(groups: int, ticks: int) -> dict:
    """The layout dials' table, then the narrow dials'."""
    hbm, _, where = budgets()
    on_card = torch.cuda.is_available()
    base = RaftConfig(seed=42)
    out = {"dials": [], "narrow": []}
    print(f"encoding ablation, headline (k={base.k}, L={base.log_cap}; "
          f"{hbm:,d} B, {where}; measured at {groups:,d} groups, "
          f"{ticks} ticks" + ("" if on_card else ": not measured, no card")
          + "):")
    print(f"  {'encoding':28s} {'B/group':>8s} {'x res':>5s} "
          f"{'ceiling groups':>14s} {'measured ticks/s':>16s}")
    prev = None
    for label, knobs, flight in ABLATION_ROWS:
        cfg = dataclasses.replace(base, **knobs)
        ring = RING if flight else 0
        wire = 4 * kernel.wire_words_per_group(cfg, ring)
        ceiling = kernel.hbm_ceiling_groups(cfg, ring, hbm)
        tps = measure_ticks_per_sec(cfg, groups, ticks, flight) \
            if on_card else None
        gain = f"  ({ceiling / prev:.2f}x)" if prev else ""
        print(f"  {label:28s} {wire:8,d} {kernel._residency(cfg):>5d} "
              f"{ceiling:>14,d} "
              f"{'-' if tps is None else f'{tps:,.1f}':>16s}{gain}")
        out["dials"].append({"row": label, "wire_bytes": wire,
                             "residency": kernel._residency(cfg),
                             "ceiling_groups": ceiling, "ticks_per_s": tps})
        prev = ceiling
    cbase = bytemodel.clients_cfg()
    print(f"narrow dials, resident bytes per group (clients universe, "
          f"flight off; the kernel's wire does not change):")
    print(f"  {'dials':28s} {'resident B/g':>12s} {'cut':>7s} "
          f"{'x res':>5s} {'measured ticks/s':>16s}")
    for label, knobs in NARROW_ABLATION_ROWS:
        cfg = dataclasses.replace(cbase, **knobs)
        model = bytemodel.resident_bytes_model(cfg)
        tps = measure_ticks_per_sec(cfg, groups, ticks, False) \
            if on_card else None
        print(f"  {label:28s} {model['resident_bytes_narrow']:12,d} "
              f"{-model['reduction_pct']:6.1f}% {kernel._residency(cfg):>5d} "
              f"{'-' if tps is None else f'{tps:,.1f}':>16s}")
        out["narrow"].append({"row": label,
                              "resident_bytes": model[
                                  "resident_bytes_narrow"],
                              "ticks_per_s": tps})
    return out


def staging_ablation() -> dict:
    from raft_tpu_torch.parallel import stream_sched
    from raft_tpu_torch.parallel.mesh import make_mesh
    cfg = dataclasses.replace(RaftConfig(seed=42), stream_groups=True,
                              cohort_blocks=1)
    rep = stream_sched.staging_ablation(cfg, make_mesh())
    print(f"staging ablation ({rep['n_devices']} card(s), "
          f"{rep['window_bytes'] / 2 ** 20:.1f} MiB a window x "
          f"{rep['windows']} windows, best of 3):")
    print(f"  staged (pinned): {rep['staged_wall_s'] * 1e3:8.2f} ms "
          f"({rep['staged_mib_s']:,.0f} MiB/s)")
    print(f"  naive (pageable): {rep['naive_wall_s'] * 1e3:8.2f} ms "
          f"({rep['naive_mib_s']:,.0f} MiB/s)")
    print(f"  staged over naive: {rep['staged_over_naive']:.3f}x")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bytes-only", action="store_true",
                    help="the bytes per group and ceilings report only")
    ap.add_argument("--ablate", action="store_true",
                    help="the layout and narrow dials' tables (measured "
                         "on a card)")
    ap.add_argument("--ablate-groups", type=int, default=100_000)
    ap.add_argument("--ablate-ticks", type=int, default=600)
    ap.add_argument("--staging-ablation", action="store_true",
                    help="pinned against pageable h2d copies (a card)")
    args = ap.parse_args(argv)
    if (args.ablate or args.staging_ablation) \
            and not torch.cuda.is_available():
        print("torch_layout_probe: CUDA is not available (--bytes-only and "
              "the default report run anywhere)", file=sys.stderr)
        return 2
    if args.staging_ablation:
        print(json.dumps({"staging_ablation": staging_ablation()}))
        return 0
    if args.ablate:
        print(json.dumps({"ablation": ablation_table(args.ablate_groups,
                                                     args.ablate_ticks)}))
        return 0
    report = bytes_per_group_report()
    if not args.bytes_only:
        report["occupancy"] = occupancy_table()
    report.pop("leaves")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
