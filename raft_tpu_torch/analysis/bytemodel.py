"""Derived byte model of the port: bytes per group computed from the real
dtypes and shapes of the port's State, Metrics and Flight, reconciled
against `sim/kernel.py`'s hand-kept model (the JAX package's
`analysis/bytemodel.py`, for the port's own wire).

Every figure is derived on the host at two groups (`_G0`): nothing runs
on a card and no tick executes. The wire is counted three ways, which
must agree exactly:

1. a walk over the leaves of `state.init(cfg, 2, device="cpu")`,
   `run.metrics_init` and `recorder.flight_init`, each leaf priced from
   its per-group shape by the port's layout rules: every State leaf and
   every per-group Metrics lane is one int32 row per element (bools 0/1,
   the u32 digests their bit pattern), each flight leaf `ring` rows; the
   `[H]` histograms and the fleet-wide counters ride `acc`, not the wire.
   The packed arithmetic of the resting layout (`pack_bools`,
   `pack_ring`) is derived here on its own, from the leaf dtypes and
   shapes, not through `kernel._layout`, so that a drifted encoding
   cannot agree with itself: `votes` as k bit lanes, `alive_prev` as
   one word, the bool mailbox slots as ceil(n_bool * k / 32) shared
   words per destination, the `log_term` ring as two 16-bit deltas a
   word plus one base lane;
2. the tensors `kernel.kinit` returns, element count over groups (and
   the working form `kernel.unpack_wire` makes of them);
3. `kernel.wire_words_per_group`, `working_words_per_group`,
   `acc_words` and `hbm_bytes`, and the ceilings built on them, on one
   card and sharded (`_mesh_ceilings`: over distinct cards, shards
   sharing one card, each with the whole fleet's gather and finish on
   the first card or returning shards, each card finishing its own,
   and the streamed pipeline per device).

The resident model (`resident_bytes_model`) prices what one group keeps
between runs under the narrow dials, four ways. The port carries the
three u32 leaves (`U32_LEAVES`) as int64, because torch has no usable
uint32 arithmetic (sim/state.py), so its State is 4 B per u32 element
larger than the JAX package's: `u32_widening_bytes` names that
difference (140 B per group at the headline, with or without the narrow
dials, which leave the digests alone). It changes no result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.config import NARROW_FIELDS, RaftConfig
from raft_tpu_torch.obs.recorder import FLIGHT_LEAVES, RING, flight_init
from raft_tpu_torch.sim import kernel
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.checkpoint import iter_named_leaves
from raft_tpu_torch.sim.run import metrics_init

# Groups of every derivation: >= 2 so a [G] lane is never a scalar, and
# unlike every per-node axis and the histogram length, so shapes tell
# leaf roles apart by value.
_G0 = 2

# The u32 leaves the port holds as int64 in [0, 2**32).
U32_LEAVES = ("nodes.snap_digest", "nodes.digest",
              "mailbox.is_req_snap_digest")

# Budgets the ceiling audits pass in (the card's 80 GB and a 64 GiB
# host); at run time the budgets are what is free (`kernel.hbm_budget`,
# `kernel.host_budget`), which the audit must not probe.
AUDIT_HBM_BYTES = 80 * 10 ** 9
AUDIT_HOST_BYTES = 64 * 2 ** 30

# The port's wire pins at the headline (B/group): the working wire and
# the wire at rest with pack_bools + pack_ring, flight off, and the
# working wire with a 64-tick flight ring.
WIRE_PINS = {"working": 4_716, "packed": 3_544, "ring64": 6_252}

# Resident bytes per group (flight off, the port's three or five lanes):
# {label: (wide, every narrow dial)}. The four accountings of
# `resident_bytes_model` must land on them exactly.
_RESIDENT_PINS = {"headline": (4_166, 2_626), "clients": (4_862, 2_970)}
_NARROW_REDUCTION_FLOOR_PCT = 35.0


def headline_cfg() -> RaftConfig:
    """The bench headline universe (k=5, L=32, E=4, clients off)."""
    return RaftConfig(seed=42)


def clients_cfg() -> RaftConfig:
    """The bench client universe: the headline with four retrying
    exactly-once sessions per group."""
    return dataclasses.replace(headline_cfg(), sessions=True,
                               cmds_per_tick=0, client_rate=0.2,
                               client_slots=4, client_retry_backoff=8)


def all_dials_cfg(cfg: RaftConfig) -> RaftConfig:
    """`cfg` with every narrow dial on (donate_scan included: it changes
    residency multiples, never the byte model)."""
    return dataclasses.replace(cfg, **{f: True for f in NARROW_FIELDS})


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _words(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _trees(cfg: RaftConfig, ring: int):
    """(State, Metrics, Flight or None) of `_G0` fresh groups on the CPU."""
    st = state_mod.init(cfg, _G0, device="cpu")
    met = metrics_init(_G0, clients=cfg.clients_u32 != 0, device="cpu")
    fl = flight_init(_G0, ring, device="cpu") if ring else None
    return st, met, fl


def derived_wire_model(cfg: RaftConfig, ring: int = 0) -> dict:
    """The wire's bytes per group, derived and reconciled (module
    docstring); `ring` is the flight ring's length (0: no flight). Keys:
    `leaves` (one row per wire contribution: name, kind, dtype, per-group
    shape, working words, words at rest), the derived and the kernel's
    words per group at rest and working, `acc_words_*`, `widening` (the
    bool leaves riding as full int32 rows), `hbm` (the launch's bytes and
    the ceilings at the audit budgets) and `problems` (empty iff every
    accounting agrees)."""
    problems: list[str] = []
    st, met, fl = _trees(cfg, ring)
    rows = []

    def add(name, kind, dtype, shape, work, rest):
        rows.append({"name": name, "kind": kind, "dtype": dtype,
                     "shape_per_group": list(shape), "working_words": work,
                     "rest_words": rest})

    n_mb_bools = 0
    for name, leaf in iter_named_leaves(st):
        shape = tuple(leaf.shape)
        if not shape or shape[0] != _G0:
            problems.append(f"state leaf {name}: shape {shape} does not lead "
                            f"with the group axis (G={_G0})")
            continue
        per_group = shape[1:]
        words = _words(per_group)
        if leaf.element_size() > 4 and name not in U32_LEAVES:
            problems.append(f"state leaf {name}: {_dtype_name(leaf.dtype)} "
                            f"is wider than the 32-bit wire row")
        rest = words
        if cfg.pack_bools and leaf.dtype == torch.bool:
            if name.startswith("mailbox."):
                n_mb_bools += 1   # the shared-lane row, added below
                rest = 0
            elif name == "nodes.votes":
                rest = per_group[0]   # one bit lane per node
            elif name == "alive_prev":
                rest = 1
            else:
                problems.append(f"state leaf {name}: a bool leaf with no "
                                f"packed-layout rule")
        if cfg.pack_ring and name == "nodes.log_term":
            if words % 2:
                problems.append(f"state leaf {name}: an odd ring cannot "
                                f"pack two 16-bit deltas a word")
            rest = words // 2
        add(name, "state", _dtype_name(leaf.dtype), per_group, words, rest)
    if cfg.pack_bools:
        mb = -(-n_mb_bools * cfg.k // 32) * cfg.k
        add(kernel.MB_BOOLS_PACKED, "state-packed", "int32", [cfg.k], 0, mb)
    if cfg.pack_ring:
        add(kernel.RING_BASE, "state-packed", "int32", [], 0, 1)

    acc = 0
    for name, leaf in iter_named_leaves(met):
        shape = tuple(leaf.shape)
        if shape == (_G0,):
            add(f"metrics.{name}", "metric-lane", _dtype_name(leaf.dtype),
                [], 1, 1)
        elif shape == ():
            acc += 1
        elif len(shape) == 1:   # an [H] histogram row
            acc += shape[0] if cfg.wire_hist else 0
        else:
            problems.append(f"metric leaf {name}: unclassifiable shape "
                            f"{shape}")
    if fl is not None:
        for name, leaf in iter_named_leaves(fl):
            if tuple(leaf.shape) != (ring, _G0):
                problems.append(f"flight leaf {name}: shape "
                                f"{tuple(leaf.shape)} != ({ring}, G)")
                continue
            add(f"flight.{name}", "flight-ring", _dtype_name(leaf.dtype),
                [], ring, ring)

    work = sum(r["working_words"] for r in rows)
    rest = sum(r["rest_words"] for r in rows)

    # Cross-check 2: the real kinit output, element-counted.
    (wire, acc_t), g = kernel.kinit(cfg, st, met, fl)
    if g != _G0 or wire.numel() % _G0:
        problems.append(f"kinit returned {g} groups and {wire.numel()} wire "
                        f"words for {_G0} groups")
    kinit_rest = wire.numel() // _G0
    kinit_work = kernel.unpack_wire(cfg, wire).numel() // _G0

    # Cross-check 3: the kernel's own model.
    pinned = {"rest": kernel.wire_words_per_group(cfg, ring),
              "working": kernel.working_words_per_group(cfg, ring),
              "acc": kernel.acc_words(cfg)}
    for label, derived, real in (("at rest", rest, kinit_rest),
                                 ("working", work, kinit_work)):
        key = "rest" if label == "at rest" else "working"
        if not derived == real == pinned[key]:
            problems.append(
                f"wire words per group {label}: derived {derived}, kinit "
                f"{real}, kernel model {pinned[key]} (ring={ring})")
    if not acc == acc_t.numel() == pinned["acc"]:
        problems.append(f"acc words: derived {acc}, kinit {acc_t.numel()}, "
                        f"kernel.acc_words {pinned['acc']}")

    # The launch's device bytes: the wire at rest once under alias_wire
    # (else in and out), the working wire beside it when a dial packs.
    residency = 1 if cfg.alias_wire else 2
    launch = (residency * rest + work if cfg.pack_bools or cfg.pack_ring
              else residency * work)
    n = 100_000
    want = 4 * (launch * n + residency * acc)
    if kernel.hbm_bytes(cfg, n, ring) != want:
        problems.append(f"kernel.hbm_bytes at {n} groups "
                        f"{kernel.hbm_bytes(cfg, n, ring)} != {want} from "
                        f"the derived words")
    hbm = _ceilings(cfg, ring, launch, residency * acc, rest, problems,
                    dict(residency=residency, acc=acc, work=work))

    widened = [r for r in rows if r["kind"] == "state"
               and r["dtype"] == "bool" and r["rest_words"] == r[
                   "working_words"]]
    return {
        "config": {"k": cfg.k, "log_cap": cfg.log_cap,
                   "clients": cfg.clients_u32 != 0, "ring": ring,
                   "pack_bools": cfg.pack_bools, "pack_ring": cfg.pack_ring},
        "leaves": rows,
        "wire_words_derived": rest,
        "working_words_derived": work,
        "kinit_words_per_group": kinit_rest,
        "kinit_working_words_per_group": kinit_work,
        "wire_words_pinned": pinned["rest"],
        "working_words_pinned": pinned["working"],
        "wire_bytes_derived": 4 * rest,
        "working_bytes_derived": 4 * work,
        "acc_words_derived": acc,
        "widening": {"leaves": [r["name"] for r in widened],
                     "waste_bytes_per_group":
                         sum(3 * r["rest_words"] for r in widened)},
        "hbm": hbm,
        "problems": problems,
    }


def _ceilings(cfg, ring, launch_words, acc_bytes_words, rest, problems,
              words):
    """The resident and streamed ceilings at the audit budgets, each the
    exact `supported` boundary and each the one the derived words imply."""
    rcfg = dataclasses.replace(cfg, stream_groups=False)
    B, H = AUDIT_HBM_BYTES, AUDIT_HOST_BYTES
    ceiling = kernel.hbm_ceiling_groups(rcfg, ring, hbm=B)
    want = (B - 4 * acc_bytes_words) // (4 * launch_words)
    exact = (kernel.supported(rcfg, ceiling, ring, hbm=B)
             and not kernel.supported(rcfg, ceiling + 1, ring, hbm=B))
    if ceiling != want or not exact:
        problems.append(f"resident ceiling {ceiling} (exact boundary: "
                        f"{exact}) != {want} from the derived words "
                        f"(ring={ring})")
    scfg = dataclasses.replace(cfg, stream_groups=True)
    streamed = kernel.streamed_ceiling_groups(scfg, ring, hbm=B, host=H)
    per_group = 4 * rest + 2 * resident_bytes_model(cfg, ring)[
        "resident_bytes_narrow"]
    want_s = H // (per_group * kernel.GB) * kernel.GB
    exact_s = (kernel.supported(scfg, streamed, ring, hbm=B, host=H)
               and not kernel.supported(scfg, streamed + kernel.GB, ring,
                                        hbm=B, host=H))
    if streamed != want_s or not exact_s:
        problems.append(f"streamed ceiling {streamed} (exact boundary: "
                        f"{exact_s}) != {want_s} from the derived bytes "
                        f"({per_group} B/group on the host, ring={ring})")
    return {"audit_hbm_bytes": B, "audit_host_bytes": H,
            "launch_words_per_group": launch_words,
            "ceiling_groups": ceiling, "streamed_ceiling_groups": streamed,
            "window_hbm_bytes": kernel.cohort_hbm_bytes(scfg, ring),
            "mesh": _mesh_ceilings(cfg, ring, dict(
                words, launch=launch_words, rest=rest), ceiling, streamed,
                problems)}


# The meshes the audit prices: distinct cards, and shards sharing one.
AUDIT_MESH_SIZES = (2, 4)


def _first_card_bytes(g: int, n: int, shared: bool, w: dict,
                      shards_out: bool = False) -> int:
    """Derived bytes on the first card of a resident run of `g` groups
    sharded over `n` devices (all on that card when `shared`): the
    launches it holds, and the run's end, whichever is largest: the
    gather there and the whole fleet's finish, or with `shards_out` the
    finish of the shards it holds beside the fleet's Metrics (its lanes
    twice, the accumulators stacked and reduced). The first shard,
    ceil(g / n) groups, is the largest, so no other card needs more."""
    step = -(-g // n)
    spans = [min(step, g - s0) for s0 in range(0, g, step)]
    launch = [4 * (w["launch"] * s + w["residency"] * w["acc"])
              for s in spans]
    here = launch if shared else launch[:1]
    if shards_out:
        fin = [w["finish"] * s + w["fleet"] for s in spans]
        return max(sum(here), sum(fin if shared else fin[:1])
                   + 2 * w["lanes"] * g + 4 * (len(spans) + 1) * w["acc"])
    pair = [4 * (w["rest"] * s + w["acc"]) for s in spans]
    gather = 0
    if len(spans) > 1:
        gather = 4 * (w["rest"] * g + w["acc"]) + (
            sum(pair) if shared else pair[0] + 4 * w["rest"] * max(spans[1:]))
    return max(sum(here), gather, w["finish"] * g + w["fleet"])


def _derived_boundary(n: int, shared: bool, w: dict, budget: int,
                      top: int, shards_out: bool = False) -> int:
    """The most groups in [0, top] whose `_first_card_bytes` fit
    `budget`."""
    lo, hi = 0, top
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _first_card_bytes(mid, n, shared, w, shards_out) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _mesh_ceilings(cfg, ring, w, ceiling, streamed, problems):
    """The sharded forms at the audit budgets, each against the derived
    words: a resident run over N distinct cards, and over N shards
    sharing one card, fits while the first card holds its launches and
    the whole fleet's gather and finish, or, returning shards, the
    finish of its own shards and the fleet's Metrics
    (`_first_card_bytes`, the finish from `resident_bytes_model`'s wide
    bytes, the lanes from the Metrics' `[G]` leaves); the exact
    `supported(mesh=...)` boundary (`kernel.mesh_ceiling_groups`) must be
    that, and at most N x one card's launch ceiling. The streamed window
    pipeline holds `stream_blocks_per_device` blocks a card, and the
    streamed ceiling stays the one host's."""
    rcfg = dataclasses.replace(cfg, stream_groups=False)
    scfg = dataclasses.replace(cfg, stream_groups=True)
    B, H = AUDIT_HBM_BYTES, AUDIT_HOST_BYTES
    res = resident_bytes_model(cfg, ring)
    w = dict(w, finish=4 * w["rest"] + (
        4 * w["work"] if cfg.pack_bools or cfg.pack_ring else 0)
        + res["resident_bytes_wide"] + (
            res["state_bytes_narrow"] if state_mod.narrow_active(cfg)
            else 0),
        fleet=4 * (w["acc"] + kernel.acc_words(
            dataclasses.replace(cfg, wire_hist=True))),
        lanes=_lane_bytes(_trees(cfg, ring)[1]))
    if kernel.finish_bytes(rcfg, 1000, ring) != w["finish"] * 1000 + w[
            "fleet"]:
        problems.append(f"kernel.finish_bytes at 1000 groups "
                        f"{kernel.finish_bytes(rcfg, 1000, ring)} != "
                        f"{w['finish'] * 1000 + w['fleet']} from the "
                        f"derived words (ring={ring})")
    out = {}
    for n in AUDIT_MESH_SIZES:
        cards = [torch.device("cuda", i) for i in range(n)]
        row = {}
        for label, mesh, shared, so in (
                ("ceiling_groups", cards, False, False),
                ("shared_card_groups", [cards[0]] * n, True, False),
                ("shards_out_ceiling_groups", cards, False, True),
                ("shards_out_shared_card_groups", [cards[0]] * n, True,
                 True)):
            top = kernel.mesh_ceiling_groups(rcfg, mesh, ring, hbm=B,
                                             shards_out=so)
            want = _derived_boundary(n, shared, w, B, n * ceiling, so)
            exact = (kernel.supported(rcfg, top, ring, hbm=B, mesh=mesh,
                                      shards_out=so)
                     and not kernel.supported(rcfg, top + 1, ring, hbm=B,
                                              mesh=mesh, shards_out=so))
            if top != want or not exact or top > n * ceiling:
                problems.append(
                    f"resident ceiling over {n} "
                    + ("shards on one card" if shared else "cards")
                    + (", shards out," if so else "")
                    + f" {top} (exact boundary: {exact}) != {want} from "
                    f"the derived words, or above {n} x {ceiling}")
            row[label] = top
        window = kernel.cohort_hbm_bytes(scfg, ring, n)
        per = -(-cfg.cohort_blocks // n) * kernel.GB
        # the previous and next slices at rest beside the current launch
        want_w = 4 * (2 * w["rest"] * per + w["launch"] * per
                      + w["residency"] * w["acc"])
        if window != want_w:
            problems.append(f"streamed window over {n} devices {window} B "
                            f"!= {want_w} B, one device's pipeline of its "
                            f"{per}-group slices from the derived words")
        s_top = kernel.streamed_ceiling_groups(scfg, ring, hbm=B, host=H,
                                               n_devices=n)
        if s_top != streamed:
            problems.append(f"streamed ceiling over {n} devices {s_top} != "
                            f"the one host's {streamed}")
        out[n] = dict(row, window_hbm_bytes=window,
                      streamed_ceiling_groups=s_top)
    return out


def _lane_bytes(met) -> int:
    """4 B for each per-group Metrics lane ([G]-shaped leaf)."""
    return 4 * sum(1 for _, a in iter_named_leaves(met)
                   if tuple(a.shape) == (_G0,))


def resident_bytes_model(cfg: RaftConfig, ring: int = 0) -> dict:
    """What one group keeps between runs under `cfg`'s narrow dials,
    derived four ways and reconciled exactly:

    1. the real `state.init` under the dials (what the engine keeps);
    2. the wide leaves priced at `state.narrow_spec`'s dtypes;
    3. the wide total less the per-leaf narrowing deltas;
    4. `kernel.state_bytes_per_group`, the model `prun_streamed` budgets
       its host copies with.

    The per-group metric lanes and the flight rows are priced wide on
    both sides. Lane convention: the port's, one 4-byte lane per
    `[G]`-shaped Metrics leaf (committed, leaderless, safety; with
    clients also client_acked, client_retries). The JAX package counts
    five (eight with clients): its kernel also accumulates elections and
    max_latency (and client_max_lat) per group, which the port keeps in
    the group-independent `acc`. `state_bytes_*` leave the lanes out, so
    they compare across the packages: the port's equals the JAX
    package's plus `u32_widening_bytes`."""
    problems: list[str] = []
    wide_cfg = dataclasses.replace(cfg, **{f: False for f in NARROW_FIELDS})
    st_n, met, _ = _trees(cfg, 0)
    st_w, _, _ = _trees(wide_cfg, 0)
    spec = state_mod.narrow_spec(cfg)
    rows, seen = [], set()
    wide = narrow_real = narrow_spec = delta = u32 = 0
    for (name, lw), (name_n, ln) in zip(iter_named_leaves(st_w),
                                        iter_named_leaves(st_n)):
        if name != name_n:
            problems.append(f"narrow/wide leaf walks diverged: {name_n!r} "
                            f"vs {name!r}")
            continue
        seen.add(name)
        per_group = tuple(lw.shape)[1:]
        words = _words(per_group)
        dt = spec.get(name, lw.dtype)
        if ln.dtype != dt:
            problems.append(f"state leaf {name}: narrow init dtype "
                            f"{_dtype_name(ln.dtype)} != "
                            f"{_dtype_name(dt)} promised by narrow_spec")
        it_w, it_s = lw.element_size(), dt.itemsize
        wide += it_w * words
        narrow_real += ln.element_size() * words
        narrow_spec += it_s * words
        delta += (it_w - it_s) * words
        widening = 4 * words if name in U32_LEAVES else 0
        u32 += widening
        if name in U32_LEAVES and lw.dtype != torch.int64:
            problems.append(f"state leaf {name}: u32 held as "
                            f"{_dtype_name(lw.dtype)}, not int64")
        rows.append({"name": name, "dtype_wide": _dtype_name(lw.dtype),
                     "dtype_narrow": _dtype_name(ln.dtype),
                     "shape_per_group": list(per_group),
                     "bytes_wide": it_w * words,
                     "bytes_narrow": it_s * words,
                     "narrowed": name in spec,
                     "u32_widening_bytes": widening})
    for name in spec:
        if name not in seen:
            problems.append(f"narrow_spec names {name!r}, which no leaf of "
                            f"this config has")
    lanes = _lane_bytes(met)
    flight = 4 * len(FLIGHT_LEAVES) * ring
    tail = lanes + flight
    totals = {"real": narrow_real + tail, "spec": narrow_spec + tail,
              "delta": wide + tail - delta,
              "kernel": kernel.state_bytes_per_group(cfg, ring)}
    if len(set(totals.values())) != 1:
        problems.append(f"resident accountings disagree: real-init "
                        f"{totals['real']}, spec-priced {totals['spec']}, "
                        f"wide-minus-deltas {totals['delta']}, "
                        f"kernel.state_bytes_per_group {totals['kernel']} "
                        f"B/group (ring={ring})")
    wide_total = wide + tail
    return {
        "leaves": rows,
        "state_bytes_wide": wide,
        "state_bytes_narrow": narrow_real,
        "resident_bytes_wide": wide_total,
        "resident_bytes_narrow": totals["real"],
        "resident_bytes_narrow_spec": totals["spec"],
        "resident_bytes_narrow_delta": totals["delta"],
        "kernel_state_bytes_per_group": totals["kernel"],
        "metric_lane_bytes": lanes,
        "flight_bytes": flight,
        "u32_widening_bytes": u32,
        "reduction_pct": round(100.0 * (wide_total - totals["real"])
                               / wide_total, 2),
        "problems": problems,
    }


def narrow_resident_bytes_per_group(cfg: RaftConfig) -> int:
    """The manifest figure (`obs.manifest.NARROW_KEYS`): resident bytes
    per group under `cfg`'s narrow dials, flight off."""
    return int(resident_bytes_model(cfg)["resident_bytes_narrow"])


def narrow_model_problems() -> list[str]:
    """Reconcile the resident accountings on the audited labels, hold
    the pins and the reduction floor, and show the wire does not move
    under the narrow dials (the kernel computes at int32 whatever the
    resident dtypes)."""
    out: list[str] = []
    for label, base in (("headline", headline_cfg()),
                        ("clients", clients_cfg())):
        ncfg = all_dials_cfg(base)
        model = resident_bytes_model(ncfg)
        out += [f"narrow model [{label}]: {p}" for p in model["problems"]]
        pins = (model["resident_bytes_wide"], model["resident_bytes_narrow"])
        if pins != _RESIDENT_PINS[label]:
            out.append(f"narrow model [{label}]: resident (wide, narrow) "
                       f"{pins} B/group != pinned {_RESIDENT_PINS[label]}")
        if model["reduction_pct"] < _NARROW_REDUCTION_FLOOR_PCT:
            out.append(f"narrow model [{label}]: reduction "
                       f"{model['reduction_pct']}% under the "
                       f"{_NARROW_REDUCTION_FLOOR_PCT}% floor")
        for ring in (RING, 0):
            wn = derived_wire_model(ncfg, ring)
            ww = derived_wire_model(base, ring)
            for key in ("wire_words_derived", "working_words_derived",
                        "kinit_words_per_group", "wire_words_pinned"):
                if wn[key] != ww[key]:
                    out.append(f"narrow model [{label}, ring={ring}]: {key} "
                               f"moved under the narrow dials ({ww[key]} -> "
                               f"{wn[key]})")
            if wn["hbm"]["ceiling_groups"] != ww["hbm"]["ceiling_groups"]:
                out.append(f"narrow model [{label}, ring={ring}]: the "
                           f"resident ceiling moved under the narrow dials")
        wmodel = resident_bytes_model(base)
        if wmodel["resident_bytes_narrow"] != wmodel["resident_bytes_wide"]:
            out.append(f"narrow model [{label}]: the dials-off config "
                       f"reports a reduction")
    dmodel = resident_bytes_model(dataclasses.replace(headline_cfg(),
                                                      donate_scan=True))
    if dmodel["resident_bytes_narrow"] != dmodel["resident_bytes_wide"]:
        out.append("narrow model: a lone donate_scan dial changed the "
                   "resident bytes")
    return out


def audit_cfgs() -> list:
    """(label, cfg) of every audited layout: the headline and client
    universes, packed, with every wire dial (the ceiling layout), and
    with every narrow dial."""
    packed = dict(pack_bools=True, pack_ring=True)
    return [
        ("headline", headline_cfg()),
        ("clients", clients_cfg()),
        ("headline-packed", dataclasses.replace(headline_cfg(), **packed)),
        ("clients-packed", dataclasses.replace(clients_cfg(), **packed)),
        ("headline-ceiling", dataclasses.replace(
            headline_cfg(), alias_wire=True, wire_hist=False, **packed)),
        ("headline-narrow", all_dials_cfg(headline_cfg())),
        ("clients-narrow", all_dials_cfg(clients_cfg())),
    ]


def wire_pin_problems() -> list[str]:
    """The headline's wire against `WIRE_PINS`."""
    head = headline_cfg()
    got = {"working": derived_wire_model(head)["working_bytes_derived"],
           "packed": derived_wire_model(dataclasses.replace(
               head, pack_bools=True, pack_ring=True))["wire_bytes_derived"],
           "ring64": derived_wire_model(head, 64)["working_bytes_derived"]}
    return [f"wire pin {k}: derived {got[k]} B/group != pinned {v}"
            for k, v in WIRE_PINS.items() if got[k] != v]


def byte_model_problems() -> list[str]:
    """The audit: every audited layout with the flight ring on and off,
    the wire pins, and the resident model."""
    out = []
    for label, cfg in audit_cfgs():
        for ring in (RING, 0):
            out += [f"byte model [{label}, ring={ring}]: {p}"
                    for p in derived_wire_model(cfg, ring)["problems"]]
    return out + wire_pin_problems() + narrow_model_problems()
