"""Leaf-contract auditor of the port: proves that the State, Metrics,
Flight and ClientState definitions, the kernel's wire registries (and
`fused_chunk.cu`'s field enum), the shard rule, the checkpoint format,
the manifest schema and the hash surface agree, before anything runs
(the JAX package's `analysis/contracts.py`, over the port's own
registries).

The cross-engine contracts are registries: tuples of field names whose
order is the wire order (`kernel.WIRE_FIELDS`, `kernel._LANES`), plus a
few derived rules (the `[W, G]` group axis and the contiguous spans of
the shard rule, `checkpoint._optional_fields`, the gating table below).
Every pass compares one registry with the ground truth it mirrors,
taken from the NamedTuple definitions and from `state.init`,
`run.metrics_init`, `recorder.flight_init` and `clients_init` at a few
groups on the CPU (one tick of the plain step where a pass says so),
and returns problem strings naming the leaf and the registry that
drifted. Each pass takes its inputs as parameters with the real ones as
defaults, so the tests can hand in a drifted copy and see it named.

`kernel_plan_problems` is the one pass that needs a card: the block
shape the C launcher picks (`kernel.launch_plan`) against the Python
model of shared memory.
"""

from __future__ import annotations

import dataclasses
import io
import json
import re

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig

# The statically gated leaf table, row for row the JAX package's: gate
# name -> (mailbox fields, PerNode fields, State fields) that exist iff
# the gate is on — in the plain tick's State (None otherwise), on the
# kernel's wire, and (sessions) in the CPU oracle. State entries with a
# dot are literal leaf paths; "admission" stacks on "clients". The
# nemesis compiler and cohort streaming gate nothing: their empty rows
# are the contract.
GATED_LEAVES = {
    "prevote": (("pv_req_present", "pv_req_term", "pv_req_lli",
                 "pv_req_llt", "pv_resp_present", "pv_resp_term",
                 "pv_resp_req_term", "pv_resp_granted"), (), ()),
    "transfer": (("tn_present", "tn_term"), (), ()),
    "clients": (("is_req_snap_sessions",),
                ("session_seq", "snap_session_seq"),
                ("clients",)),
    "admission": ((), (), ("clients.shed",)),
    "nemesis": ((), (), ()),
    "streaming": ((), (), ()),
}

_G = 2   # groups of every derivation


def _nemesis_probe_program() -> tuple:
    """A program with one clause of every kind."""
    from raft_tpu_torch.nemesis.program import (clock_skew,
                                                compaction_pressure,
                                                crash_storm,
                                                disk_full_follower,
                                                flaky_link, partition_wave,
                                                program, slow_follower,
                                                wan_delay)
    return program(slow_follower(0, 64), flaky_link(0, 64),
                   wan_delay(0, 64), clock_skew(0, 64),
                   crash_storm(0, 64), partition_wave(0, 64),
                   disk_full_follower(0, 64), compaction_pressure(0, 64))


def _base_cfg() -> RaftConfig:
    return RaftConfig(n_groups=2, k=3, seed=3, log_cap=8, compact_every=4)


def _gate_cfgs() -> dict:
    """gate name -> the config that turns exactly that gate on."""
    base = _base_cfg()
    clients = dict(sessions=True, cmds_per_tick=0, client_rate=0.3,
                   client_slots=2)
    return {
        "prevote": dataclasses.replace(base, prevote=True),
        "transfer": dataclasses.replace(base, transfer_prob=0.5),
        "clients": dataclasses.replace(base, **clients),
        "admission": dataclasses.replace(base, client_queue_cap=4,
                                         **clients),
        "nemesis": dataclasses.replace(base,
                                       nemesis=_nemesis_probe_program()),
        "streaming": dataclasses.replace(base, stream_groups=True,
                                         cohort_blocks=1),
    }


def _all_on() -> RaftConfig:
    return dataclasses.replace(_gate_cfgs()["clients"], prevote=True,
                               transfer_prob=0.5, read_every=4)


def _init(cfg: RaftConfig, g: int = _G):
    from raft_tpu_torch.sim import state
    return state.init(cfg, g, device="cpu")


def _named(tree) -> dict:
    from raft_tpu_torch.sim.checkpoint import iter_named_leaves
    return dict(iter_named_leaves(tree))


def _leaf_names(cfg: RaftConfig) -> set:
    """Dot paths of the State leaves a universe carries."""
    return set(_named(_init(cfg)))


def _wire_name(path: str) -> str:
    """A State leaf's name on the kernel's wire."""
    head, _, rest = path.partition(".")
    return rest if head in ("nodes", "mailbox") else path


def _wire_pair(cfg: RaftConfig, g: int = _G, ring: int = 0):
    from raft_tpu_torch.obs.recorder import flight_init
    from raft_tpu_torch.sim import kernel
    fl = flight_init(g, ring, device="cpu") if ring else None
    return kernel.kinit(cfg, _init(cfg, g), flight=fl)[0]


# --------------------------------------------------- metric-surface parity


def metric_parity_problems() -> list[str]:
    """Metrics against the wire's per-group lanes and `acc`'s rows,
    Flight against FLIGHT_LEAVES, ClientState against its leaf
    registries, and every metric, client and flight leaf int32 at the
    shapes `kinit` folds."""
    from raft_tpu_torch.clients.state import (ADMISSION_LEAVES,
                                              CLIENT_LEAVES, ClientState,
                                              active_client_leaves,
                                              clients_init)
    from raft_tpu_torch.obs.recorder import (FLIGHT_LEAVES, RING, Flight,
                                             flight_init)
    from raft_tpu_torch.sim import kernel
    from raft_tpu_torch.sim.run import HIST_SIZE, Metrics, metrics_init

    problems = []
    if Flight._fields != FLIGHT_LEAVES:
        problems.append(f"Flight fields {Flight._fields} != wire order "
                        f"FLIGHT_LEAVES {FLIGHT_LEAVES}")
    if ClientState._fields != CLIENT_LEAVES + ADMISSION_LEAVES:
        problems.append(f"ClientState fields {ClientState._fields} != wire "
                        f"order CLIENT_LEAVES {CLIENT_LEAVES} + admission "
                        f"leaves {ADMISSION_LEAVES}")
    lanes = tuple(f for f in kernel._LANES if f != "group_id")
    acc_rows = ("hist", "elections", "max_latency", "client_hist",
                "client_max_lat")
    if set(Metrics._fields) != set(lanes) | set(acc_rows):
        problems.append(
            f"Metrics fields {sorted(Metrics._fields)} != the wire's metric "
            f"lanes {sorted(lanes)} + acc's rows {sorted(acc_rows)}")
    g = 4
    want_shape = {"committed": (g,), "leaderless": (g,), "elections": (),
                  "hist": (HIST_SIZE,), "max_latency": (), "safety": (g,),
                  "client_acked": (g,), "client_retries": (g,),
                  "client_hist": (HIST_SIZE,), "client_max_lat": ()}
    client_leaves = ("client_acked", "client_retries", "client_hist",
                     "client_max_lat")
    for clients in (False, True):
        m = metrics_init(g, clients=clients, device="cpu")
        for name in Metrics._fields:
            leaf = getattr(m, name)
            if leaf is None:
                if clients or name not in client_leaves:
                    problems.append(f"Metrics.{name} unexpectedly None "
                                    f"(clients={clients})")
                continue
            if not clients and name in client_leaves:
                problems.append(f"Metrics.{name} present with clients off")
            if leaf.dtype != torch.int32:
                problems.append(f"Metrics.{name} dtype {leaf.dtype} != "
                                f"int32 (the wire's lanes are int32)")
            if tuple(leaf.shape) != want_shape.get(name):
                problems.append(f"Metrics.{name} shape {tuple(leaf.shape)}"
                                f" != {want_shape.get(name)}")
        cfg = _gate_cfgs()["clients"] if clients else _base_cfg()
        h = HIST_SIZE
        want = h + 2 + (h + 1 if clients else 0)
        if kernel.acc_words(cfg) != want:
            problems.append(f"kernel.acc_words {kernel.acc_words(cfg)} != "
                            f"the acc rows of Metrics {want} "
                            f"(clients={clients})")
    for label, c in (("cap-off", _gate_cfgs()["clients"]),
                     ("cap-on", _gate_cfgs()["admission"])):
        cs = clients_init(c, g, device="cpu")
        active = active_client_leaves(c)
        for name in ClientState._fields:
            leaf = getattr(cs, name)
            if name not in active:
                if leaf is not None:
                    problems.append(f"[{label}] ClientState.{name} present "
                                    f"with its admission gate off")
                continue
            if leaf is None:
                problems.append(f"[{label}] ClientState.{name} is None but "
                                f"active_client_leaves lists it")
                continue
            if leaf.dtype != torch.int32 \
                    or tuple(leaf.shape) != (g, c.client_slots):
                problems.append(
                    f"[{label}] ClientState.{name} {leaf.dtype} "
                    f"{tuple(leaf.shape)} != int32 {(g, c.client_slots)}")
    f = flight_init(g, device="cpu")
    for name in Flight._fields:
        leaf = getattr(f, name)
        if leaf.dtype != torch.int32 or tuple(leaf.shape) != (RING, g):
            problems.append(f"Flight.{name} {leaf.dtype} "
                            f"{tuple(leaf.shape)} != int32 {(RING, g)}")
    return problems


# ----------------------------------------------------- wire registries


def cuda_field_enum(source: str | None = None) -> list[str]:
    """The wire fields of `fused_chunk.cu`'s `Field` enum, in order, as
    `kernel.WIRE_FIELDS` names them: the mailbox fields expand from the
    `Mb` enum at `F_MB0`."""
    from raft_tpu_torch.sim import kernel
    src = kernel.SOURCE.read_text() if source is None else source

    def enum(name):
        m = re.search(r"enum\s+" + name + r"\s*\{(.*?)\};", src, re.S)
        if m is None:
            return []
        body = re.sub(r"//[^\n]*", "", m.group(1))
        return [e.split("=")[0].strip() for e in body.split(",")
                if e.strip()]

    mb = [e.lower() for e in enum("Mb") if e != "N_MB"]
    out = []
    for e in enum("Field"):
        if e == "N_FIELDS":
            continue
        if e == "F_MB0":
            out += mb
            continue
        name = e[2:].lower()
        for head in ("clients", "flight"):
            if name.startswith(head + "_"):
                name = f"{head}.{name[len(head) + 1:]}"
        out.append(name)
    return out


def wire_registry_problems(pernode_fields: tuple | None = None,
                           mailbox_fields: tuple | None = None,
                           client_fields: tuple | None = None,
                           cuda_source: str | None = None) -> list[str]:
    """`kernel.WIRE_FIELDS` and `_LANES` against PerNode, Mailbox,
    ClientState, Flight, State and the metric lanes, and against
    `fused_chunk.cu`'s field enum; per universe, `kernel.wire_fields`
    and `kernel._shape` against the leaves `state.init` makes. Pass a
    drifted field tuple (e.g. PerNode._fields + ('ghost',)) or CUDA
    source to see the auditor name it."""
    from raft_tpu_torch.clients.state import ClientState
    from raft_tpu_torch.obs.recorder import (FLIGHT_LEAVES, PRESENCE_FIELDS,
                                             RING)
    from raft_tpu_torch.sim import kernel
    from raft_tpu_torch.sim.state import Mailbox, PerNode, PRESENT_FIELDS

    pn = PerNode._fields if pernode_fields is None else tuple(pernode_fields)
    mb = Mailbox._fields if mailbox_fields is None else tuple(mailbox_fields)
    cl = (ClientState._fields if client_fields is None
          else tuple(client_fields))
    wf = kernel.WIRE_FIELDS
    lanes = tuple(f for f in kernel._LANES if f != "group_id")
    problems = []
    truth = (list(pn) + ["alive_prev", "group_id"] + list(mb)
             + [f"clients.{f}" for f in cl] + list(lanes)
             + [f"flight.{f}" for f in FLIGHT_LEAVES])
    for what, names in (("PerNode", pn), ("Mailbox", mb),
                        ("ClientState", [f"clients.{f}" for f in cl]),
                        ("Flight", [f"flight.{f}" for f in FLIGHT_LEAVES]),
                        ("State", ("alive_prev", "group_id")),
                        ("the metric lanes", lanes)):
        missing = [f for f in names if f not in wf]
        if missing:
            problems.append(f"{what} leaf {missing} is on no kernel wire "
                            f"registry (kernel.WIRE_FIELDS)")
    stale = [f for f in wf if f not in truth]
    if stale:
        problems.append(f"kernel.WIRE_FIELDS carries stale {stale}: no "
                        f"State, Metrics or Flight leaf of that name")
    rings = ("log_term", "log_payload")
    order = [f for f in pn if f in wf and f not in rings]
    if [f for f in wf if f in order] != order:
        problems.append("kernel.WIRE_FIELDS orders the node leaves unlike "
                        "PerNode._fields (order drift)")
    if [f for f in wf if f in mb] != [f for f in mb if f in wf]:
        problems.append("kernel.WIRE_FIELDS orders the mailbox unlike "
                        "Mailbox._fields (order drift)")
    enum = cuda_field_enum(cuda_source)
    if enum != list(wf):
        at = next((i for i, (a, b) in enumerate(zip(enum, wf)) if a != b),
                  min(len(enum), len(wf)))
        problems.append(
            f"fused_chunk.cu's Field enum drifts from kernel.WIRE_FIELDS "
            f"at position {at}: {enum[at:at + 3]} != {list(wf[at:at + 3])} "
            f"({len(enum)} vs {len(wf)} fields)")
    presence = tuple(f for f in mb if f.endswith("_present"))
    if set(presence) != set(PRESENCE_FIELDS) \
            or set(presence) != set(PRESENT_FIELDS):
        problems.append(
            f"the occupancy registries (obs.recorder.PRESENCE_FIELDS "
            f"{sorted(PRESENCE_FIELDS)}, state.PRESENT_FIELDS) != the "
            f"mailbox's *_present leaves {sorted(presence)}")

    cfgs = {"clients-off": _base_cfg(), "clients-on": _gate_cfgs()["clients"],
            "clients-admission": _gate_cfgs()["admission"],
            "all-on": _all_on()}
    for label, cfg in cfgs.items():
        for ring in (0, RING):
            leaves = _named(_init(cfg))
            want = {_wire_name(n) for n in leaves}
            want |= {f for f in lanes if cfg.clients_u32
                     or not f.startswith("client_")}
            if ring:
                want |= {f"flight.{f}" for f in FLIGHT_LEAVES}
            got = kernel.wire_fields(cfg, ring)
            if set(got) != want or len(got) != len(want):
                problems.append(
                    f"[{label}, ring={ring}] kernel.wire_fields misses "
                    f"{sorted(want - set(got))} / carries stale "
                    f"{sorted(set(got) - want)} vs the State's leaves")
            for name, leaf in leaves.items():
                f = _wire_name(name)
                if f in got and kernel._shape(cfg, f, ring) \
                        != tuple(leaf.shape[1:]):
                    problems.append(
                        f"[{label}] kernel._shape files {f!r} as "
                        f"{kernel._shape(cfg, f, ring)} but its per-group "
                        f"shape is {tuple(leaf.shape[1:])}")
            wire, _ = _wire_pair(cfg, ring=ring)
            if wire.shape[0] != kernel.wire_words_per_group(cfg, ring):
                problems.append(
                    f"[{label}, ring={ring}] kinit's wire has "
                    f"{wire.shape[0]} rows, kernel.wire_words_per_group "
                    f"says {kernel.wire_words_per_group(cfg, ring)}")
    return problems


# ------------------------------------------------------------ cfg gating


def gating_problems() -> list[str]:
    """A gate off means the leaf is absent everywhere: None in the
    plain tick's State (at init and after one tick), off the kernel's
    wire, empty in the CPU oracle; and turning one gate on adds exactly
    its row's leaves."""
    from raft_tpu_torch.clients.state import CLIENT_LEAVES
    from raft_tpu_torch.core.cluster import Cluster
    from raft_tpu_torch.sim import kernel, step

    problems = []
    base = _base_cfg()
    base_names = _leaf_names(base)
    gate_base = {"admission": "clients"}
    for gate, cfg_on in _gate_cfgs().items():
        mb, nd, st_fields = GATED_LEAVES[gate]
        expect = {f"mailbox.{f}" for f in mb} | {f"nodes.{f}" for f in nd}
        for f in st_fields:
            expect |= ({f"clients.{x}" for x in CLIENT_LEAVES}
                       if f == "clients" else {f})
        ref = (base_names if gate not in gate_base
               else _leaf_names(_gate_cfgs()[gate_base[gate]]))
        on = _leaf_names(cfg_on)
        if on - ref != expect:
            problems.append(
                f"gate {gate!r}: turning it on adds leaves "
                f"{sorted(on - ref)} but the gating table promises "
                f"{sorted(expect)}")
        if ref - on:
            problems.append(f"gate {gate!r}: turning it on REMOVES leaves "
                            f"{sorted(ref - on)}")
        ticked = set(_named(step.tick(cfg_on, _init(cfg_on), 0)))
        if ticked != on:
            problems.append(
                f"gate {gate!r}: one plain tick changes the State's leaves "
                f"(adds {sorted(ticked - on)}, drops {sorted(on - ticked)})")
        w_off, w_on = set(kernel.wire_fields(base)), set(
            kernel.wire_fields(cfg_on))
        for f in mb + nd:
            if f in w_off:
                problems.append(f"gate {gate!r}: leaf {f} on the kernel "
                                f"wire with the gate off")
            if f not in w_on:
                problems.append(f"gate {gate!r}: leaf {f} missing from the "
                                f"kernel wire with the gate on")
    reads_on = dataclasses.replace(base, read_every=4)
    if _leaf_names(reads_on) != base_names:
        problems.append("read_every gates State leaves — the scheduled-"
                        "read state is always present")
    lanes = ("client_acked", "client_retries")
    if set(lanes) & set(kernel.wire_fields(base)):
        problems.append("client metric lanes on the wire with clients off")
    if set(lanes) - set(kernel.wire_fields(_gate_cfgs()["clients"])):
        problems.append("client metric lanes missing from the wire with "
                        "clients on")
    c_off, c_on = Cluster(base), Cluster(_gate_cfgs()["clients"])
    if c_off.nodes[0].sessions or c_off.nodes[0].snap_sessions:
        problems.append("oracle Node carries session tables with the "
                        "clients gate off")
    s = _gate_cfgs()["clients"].client_slots
    want_tab = {i: -1 for i in range(s)}
    if c_on.nodes[0].sessions != want_tab \
            or c_on.nodes[0].snap_sessions != want_tab:
        problems.append(
            f"oracle Node pre-registered tables {c_on.nodes[0].sessions} != "
            f"the batched init's slots 0..{s - 1} at -1")
    return problems


# ------------------------------------------------------------ shard rule


def shard_rule_problems() -> list[str]:
    """The port's shard rule: every wire is `[W, G]` with the group axis
    minor and `acc` has none, so a shard is a column span; a span's own
    `kinit` equals those columns of the whole fleet's; `groups.spans`
    cuts [0, G) into contiguous spans of ceil(G / n); a window's
    `kernel.window_slices` tile it in whole blocks but the tail, and the
    cohort windows tile the fleet."""
    from raft_tpu_torch.obs.recorder import RING, flight_init
    from raft_tpu_torch.parallel import cohort, groups
    from raft_tpu_torch.sim import kernel

    problems = []
    g = 5
    for label, cfg in (("clients-off", _base_cfg()),
                       ("clients-on", _gate_cfgs()["clients"])):
        for ring in (0, RING):
            st = _init(cfg, g)
            fl = flight_init(g, ring, device="cpu") if ring else None
            wire, acc = kernel.kinit(cfg, st, flight=fl)[0]
            if wire.dim() != 2 or wire.shape[1] != g:
                problems.append(f"[{label}, ring={ring}] kinit's wire "
                                f"{tuple(wire.shape)} is not [W, {g}]")
                continue
            if acc.dim() != 1:
                problems.append(f"[{label}] acc {tuple(acc.shape)} is not "
                                f"one row of counters")
            s0, s1 = 1, 4
            part = groups.take(st, None, fl, s0, s1, "cpu")
            w2 = kernel.kinit(cfg, part[0], flight=part[2])[0][0]
            if not torch.equal(w2, wire[:, s0:s1]):
                problems.append(
                    f"[{label}, ring={ring}] kinit of groups [{s0}, {s1}) "
                    f"!= those columns of the fleet's wire: a shard is "
                    f"not a column span")
    for g in (1, 5, 1000, 3000):
        for n in (1, 2, 3, 4, 8):
            sp = groups.spans(g, n)
            per = -(-g // n)
            at = 0
            for s0, s1 in sp:
                if s0 != at or s1 <= s0 or s1 - s0 > per:
                    problems.append(f"groups.spans({g}, {n}) = {sp} is not "
                                    f"contiguous spans of <= {per} groups")
                    break
                at = s1
            if at != g or len(sp) > n:
                problems.append(f"groups.spans({g}, {n}) = {sp} does not "
                                f"tile [0, {g})")
    for n in (1, 2, 4):
        for width in (1, kernel.GB, 3 * kernel.GB + 7, 8 * kernel.GB):
            sl = kernel.window_slices(0, width, n)
            at = 0
            for i, (j, lo, hi) in enumerate(sl):
                last = i == len(sl) - 1
                if lo != at or hi <= lo or (not last
                                            and (hi - lo) % kernel.GB):
                    problems.append(
                        f"kernel.window_slices(0, {width}, {n}) = {sl}: "
                        f"not whole blocks but the tail, in order")
                    break
                at = hi
            if at != width or [j for j, _, _ in sl] != list(range(len(sl))):
                problems.append(f"kernel.window_slices(0, {width}, {n}) = "
                                f"{sl} does not tile the window")
        cfg = dataclasses.replace(_base_cfg(), stream_groups=True,
                                  cohort_blocks=2)
        g = 5 * kernel.GB + 3
        wins = cohort.cohort_windows(cfg, g, n)
        if [w[0] for w in wins[1:]] != [w[1] for w in wins[:-1]] \
                or wins[0][0] != 0 or wins[-1][1] != g:
            problems.append(f"cohort.cohort_windows over {n} devices "
                            f"{wins} does not tile [0, {g})")
    return problems


# ------------------------------------------------------------ checkpoint


def checkpoint_problems(ckpt_mod=None,
                        include_behavioral: bool = True) -> list[str]:
    """`sim/checkpoint.py` coverage: the optional fields are exactly the
    gated leaves; behaviourally (two groups, npz in memory) a round trip
    is exact, pre-r07 and pre-r09 files backfill (safety to ones, the
    client lanes to zeros, a missing cfg knob to its default), a file
    that predates a semantic knob refuses a run that sets it, and a
    missing required leaf raises naming it. Pass `ckpt_mod` (a
    save/load namespace) to audit a drifted implementation."""
    from raft_tpu_torch.clients.state import ClientState
    from raft_tpu_torch.sim import checkpoint as real_ckpt
    from raft_tpu_torch.sim.run import metrics_init
    from raft_tpu_torch.sim.state import Mailbox, PerNode

    ckpt = real_ckpt if ckpt_mod is None else ckpt_mod
    problems = []
    gated_mb = {f for mb, _, _ in GATED_LEAVES.values() for f in mb}
    gated_nd = {f for _, nd, _ in GATED_LEAVES.values() for f in nd}
    gated_cl = {f.split(".", 1)[1] for _, _, stf in GATED_LEAVES.values()
                for f in stf if f.startswith("clients.")}
    for cls, gated in ((Mailbox, gated_mb), (PerNode, gated_nd),
                       (ClientState, gated_cl)):
        if real_ckpt._optional_fields(cls) != frozenset(gated):
            problems.append(
                f"checkpoint._optional_fields({cls.__name__}) "
                f"{sorted(real_ckpt._optional_fields(cls))} != the gated "
                f"leaves {sorted(gated)}")
    if not include_behavioral:
        return problems

    def roundtrip(cfg, label, strip=(), patch_cfg=(), expect_raise=None,
                  load_cfg="same"):
        st = _init(cfg)
        met = metrics_init(_G, clients=cfg.clients_u32 != 0, device="cpu")
        buf = io.BytesIO()
        ckpt.save(buf, st, 7, metrics=met, cfg=cfg)
        buf.seek(0)
        if strip or patch_cfg:
            with np.load(buf) as z:
                ghost = [k for k in strip if k not in z.files]
                if ghost:
                    problems.append(
                        f"backfill check could not strip {ghost}: the "
                        f"checkpoint key naming moved")
                data = {k: z[k] for k in z.files if k not in strip}
            if patch_cfg:
                saved = json.loads(bytes(data["__cfg__"]).decode())
                for k in patch_cfg:
                    saved.pop(k, None)
                data["__cfg__"] = np.bytes_(json.dumps(saved,
                                                       sort_keys=True))
            buf = io.BytesIO()
            np.savez(buf, **data)
            buf.seek(0)
        try:
            out = ckpt.load(buf, cfg=cfg if load_cfg == "same" else load_cfg,
                            device="cpu")
        except Exception as e:  # noqa: BLE001 — audited, not handled
            if expect_raise and isinstance(e, expect_raise):
                return e
            problems.append(f"[{label}] checkpoint load raised "
                            f"{type(e).__name__}: {e} (strip="
                            f"{sorted(strip)})")
            return None
        if expect_raise:
            problems.append(
                f"[{label}] checkpoint load SUCCEEDED where it must refuse "
                f"(strip={sorted(strip)}, cfg keys dropped "
                f"{sorted(patch_cfg)})")
            return None
        return st, met, out

    from raft_tpu_torch.utils.trees import trees_equal
    for label, cfg in (("base", _base_cfg()), ("all-on", _all_on())):
        r = roundtrip(cfg, label)
        if r is None:
            continue
        st, met, (st2, t2, met2) = r
        if t2 != 7:
            problems.append(f"[{label}] round trip lost the tick ({t2})")
        if not trees_equal(st, st2):
            problems.append(f"[{label}] round trip changed the State")
        if not trees_equal(met, met2):
            problems.append(f"[{label}] round trip changed the Metrics")
    r = roundtrip(_base_cfg(), "base", strip=("metrics.safety",))
    if not (r and not isinstance(r, Exception) and r[2][2] is not None
            and bool((r[2][2].safety == 1).all())):
        problems.append("pre-r07 backfill drift: a checkpoint without "
                        "metrics.safety must load with ones")
    lanes = ("metrics.client_acked", "metrics.client_retries",
             "metrics.client_hist", "metrics.client_max_lat")
    r = roundtrip(_all_on(), "all-on", strip=lanes)
    m2 = r[2][2] if r and not isinstance(r, Exception) else None
    if m2 is None or m2.client_acked is None or m2.client_hist is None \
            or bool(m2.client_acked.any()) or bool(m2.client_hist.any()):
        problems.append("pre-r09 backfill drift: a client checkpoint "
                        "without the client metric lanes must load with "
                        "zeros")
    r = roundtrip(_base_cfg(), "base",
                  patch_cfg=("client_rate", "client_slots", "nemesis"))
    if r is None or isinstance(r, Exception):
        problems.append("cfg-default backfill drift: a checkpoint whose "
                        "embedded cfg predates a knob must load against "
                        "the knob's default")
    roundtrip(_base_cfg(), "nemesis", patch_cfg=("nemesis",),
              load_cfg=dataclasses.replace(
                  _base_cfg(), nemesis=_nemesis_probe_program()),
              expect_raise=(ValueError,))
    adm = _gate_cfgs()["admission"]
    r = roundtrip(adm, "admission")
    if r is not None and not isinstance(r, Exception):
        st, _, (st2, _, _) = r
        if st2.clients.shed is None \
                or not torch.equal(st.clients.shed, st2.clients.shed):
            problems.append("admission round trip lost or changed the "
                            "clients.shed ledger")
    r = roundtrip(adm, "admission", strip=("state.clients.shed",),
                  patch_cfg=("client_queue_cap",),
                  load_cfg=_gate_cfgs()["clients"])
    if r is None or isinstance(r, Exception):
        problems.append("pre-r20 backfill drift: a client checkpoint "
                        "predating admission control must load under a "
                        "cap-off cfg")
    elif r[2][0].clients.shed is not None:
        problems.append("pre-r20 file loaded a phantom clients.shed leaf "
                        "under a cap-off cfg")
    roundtrip(adm, "admission", strip=("state.clients.shed",),
              patch_cfg=("client_queue_cap",), load_cfg=adm,
              expect_raise=(ValueError,))
    r = roundtrip(_base_cfg(), "base", strip=("state.nodes.term",),
                  expect_raise=(KeyError,))
    if isinstance(r, Exception) and "state.nodes.term" not in str(r):
        problems.append(f"missing-leaf error does not name the field: {r}")
    roundtrip(_base_cfg(), "base",
              load_cfg=dataclasses.replace(_base_cfg(), seed=99),
              expect_raise=(ValueError,))
    return problems


# ------------------------------------------------------ packed wire layout


def _packed_cfgs() -> dict:
    base = _base_cfg()
    return {
        "pack_bools": dataclasses.replace(base, pack_bools=True),
        "pack_ring": dataclasses.replace(base, pack_ring=True),
        "packed": dataclasses.replace(base, pack_bools=True, pack_ring=True),
        "ceiling": dataclasses.replace(base, pack_bools=True,
                                       pack_ring=True, alias_wire=True,
                                       wire_hist=False),
        "packed-clients": dataclasses.replace(
            _gate_cfgs()["clients"], pack_bools=True, pack_ring=True),
    }


def packing_problems(include_behavioral: bool = True) -> list[str]:
    """The packed wire: the layout dials change no State leaf; the rows
    at rest match independent arithmetic (votes as k bit lanes,
    alive_prev as one word, the bool mailbox slots as ceil(n * k / 32)
    shared words per destination, log_term as two 16-bit deltas a word
    plus a base lane) and `kinit`'s wire; wire_hist drops exactly acc's
    [H] rows; behaviourally `kernel.pack`/`unpack` round-trip a
    synthetic wire exactly and a checkpoint crosses layouts."""
    from raft_tpu_torch.sim import kernel
    from raft_tpu_torch.sim.run import HIST_SIZE
    from raft_tpu_torch.sim.state import MB_BOOL

    problems = []
    base_names = _leaf_names(_base_cfg())
    for label, cfg in _packed_cfgs().items():
        off = dataclasses.replace(cfg, pack_bools=False, pack_ring=False,
                                  alias_wire=False, wire_hist=True)
        ref = base_names if off == _base_cfg() else _leaf_names(off)
        if _leaf_names(cfg) != ref:
            problems.append(f"[{label}] layout dials changed the State's "
                            f"leaves")
        k, cap = cfg.k, cfg.log_cap
        n_bool = sum(1 for f in kernel.wire_fields(cfg) if f in MB_BOOL)
        rows = kernel.working_words_per_group(cfg)
        if cfg.pack_bools:
            rows -= (k * k - k) + (k - 1)
            rows -= n_bool * k * k - (-(-n_bool * k // 32)) * k
        if cfg.pack_ring:
            rows -= k * cap - (k * cap // 2 + 1)
        if kernel.wire_words_per_group(cfg) != rows:
            problems.append(
                f"[{label}] kernel.wire_words_per_group "
                f"{kernel.wire_words_per_group(cfg)} != the independent "
                f"arithmetic's {rows}")
        if _wire_pair(cfg)[0].shape[0] != rows:
            problems.append(f"[{label}] kinit's wire rows != {rows}")
        no_hist = dataclasses.replace(cfg, wire_hist=False)
        want = kernel.acc_words(dataclasses.replace(
            cfg, wire_hist=True)) - HIST_SIZE * (2 if cfg.clients_u32 else 1)
        if kernel.acc_words(no_hist) != want:
            problems.append(f"[{label}] wire_hist=False acc holds "
                            f"{kernel.acc_words(no_hist)} words, not "
                            f"{want} (must drop exactly the [H] rows)")
    if not include_behavioral:
        return problems
    for label in ("packed", "packed-clients"):
        cfg = _packed_cfgs()[label]
        g = 5
        at = kernel._work_at(cfg)
        booly = set(MB_BOOL) | {"votes", "alive_prev"}
        w = torch.zeros((kernel.working_words_per_group(cfg), g),
                        dtype=torch.int32)
        for i, (name, (s, n)) in enumerate(at.items()):
            v = (torch.arange(n * g, dtype=torch.int64).reshape(n, g)
                 * (2 * i + 3)) % 5
            w[s:s + n] = (v % 2 if name in booly else v).to(torch.int32)
        back, _ = kernel.unpack(cfg, kernel.pack(cfg, w))
        for name, (s, n) in at.items():
            if not torch.equal(back[s:s + n], w[s:s + n]):
                problems.append(f"[{label}] pack/unpack round trip changed "
                                f"wire field {name!r}")
    from raft_tpu_torch.sim import checkpoint as ckpt
    buf = io.BytesIO()
    ckpt.save(buf, _init(_base_cfg()), 3, cfg=_base_cfg())
    buf.seek(0)
    try:
        ckpt.load(buf, cfg=_packed_cfgs()["packed"], device="cpu")
    except Exception as e:  # noqa: BLE001 — audited, not handled
        problems.append(f"cross-layout checkpoint load raised "
                        f"{type(e).__name__}: {e} — config.LAYOUT_FIELDS "
                        f"must stay out of the semantic match")
    return problems


# ------------------------------------------------- narrow-native layout


def _narrow_cfgs() -> dict:
    base = _base_cfg()
    every = dict(narrow_scalars=True, narrow_ring=True, narrow_mailbox=True,
                 narrow_clients=True)
    return {
        "narrow_scalars": dataclasses.replace(base, narrow_scalars=True),
        "narrow_ring": dataclasses.replace(base, narrow_ring=True),
        "narrow_mailbox": dataclasses.replace(base, narrow_mailbox=True),
        "donate_scan": dataclasses.replace(base, donate_scan=True),
        "narrow-all": dataclasses.replace(base, **every),
        "narrow-clients": dataclasses.replace(_gate_cfgs()["clients"],
                                              **every),
    }


def narrowing_problems(include_behavioral: bool = True) -> list[str]:
    """The narrow resident form: every dial off by default and then
    `narrow_spec` empty; the dials change leaf dtypes only (names and
    shapes stay), leave `config_hash` and the kernel's wire alone, and
    `narrow_spec` agrees with the narrow init leaf by leaf; behaviourally
    the overflow latch fires for every narrowed leaf, refuses at the
    host boundary and stays sticky, narrow init equals wide init in
    value, and a checkpoint hops the narrow axis both ways."""
    from raft_tpu_torch.config import NARROW_FIELDS
    from raft_tpu_torch.obs.manifest import config_hash
    from raft_tpu_torch.sim import state as state_mod

    problems = []
    for f in NARROW_FIELDS:
        if getattr(RaftConfig(), f) is not False:
            problems.append(f"narrow dial {f!r} does not default to False")
    base = _base_cfg()
    if state_mod.narrow_spec(base) or state_mod.narrow_active(base):
        problems.append("narrow_spec is non-empty with every dial off")

    def shapes(cfg):
        return {n: tuple(a.shape) for n, a in _named(_init(cfg)).items()}

    def wire_sig(cfg):
        return [(tuple(a.shape), a.dtype) for a in _wire_pair(cfg)]

    for label, cfg in _narrow_cfgs().items():
        off = dataclasses.replace(cfg, **{f: False for f in NARROW_FIELDS})
        if shapes(cfg) != shapes(off):
            problems.append(f"[{label}] narrow dials changed State leaf "
                            f"names or shapes")
        if config_hash(cfg) != config_hash(off):
            problems.append(f"[{label}] config_hash moved under the narrow "
                            f"dials")
        if wire_sig(cfg) != wire_sig(off):
            problems.append(f"[{label}] kinit's wire moved under the narrow "
                            f"dials")
        leaves = _named(_init(cfg))
        for name, dt in state_mod.narrow_spec(cfg).items():
            if name not in leaves:
                problems.append(f"[{label}] narrow_spec names {name!r}, "
                                f"which the State does not carry")
            elif leaves[name].dtype != dt:
                problems.append(f"[{label}] narrow init holds {name} as "
                                f"{leaves[name].dtype}, narrow_spec says "
                                f"{dt}")
    if not include_behavioral:
        return problems
    from raft_tpu_torch.utils.trees import trees_equal_values, trees_equal_why
    ncfg = _narrow_cfgs()["narrow-clients"]
    spec = state_mod.narrow_spec(ncfg)
    wide0 = state_mod.widen_state(ncfg, _init(ncfg))
    over = {state_mod.U16: 1 << 16, state_mod.I16: 1 << 15,
            state_mod.I8: 1 << 10}
    for name, dt in sorted(spec.items()):
        def poke(path, leaf, name=name):
            if path != name:
                return leaf
            flat = leaf.clone().reshape(leaf.shape[0], -1)
            flat[0, 0] = over[dt]
            return flat.reshape(leaf.shape)
        bad = state_mod._map_named(wide0, "", poke)
        bad = bad._replace(group_id=wide0.group_id)
        narrowed = state_mod.narrow_state(ncfg, bad)
        ov = state_mod.narrow_overflow(narrowed)
        if not (bool(ov[0]) and not bool(ov[1:].any())):
            problems.append(f"overflow latch missed narrowed leaf {name!r}")
            continue
        try:
            state_mod.check_narrow_overflow(ncfg, narrowed)
            problems.append(f"check_narrow_overflow accepted a state "
                            f"latched via {name!r}")
        except ValueError:
            pass
        again = state_mod.narrow_state(ncfg,
                                       state_mod.widen_state(ncfg, narrowed))
        if not bool(state_mod.narrow_overflow(again)[0]):
            problems.append(f"overflow latch for {name!r} is not sticky "
                            f"across widen/narrow")
    wide_cfg = dataclasses.replace(ncfg, **{f: False for f in NARROW_FIELDS})
    wide_init, narrow_init = _init(wide_cfg), _init(ncfg)
    ok, why = trees_equal_why(wide_init, narrow_init, values_only=True)
    if not ok:
        problems.append(f"narrow init differs from wide init in value: "
                        f"{why}")
    if trees_equal_why(wide_init, narrow_init)[0]:
        problems.append("narrow init is byte-identical to wide init — the "
                        "dials narrowed nothing")
    from raft_tpu_torch.sim import checkpoint as ckpt
    for src, dst, way in ((ncfg, wide_cfg, "narrow->wide"),
                          (wide_cfg, ncfg, "wide->narrow")):
        st = _init(src)
        buf = io.BytesIO()
        ckpt.save(buf, st, 5, cfg=src)
        buf.seek(0)
        try:
            loaded, t, _ = ckpt.load(buf, cfg=dst, device="cpu")
        except Exception as e:  # noqa: BLE001 — audited, not handled
            problems.append(f"checkpoint {way} hop raised "
                            f"{type(e).__name__}: {e}")
            continue
        if t != 5 or not trees_equal_values(st, loaded):
            problems.append(f"checkpoint {way} hop changed the tick or the "
                            f"State's values")
        if not trees_equal_why(_init(dst), loaded)[0]:
            problems.append(f"checkpoint {way} hop did not land on the "
                            f"destination cfg's resident dtypes")
    return problems


# ---------------------------------------------------- nemesis compiler


def nemesis_problems(kinds: tuple | None = None,
                     link_kinds: tuple | None = None,
                     crash_kinds: tuple | None = None,
                     timing_kinds: tuple | None = None,
                     disk_kinds: tuple | None = None,
                     compact_kinds: tuple | None = None) -> list[str]:
    """The nemesis compiler: every clause kind routed to exactly one
    engine seam (link, crash, timing, disk, compaction); every kind
    buildable through `nemesis/program.py`; a program of every kind adds
    no State leaf, no wire field and no wire row (only the clause table,
    32 B a clause of shared memory); a program survives a JSON round
    trip as an equal, hashable config. Pass drifted kind tuples to see
    the auditor name them."""
    from raft_tpu_torch.nemesis.program import KIND_NAMES, from_json, to_json
    from raft_tpu_torch.sim import kernel
    from raft_tpu_torch.utils import rng as r

    kinds = r.NEM_KINDS if kinds is None else tuple(kinds)
    seams = [r.NEM_LINK_KINDS if link_kinds is None else link_kinds,
             r.NEM_CRASH_KINDS if crash_kinds is None else crash_kinds,
             r.NEM_TIMING_KINDS if timing_kinds is None else timing_kinds,
             r.NEM_DISK_KINDS if disk_kinds is None else disk_kinds,
             r.NEM_COMPACT_KINDS if compact_kinds is None
             else compact_kinds]
    routed = [k for s in seams for k in s]
    problems = []
    unrouted = [k for k in kinds if k not in routed]
    if unrouted:
        problems.append(f"nemesis kinds {unrouted} routed to NO engine seam "
                        f"(NEM_LINK/CRASH/TIMING/DISK/COMPACT_KINDS) — their "
                        f"clauses would be silently ignored")
    dup = sorted({k for k in routed if routed.count(k) > 1})
    if dup:
        problems.append(f"nemesis kinds {dup} routed to MORE than one seam "
                        f"— their clauses would double-apply")
    ghost = [k for k in routed if k not in kinds]
    if ghost:
        problems.append(f"seam filters route unknown nemesis kinds {ghost}")
    built = {c[0] for c in _nemesis_probe_program()}
    missing = [k for k in kinds if k not in built]
    if missing:
        problems.append(f"nemesis kinds {missing} have no program.py "
                        f"builder (KIND_NAMES knows {sorted(KIND_NAMES)})")
    base = _base_cfg()
    on = dataclasses.replace(base, nemesis=_nemesis_probe_program())
    if _leaf_names(on) != _leaf_names(base):
        problems.append("a nemesis program changed the State's leaves")
    for fn in (kernel.wire_fields, kernel.wire_words_per_group,
               kernel.working_words_per_group, kernel.acc_words):
        if fn(on) != fn(base):
            problems.append(f"a nemesis program changed kernel."
                            f"{fn.__name__} — no new wire lanes")
    table = kernel.shared_bytes(on) - kernel.shared_bytes(base)
    parts = 4 * (kernel.shared_words_per_group(on)
                 - kernel.shared_words_per_group(base))
    if table - parts != 32 * len(on.nemesis):
        problems.append(f"the clause table adds {table - parts} B of shared "
                        f"memory, not 32 B for each of {len(on.nemesis)} "
                        f"clauses")
    if [(tuple(a.shape), a.dtype) for a in _wire_pair(base)] \
            != [(tuple(a.shape), a.dtype) for a in _wire_pair(on)]:
        problems.append("a nemesis program changed kinit's wire")
    d = json.loads(json.dumps(dataclasses.asdict(on)))
    if RaftConfig(**d) != on or hash(RaftConfig(**d)) != hash(on):
        problems.append("RaftConfig.nemesis does not survive a JSON round "
                        "trip as an equal, hashable config")
    if from_json(to_json(on.nemesis)) != on.nemesis:
        problems.append("nemesis program to_json/from_json is not the "
                        "identity")
    return problems


# --------------------------------------------------- cohort streaming


def _streamed_cfgs() -> dict:
    base = _base_cfg()
    return {
        "streamed": dataclasses.replace(base, stream_groups=True),
        "streamed-1blk": dataclasses.replace(base, stream_groups=True,
                                             cohort_blocks=1),
        "streamed-dials": dataclasses.replace(
            base, stream_groups=True, cohort_blocks=2, pack_bools=True,
            pack_ring=True, alias_wire=True, wire_hist=False),
        "streamed-clients": dataclasses.replace(
            _gate_cfgs()["clients"], stream_groups=True, cohort_blocks=2),
    }


def streaming_problems(include_behavioral: bool = True) -> list[str]:
    """Cohort streaming: the residency knobs (config.STREAM_FIELDS) exist,
    are off by default and gate nothing (no State leaf, no wire field or
    row, the same kinit wire); the window pipeline fits the audit card
    and `kernel.streamed_ceiling_groups` is the exact `supported()`
    boundary; behaviourally paging a host wire through every window, on
    one CPU device and on two, is the identity, and a checkpoint crosses
    residencies."""
    from raft_tpu_torch.analysis.bytemodel import (AUDIT_HBM_BYTES,
                                                   AUDIT_HOST_BYTES)
    from raft_tpu_torch.config import STREAM_FIELDS
    from raft_tpu_torch.sim import kernel

    problems = []
    defaults = RaftConfig()
    for f in STREAM_FIELDS:
        if not hasattr(defaults, f):
            return [f"config.STREAM_FIELDS names {f!r} but RaftConfig has "
                    f"no such field"]
    if defaults.stream_groups:
        problems.append("cfg.stream_groups defaults on")
    if GATED_LEAVES.get("streaming") != ((), (), ()):
        problems.append("GATED_LEAVES 'streaming' row is not empty")
    budgets = dict(hbm=AUDIT_HBM_BYTES, host=AUDIT_HOST_BYTES)
    for label, cfg in _streamed_cfgs().items():
        off = dataclasses.replace(cfg, stream_groups=False,
                                  cohort_blocks=defaults.cohort_blocks)
        if _leaf_names(cfg) != _leaf_names(off):
            problems.append(f"[{label}] residency knobs changed the State's "
                            f"leaves")
        for fn in (kernel.wire_fields, kernel.wire_words_per_group,
                   kernel.acc_words):
            if fn(cfg) != fn(off):
                problems.append(f"[{label}] residency knobs changed kernel."
                                f"{fn.__name__}")
        if [(tuple(a.shape), a.dtype) for a in _wire_pair(cfg)] \
                != [(tuple(a.shape), a.dtype) for a in _wire_pair(off)]:
            problems.append(f"[{label}] residency knobs changed kinit's "
                            f"wire")
        if kernel.cohort_hbm_bytes(cfg) > AUDIT_HBM_BYTES:
            problems.append(f"[{label}] one window's pipeline "
                            f"({kernel.cohort_hbm_bytes(cfg)} B) does not "
                            f"fit the {AUDIT_HBM_BYTES} B audit card")
            continue
        ceiling = kernel.streamed_ceiling_groups(cfg, **budgets)
        if not (kernel.supported(cfg, ceiling, **budgets)
                and not kernel.supported(cfg, ceiling + kernel.GB,
                                         **budgets)):
            problems.append(f"[{label}] streamed_ceiling_groups {ceiling} is "
                            f"not the exact supported() boundary")
    if not include_behavioral:
        return problems
    from raft_tpu_torch.parallel import cohort, stream_sched
    cfg = _streamed_cfgs()["streamed-1blk"]
    g = kernel.GB + 5
    for mesh in (None, ("cpu", "cpu")):
        hw = cohort.host_wire(cfg, _init(cfg, g), device="cpu", mesh=mesh)
        before = [b.clone() for b in hw.blocks]
        lanes = stream_sched.lanes(hw.mesh)
        for i in range(len(hw.parts)):
            cur = stream_sched.put_window(hw, i, lanes)
            stream_sched.drain_window(
                hw, {j: (b, d, None) for j, (b, d, _) in cur.items()}, lanes)
        if any(not torch.equal(a, b) for a, b in zip(before, hw.blocks)):
            problems.append(f"paging the host wire through every window "
                            f"(mesh {mesh}) changed it — slicing and copy "
                            f"back must be the identity")
    from raft_tpu_torch.sim import checkpoint as ckpt
    for src, dst, what in ((_base_cfg(), _streamed_cfgs()["streamed"],
                            "resident->streamed"),
                           (_streamed_cfgs()["streamed"], _base_cfg(),
                            "streamed->resident")):
        buf = io.BytesIO()
        ckpt.save(buf, _init(src), 3, cfg=src)
        buf.seek(0)
        try:
            ckpt.load(buf, cfg=dst, device="cpu")
        except Exception as e:  # noqa: BLE001 — audited, not handled
            problems.append(f"cross-residency checkpoint load ({what}) "
                            f"raised {type(e).__name__}: {e}")
    return problems


# ------------------------------------------------------- manifest schema


def manifest_problems(manifest_mod=None, history_mod=None) -> list[str]:
    """Manifest records: every registry key (`obs.manifest.ALL_KEYS`)
    and the port's own (`torch`, `cuda`, `device`, `power_limit_w`,
    `mesh_shape`, `groups_per_device`) in every record from emission,
    null until the caller fills them; the registries lead with the
    config's dials; caller values survive; `obs.history.backfill_record`
    adds exactly the registry keys, as null, to an older record and
    rewrites nothing. Pass a drifted module to see it named."""
    from raft_tpu_torch.config import LAYOUT_FIELDS, NARROW_FIELDS, STREAM_FIELDS
    from raft_tpu_torch.obs import history as real_history
    from raft_tpu_torch.obs import manifest as real_manifest

    man = real_manifest if manifest_mod is None else manifest_mod
    hist = real_history if history_mod is None else history_mod
    problems = []
    keys = real_manifest.ALL_KEYS
    if tuple(real_manifest.PACKING_KEYS) != tuple(LAYOUT_FIELDS):
        problems.append(f"obs.manifest.PACKING_KEYS != config.LAYOUT_FIELDS "
                        f"{LAYOUT_FIELDS}")
    if tuple(real_manifest.STREAM_KEYS[:len(STREAM_FIELDS)]) \
            != tuple(STREAM_FIELDS):
        problems.append(f"obs.manifest.STREAM_KEYS does not lead with "
                        f"config.STREAM_FIELDS {STREAM_FIELDS}")
    if tuple(real_manifest.NARROW_KEYS[:len(NARROW_FIELDS)]) \
            != tuple(NARROW_FIELDS):
        problems.append(f"obs.manifest.NARROW_KEYS does not lead with "
                        f"config.NARROW_FIELDS {NARROW_FIELDS}")
    rec = man.emit_manifest("audit-probe", _base_cfg(), path="-")
    port_keys = ("device", "power_limit_w", "mesh_shape",
                 "groups_per_device")
    for k in keys + port_keys:
        if k not in rec:
            problems.append(f"manifest record missing default key {k!r}")
        elif rec[k] is not None:
            problems.append(f"manifest default for {k!r} is {rec[k]!r}, "
                            f"not null")
    for k in ("torch", "cuda"):
        if k not in rec:
            problems.append(f"manifest record missing the {k!r} version")
    fill = {"bound": "bytes", "attainment_pct": 12.5, "pack_bools": True,
            "wire_hist": False, "stream_groups": True, "cohort_blocks": 2,
            "stream_devices": 2, "stream_slowest_device": 1,
            "narrow_scalars": True, "knee_ops_per_sec": 1.5e6,
            "pressure_program_hash": "deadbeef", "device": "cuda:0",
            "power_limit_w": 700.0}
    rec2 = man.emit_manifest("audit-probe", _base_cfg(), path="-", **fill)
    for k, want in fill.items():
        if rec2.get(k) != want:
            problems.append(f"manifest dropped the caller's {k!r} value "
                            f"({rec2.get(k)!r} != {want!r})")
    old = {k: v for k, v in rec.items() if k not in keys}
    back = hist.backfill_record(old)
    for k in keys:
        if k not in back:
            problems.append(f"history.backfill_record leaves an older "
                            f"record without {k!r}")
        elif back[k] is not None:
            problems.append(f"history.backfill_record invents a value for "
                            f"{k!r} ({back[k]!r})")
    changed = {k for k in old if back.get(k) != old[k]}
    if changed:
        problems.append(f"history.backfill_record rewrote fields "
                        f"{sorted(changed)}")
    return problems


# ------------------------------------------------------------- rng parity


def rng_parity_problems() -> list[str]:
    """`utils.rng` (host ints) and `utils.trng` (tensors) export the same
    hash surface, with the same parameters: a draw on one side only is
    the drift the randomness lint hunts."""
    import inspect

    from raft_tpu_torch.utils import rng, trng

    def public(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and not n.startswith("_")
                and getattr(v, "__module__", None) == mod.__name__}

    problems = []
    if public(rng) - public(trng):
        problems.append(f"rng functions missing a trng twin: "
                        f"{sorted(public(rng) - public(trng))}")
    if public(trng) - public(rng):
        problems.append(f"trng functions missing an rng twin: "
                        f"{sorted(public(trng) - public(rng))}")
    for n in sorted(public(rng) & public(trng)):
        a = list(inspect.signature(getattr(rng, n)).parameters)
        b = list(inspect.signature(getattr(trng, n)).parameters)
        if a != b:
            problems.append(f"rng.{n}{a} and trng.{n}{b} disagree on "
                            f"parameter names or order")
    return problems


def contract_problems(include_behavioral: bool = True) -> list[str]:
    """Every contract pass, concatenated."""
    out = []
    out += metric_parity_problems()
    out += wire_registry_problems()
    out += gating_problems()
    out += shard_rule_problems()
    out += packing_problems(include_behavioral=include_behavioral)
    out += narrowing_problems(include_behavioral=include_behavioral)
    out += checkpoint_problems(include_behavioral=include_behavioral)
    out += nemesis_problems()
    out += streaming_problems(include_behavioral=include_behavioral)
    out += manifest_problems()
    out += rng_parity_problems()
    return out


# ------------------------------------------------------- the card's plan


def default_plan_runs() -> list:
    """(label, cfg, groups, ring) of the audit's plan check: the byte
    model's audited layouts at 100,000 groups, with the flight ring."""
    from raft_tpu_torch.analysis.bytemodel import audit_cfgs
    from raft_tpu_torch.obs.recorder import RING
    return [(label, cfg, 100_000, RING) for label, cfg in audit_cfgs()]


def kernel_plan_problems(runs=None) -> list[str]:
    """The C launcher's block shape (`kernel.launch_plan`, the occupancy
    query of `fused_chunk_plan`) against the Python model, for each
    (label, cfg, groups, ring) of `runs` (default `default_plan_runs`):
    groups per block times a group's shared bytes
    (`kernel.shared_words_per_group`), plus the clause table, must be
    the block's shared bytes, within `SMEM_PER_BLOCK`; threads are
    groups times lanes, lanes at least k, and groups per SM blocks per
    SM times groups per block. Needs a card: without one it raises
    `RuntimeError` (the pass is skipped, not clean)."""
    from raft_tpu_torch.sim import kernel
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_plan_problems skipped: no CUDA device "
                           "(the plan is the card's occupancy query)")
    problems = []
    for label, cfg, g, ring in default_plan_runs() if runs is None else runs:
        p = kernel.launch_plan(cfg, g, ring)
        table = 4 * 8 * len(cfg.nemesis)
        want = (p["groups_per_block"] * 4 * kernel.shared_words_per_group(cfg)
                + table)
        if p["shared_bytes_per_block"] != want:
            problems.append(
                f"[{label}] the launcher's block takes "
                f"{p['shared_bytes_per_block']} B of shared memory; "
                f"{p['groups_per_block']} groups x "
                f"{4 * kernel.shared_words_per_group(cfg)} B + the "
                f"{table} B clause table is {want}")
        if p["shared_bytes_per_block"] > kernel.SMEM_PER_BLOCK:
            problems.append(f"[{label}] {p['shared_bytes_per_block']} B of "
                            f"shared memory a block > SMEM_PER_BLOCK "
                            f"{kernel.SMEM_PER_BLOCK}")
        if p["threads_per_block"] != p["groups_per_block"] \
                * p["lanes_per_group"] or p["lanes_per_group"] < cfg.k:
            problems.append(f"[{label}] block of {p['threads_per_block']} "
                            f"threads is not {p['groups_per_block']} groups "
                            f"x {p['lanes_per_group']} lanes (>= k={cfg.k})")
        if p["groups_per_sm"] != p["blocks_per_sm"] * p["groups_per_block"]:
            problems.append(f"[{label}] {p['groups_per_sm']} groups per SM "
                            f"!= {p['blocks_per_sm']} blocks x "
                            f"{p['groups_per_block']} groups")
    return problems
