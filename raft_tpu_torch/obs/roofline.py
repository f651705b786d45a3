"""Roofline: the least time one H100 could take for a run, and the share
of it a measured run attains (the JAX package's `obs/roofline.py`, with
the card's peaks and the run's own operation count).

For each (cfg, groups, engine) it derives

- **bytes per tick** from the reconciled byte model
  (`analysis.bytemodel`, the one byte accounting): the kernel class reads
  and writes the wire at rest once per launch, so a launch of
  `chunk_ticks` ticks moves 2 x wire bytes x groups; the plain class
  (the PyTorch tick) reads and writes the resident State, its metric
  lanes and flight rows every tick. Both are floors, so the predicted
  rate is a ceiling and attainment (measured / predicted) a share of it.
- **integer operations per tick** from `run_ops`: the hash work a run's
  own schedules and states need (the counter-based draws, the payload
  and digest hashes, the nemesis program's draws), the same for every
  engine that computes the run. Without it (`ops=None`) the bound is by
  bytes alone.

Predicted ticks/s = 1 / max(bytes / HBM rate, operations / int32 rate);
`bound` names the larger side ("bytes" or "operations"); predicted
rounds/s = predicted ticks/s x the committed entries a tick schedules
(groups x (cmds_per_tick + client_slots x client_rate)).

Peaks of one NVIDIA H100 SXM, each with an environment override:
device memory 3.35 TB/s (data sheet; `RAFT_TPU_TORCH_HBM_GBPS`), int32
on the CUDA cores 64 lanes x 132 SMs x 1.98 GHz boost (Hopper
architecture white paper; `RAFT_TPU_TORCH_INT32_GOPS`), and the host
link PCIe Gen5 x16 at 64 GB/s each way (data sheet: 128 GB/s both ways
together; `RAFT_TPU_TORCH_HOST_GBPS`). The card may run below the
700 W these rates assume: a share is read beside the card's power limit.
"""

from __future__ import annotations

import collections
import os

import torch

from raft_tpu_torch.analysis import bytemodel
from raft_tpu_torch.config import NARROW_FIELDS, STREAM_FIELDS
from raft_tpu_torch.obs.manifest import (NARROW_KEYS, STREAM_KEYS,
                                         STREAM_MESH_KEYS)
from raft_tpu_torch.sim import kernel
from raft_tpu_torch.utils import rng, trng

DEFAULT_HBM_GBPS = 3_350.0
DEFAULT_INT32_GOPS = 64 * 132 * 1.98
DEFAULT_HOST_GBPS = 64.0

HBM_ENV = "RAFT_TPU_TORCH_HBM_GBPS"
INT32_ENV = "RAFT_TPU_TORCH_INT32_GOPS"
HOST_ENV = "RAFT_TPU_TORCH_HOST_GBPS"

# Ticks per kernel launch when the caller does not say.
DEFAULT_CHUNK_TICKS = 200

# The stamp every published number carries (obs.manifest ROOFLINE_KEYS).
ROOFLINE_FIELDS = ("predicted_rounds_per_sec", "attainment_pct", "bound")

MIX_OPS = 7              # mix32: 3 xors, 2 shifts, 2 multiplies
FOLD_OPS = MIX_OPS + 2   # one hash_u32 argument: multiply, add, mix32


def peak_hbm_gbps() -> float:
    return float(os.environ.get(HBM_ENV, DEFAULT_HBM_GBPS))


def peak_int32_gops() -> float:
    return float(os.environ.get(INT32_ENV, DEFAULT_INT32_GOPS))


def peak_host_gbps() -> float:
    return float(os.environ.get(HOST_ENV, DEFAULT_HOST_GBPS))


def engine_class(engine: str | None) -> str:
    """"kernel" for an engine string that starts with "cuda" (the fused
    chunk: resident, streamed, and sharded as `cuda-sharded-{n}dev` and
    `cuda-streamed-sharded-{n}dev`), else "plain" (the PyTorch tick). A
    prefix, not a substring: "plain (cuda mismatch!)" names the engine
    that stood, and pricing it as the kernel would overstate its ceiling
    some hundredfold."""
    return "kernel" if engine and engine.startswith("cuda") else "plain"


# ------------------------------------------------------------ byte model


def _checked(model: dict) -> dict:
    if model["problems"]:
        raise RuntimeError("roofline: the byte model does not reconcile:\n  "
                           + "\n  ".join(model["problems"]))
    return model


def tick_byte_model(cfg, n_groups: int, engine: str | None,
                    chunk_ticks: int | None = None, ring: int = 0,
                    nd: int = 1) -> dict:
    """The least device bytes one tick moves under `engine` on each of
    `nd` devices, the fleet sharded over them (`parallel.groups.spans`:
    the largest shard, ceil(n_groups / nd) groups): the kernel class
    moves the wire at rest (flight rows included) in and out once per
    `chunk_ticks`-tick launch at the real group count (the port pads no
    block); the plain class moves the resident bytes (State under the
    narrow dials, metric lanes, flight rows) in and out every tick."""
    cls = engine_class(engine)
    n_groups = -(-n_groups // nd)
    wire = _checked(bytemodel.derived_wire_model(cfg, ring))[
        "wire_bytes_derived"]
    resident = _checked(bytemodel.resident_bytes_model(cfg, ring))[
        "resident_bytes_narrow"]
    chunk = None
    if cls == "kernel":
        chunk = chunk_ticks or DEFAULT_CHUNK_TICKS
        per_tick = 2 * wire * n_groups / chunk
    else:
        per_tick = 2 * resident * n_groups
    return {"engine_class": cls, "wire_bytes_per_group": wire,
            "resident_bytes_per_group": resident,
            "bytes_per_tick": per_tick, "chunk_ticks": chunk}


def roofline(cfg, n_groups: int, engine: str | None,
             chunk_ticks: int | None = None, ring: int = 0,
             measured_ticks_per_sec: float | None = None,
             ops: float | None = None, nd: int = 1) -> dict:
    """The roofline record of one (cfg, groups, engine) point, the groups
    sharded over `nd` devices (the JAX package's mesh axis: each device's
    share of the bytes and the operations; the fleet's rounds). `ops` is
    the run's integer operations per tick (`run_ops(...) / n_ticks`);
    None binds by bytes alone. `measured_ticks_per_sec=None` leaves
    `attainment_pct` null."""
    bm = tick_byte_model(cfg, n_groups, engine, chunk_ticks, ring, nd)
    hbm, int32 = peak_hbm_gbps(), peak_int32_gops()
    hbm_s = bm["bytes_per_tick"] / (hbm * 1e9)
    ops_s = ops / nd / (int32 * 1e9) if ops is not None else None
    worst = max(hbm_s, ops_s or 0.0)
    predicted = 1.0 / worst
    rounds_per_tick = n_groups * (cfg.cmds_per_tick
                                  + cfg.client_slots * cfg.client_rate)
    return {
        **bm, "n_groups": n_groups, "nd": nd,
        "ops_per_tick": ops,
        # No counterpart of XLA's scheduled-bytes figure here.
        "xla_bytes_accessed_per_tick": None,
        "peak_hbm_gbps": hbm, "peak_int32_gops": int32,
        "hbm_s_per_tick": hbm_s, "ops_s_per_tick": ops_s,
        "bound": "bytes" if hbm_s >= (ops_s or 0.0) else "operations",
        "predicted_ticks_per_sec": predicted,
        "rounds_per_tick": rounds_per_tick,
        "predicted_rounds_per_sec": predicted * rounds_per_tick,
        "measured_ticks_per_sec": measured_ticks_per_sec,
        "attainment_pct": (None if measured_ticks_per_sec is None
                           else 100.0 * measured_ticks_per_sec / predicted),
    }


def segment_fields(cfg, n_groups: int, engine: str | None,
                   ticks: int | None = None,
                   timed_wall_s: float | None = None,
                   chunk_ticks: int | None = None, ring: int = 0,
                   measured: bool = True, ops: float | None = None,
                   nd: int = 1) -> dict:
    """The stamp of one measured run over `nd` devices: `ROOFLINE_FIELDS`
    and the whole derivation under "roofline". `measured=False`, or no
    `ticks` and `timed_wall_s`, leaves the measured side null."""
    mtps = ticks / timed_wall_s if measured and ticks and timed_wall_s \
        else None
    r = roofline(cfg, n_groups, engine, chunk_ticks, ring, mtps, ops, nd)
    return {"predicted_rounds_per_sec": r["predicted_rounds_per_sec"],
            "attainment_pct": r["attainment_pct"], "bound": r["bound"],
            "roofline": r}


def codec_roofline(cfg, n_groups: int, ring: int = 0) -> dict:
    """The codec kernels' byte bounds at `n_groups` (they do no hash
    work): unpack reads the wire at rest and writes the working wire;
    pack reads the working wire and the ring-overflow row and writes the
    wire at rest. {name: {"bytes", "bound_ms"}}."""
    m = _checked(bytemodel.derived_wire_model(cfg, ring))
    words = m["wire_words_derived"] + m["working_words_derived"]
    out = {}
    for name, w in (("wire_unpack", words),
                    ("wire_pack", words + (1 if cfg.pack_ring else 0))):
        b = 4 * w * n_groups
        out[name] = {"bytes": b, "bound_ms": b / (peak_hbm_gbps() * 1e9)
                     * 1e3}
    return out


# ---------------------------------------------------- the run's operations


def run_ops(cfg, g: int, n_ticks: int, st0, st1, committed: int) -> float:
    """Integer operations the counter-based hashes of a run need (a floor
    of the tick's work), counted from the run's own schedules and its
    start and end States: the crash and partition draws once per group
    per epoch (they hash group, node and epoch only), one drop draw per
    link the delivery filter reads (`live_links`), one fire draw per
    group per membership and transfer epoch and one target draw where it
    fires, the deadline draws taken, one payload hash per committed entry
    (fire-hose commands), one arrival draw per client slot per group-tick
    and one value hash per submit pulse (clients), one digest fold per
    applied entry, and the nemesis program's draws (`nem_ops`). The run
    starts at tick 0; `committed` is its committed entries
    (`run.total_rounds`)."""
    k, gid = cfg.k, st0.group_id

    def epochs(epoch):
        return -(-n_ticks // epoch)

    ops = 0.0
    if cfg.crash_u32:
        ops += k * 5 * FOLD_OPS * g * epochs(cfg.crash_epoch)
    if cfg.partition_u32:
        ops += (4 + k * 5) * FOLD_OPS * g * epochs(cfg.partition_epoch)
    if cfg.drop_u32:
        ops += 6 * FOLD_OPS * live_links(cfg, gid, n_ticks)
    for fires, u32, epoch in ((trng.reconfig_fires, cfg.reconfig_u32,
                               cfg.reconfig_epoch),
                              (trng.transfer_fires, cfg.transfer_u32,
                               cfg.transfer_epoch)):
        if u32:
            ep = torch.arange(epochs(epoch), device=gid.device)
            fired = int(fires(cfg.seed, gid[:, None], ep[None, :],
                              u32).sum())
            ops += 4 * FOLD_OPS * (g * epochs(epoch) + fired)
    draws = int((st1.nodes.rng_draws.to(torch.int64)
                 - st0.nodes.rng_draws.to(torch.int64)).sum())
    applied = int((st1.nodes.applied.to(torch.int64)
                   - st0.nodes.applied.to(torch.int64)).clamp(min=0).sum())
    ops += draws * 5 * FOLD_OPS + applied * (2 * MIX_OPS + 4)
    if cfg.cmds_per_tick:
        ops += committed * 5 * FOLD_OPS
    if cfg.clients_u32:
        ops += cfg.client_slots * g * n_ticks * 5 * FOLD_OPS
        ops += submit_pulses(st1.clients) * 5 * FOLD_OPS
    if cfg.nemesis:
        ops += nem_ops(cfg, gid, n_ticks, draws)
    return ops


def nem_ops(cfg, gid, n_ticks: int, draws: int) -> float:
    """The nemesis program's hash work in a run from tick 0: one
    participation draw per clause per group; a link draw on each link a
    link clause hits in a participating group inside its span (and the
    clause's target, site or side draws); per participating group and
    sub-epoch of the span, a crash draw per node (storms), a fire draw
    (disk) and a block draw per node (compaction); one skew draw per
    deadline draw and skew clause."""
    k, g = cfg.k, gid.to(torch.int64)
    ops = len(cfg.nemesis) * g.numel() * 4 * FOLD_OPS
    for c in cfg.nemesis:
        kind, t0, t1, group_u32, _, a, _, cid = c
        part = trng.hash_u32(cfg.seed, rng.TAG_NEM_GROUP, cid, g) < group_u32
        n_part = int(part.sum())
        lo, hi = min(t0, n_ticks), min(t1, n_ticks)
        if kind in rng.NEM_LINK_KINDS:
            # The hit links change per tick (wave), per sub-epoch (flaky
            # bursts) or never (slow follower, WAN sites).
            key = {rng.NEM_SLOW: lambda t: 0, rng.NEM_WAN: lambda t: 0,
                   rng.NEM_FLAKY: lambda t: t // a}.get(kind, lambda t: t)
            memo, hits = {}, 0
            for t in range(lo, hi):
                if key(t) not in memo:
                    memo[key(t)] = int((link_hits(cfg, c, g, t)
                                        & part[:, None, None]).sum())
                hits += memo[key(t)]
            ops += hits * 7 * FOLD_OPS + n_part * k * 6 * FOLD_OPS
        elif kind == rng.NEM_SKEW:
            ops += draws * 5 * FOLD_OPS
        elif hi > lo:
            subs = (hi - 1) // a - lo // a + 1
            per = {rng.NEM_STORM: k * 6, rng.NEM_DISK: 5 + 4,
                   rng.NEM_COMPACT: k * 6}[kind]
            ops += n_part * subs * per * FOLD_OPS
    return ops


def link_hits(cfg, c, g, t):
    """[G, src, dst]: the links (src != dst) one link clause hits at tick
    t, before its per-link draw (the kernel's `nem_links`)."""
    kind, _, _, _, _, a, b, cid = c
    k, seed = cfg.k, cfg.seed
    node = torch.arange(k, device=g.device)
    gg = g[:, None, None]
    src, dst = node[None, :, None], node[None, None, :]
    if kind == rng.NEM_SLOW:
        target = trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg) % k
        hit = (((a & 1) != 0) & (src == target)) | \
            (((a & 2) != 0) & (dst == target))
    elif kind == rng.NEM_FLAKY:
        s0 = trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, 0) % k
        d0 = (s0 + 1 + trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, 1)
              % max(k - 1, 1)) % k
        burst = trng.hash_u32(seed, rng.TAG_NEM_BURST, cid, gg, t // a) < b
        hit = (src == s0) & (dst == d0) & burst & (k > 1)
    elif kind == rng.NEM_WAN:
        hit = (trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, src) % a
               != trng.hash_u32(seed, rng.TAG_NEM_NODE, cid, gg, dst) % a)
    else:   # NEM_WAVE
        wave = (t + gg) % a < b
        hit = wave & ((trng.hash_u32(seed, rng.TAG_NEM_SIDE, cid, gg, t // a,
                                     src) & 1)
                      != (trng.hash_u32(seed, rng.TAG_NEM_SIDE, cid, gg,
                                        t // a, dst) & 1))
    return hit & (src != dst)


def submit_pulses(cl) -> int:
    """The submit pulses phase C consumed in a run from tick 0: every op
    started (done or in flight) and every retry raised a pulse, less the
    pulses the last tick raised for the tick after the run."""
    return int(sum(getattr(cl, f).to(torch.int64).sum()
                   for f in ("done", "inflight", "retries"))
               - cl.submit.to(torch.int64).sum())


def live_links(cfg, gid, n_ticks: int) -> int:
    """The (tick, group, src, dst) with src != dst whose receiver is alive
    and whose link is not cut: the links whose drop draw the delivery
    filter reads. Aliveness and cuts hold for a whole epoch, so each
    (crash epoch, partition epoch) pair is counted once and weighted by
    its ticks."""
    span, first = collections.Counter(), {}
    for t in range(n_ticks):
        key = (t // cfg.crash_epoch, t // cfg.partition_epoch)
        span[key] += 1
        first.setdefault(key, t)
    node = torch.arange(cfg.k, device=gid.device)
    g = gid.to(torch.int64)[:, None, None]
    src, dst = node[None, :, None], node[None, None, :]
    total = 0
    for key, t in first.items():
        alive = trng.node_alive(cfg.seed, g, dst, t, cfg.crash_u32,
                                cfg.crash_epoch)
        cut = trng.link_partitioned(cfg.seed, g, t, src, dst,
                                    cfg.partition_u32, cfg.partition_epoch)
        total += int((alive & ~cut & (src != dst)).sum()) * span[key]
    return total


# --------------------------------------------- the streamed pipeline


def overlap_efficiency(cfg, chunk_ticks: int | None = None,
                       ticks_per_cohort: int | None = None, ring: int = 0,
                       n_devices: int = 1) -> dict:
    """Predicted overlap efficiency of the streamed pipeline
    (parallel/cohort.py): the share of its steady time the launches, not
    the host link, hold the critical path,
    t_compute / max(t_compute, t_copy). t_copy is one window's wire at
    rest crossing the host link twice (in and out); t_compute is
    `ticks_per_cohort` ticks (default one `chunk_ticks` launch) of the
    kernel's per-tick byte bound at the window's groups (the operation
    side would only lengthen it, so the prediction is a floor of the
    overlap). 1.0: the copies hide entirely.

    Over `n_devices` (the JAX package's per-device model) every quantity
    is one device's: its `stream_blocks_per_device` slice of the window
    over its own host link, so copy and compute shrink alike and the
    ratio holds. The model is symmetric, N equal entries; shards that
    share one card share its link, which it does not model, and the
    pipeline's measured per-device split (`cohort.stream_ticks`'
    stats) is what shows a device falling behind."""
    chunk = chunk_ticks or DEFAULT_CHUNK_TICKS
    resident_ticks = ticks_per_cohort or chunk
    bpd = kernel.stream_blocks_per_device(cfg, n_devices)
    dev_groups = bpd * kernel.GB
    wire = _checked(bytemodel.derived_wire_model(cfg, ring))[
        "wire_bytes_derived"]
    window_bytes = wire * dev_groups
    copy_s = 2.0 * window_bytes / (peak_host_gbps() * 1e9)
    hbm_s = (2.0 * window_bytes / chunk) / (peak_hbm_gbps() * 1e9)
    compute_s = resident_ticks * hbm_s
    eff = compute_s / max(compute_s, copy_s) if copy_s > 0 else 1.0
    return {
        "overlap_efficiency_predicted": eff,
        "overlap_efficiency_per_device_predicted": [round(eff, 6)]
        * n_devices,
        "n_devices": n_devices, "blocks_per_device": bpd,
        "window_groups": kernel.window_groups(cfg, n_devices),
        "window_groups_per_device": dev_groups,
        "window_wire_bytes": window_bytes,
        "copy_s_per_window": copy_s, "compute_s_per_window": compute_s,
        "ticks_per_cohort": resident_ticks, "chunk_ticks": chunk,
        "peak_host_gbps": peak_host_gbps(),
        "binding_side": "host-link" if copy_s > compute_s else "compute",
    }


def stream_segment_fields(cfg, measured: float | None = None,
                          chunk_ticks: int | None = None,
                          ticks_per_cohort: int | None = None, ring: int = 0,
                          n_devices: int = 1,
                          per_device_measured: list | None = None,
                          slowest_device=None) -> dict:
    """The stream stamp of a manifest record (`STREAM_KEYS` and
    `STREAM_MESH_KEYS`): the residency dials, the predicted overlap over
    `n_devices` (under `stream_groups` only) and the measured one
    (`measured`, the pipeline's `overlap_efficiency_measured`;
    `per_device_measured` and `slowest_device` from a sharded pipeline's
    stats, one device's being `measured` itself)."""
    vals = {k: getattr(cfg, k) for k in STREAM_FIELDS}
    pred = per_dev = None
    if cfg.stream_groups:
        ov = overlap_efficiency(cfg, chunk_ticks, ticks_per_cohort, ring,
                                n_devices)
        pred = round(ov["overlap_efficiency_predicted"], 6)
        per_dev = ov["overlap_efficiency_per_device_predicted"]
        if n_devices == 1:
            slowest_device = 0
            if per_device_measured is None and measured is not None:
                per_device_measured = [round(measured, 6)]
    vals.update(
        overlap_efficiency_predicted=pred,
        overlap_efficiency_measured=(round(measured, 6)
                                     if measured is not None else None),
        stream_devices=n_devices if cfg.stream_groups else None,
        stream_blocks_per_device=(
            kernel.stream_blocks_per_device(cfg, n_devices)
            if cfg.stream_groups else None),
        overlap_efficiency_per_device_predicted=per_dev,
        overlap_efficiency_per_device_measured=(
            list(per_device_measured) if per_device_measured is not None
            else None),
        stream_slowest_device=(slowest_device if cfg.stream_groups
                               else None))
    if set(vals) != set(STREAM_KEYS) | set(STREAM_MESH_KEYS):
        raise RuntimeError(f"obs.manifest STREAM_KEYS + STREAM_MESH_KEYS "
                           f"drifted from the roofline producer {set(vals)}")
    return vals


def narrow_segment_fields(cfg) -> dict:
    """The narrow stamp of a manifest record (`NARROW_KEYS`): the narrow
    dials and the resident bytes per group they give."""
    vals = {k: getattr(cfg, k) for k in NARROW_FIELDS}
    vals["narrow_resident_bytes_per_group"] = (
        bytemodel.narrow_resident_bytes_per_group(cfg))
    if set(vals) != set(NARROW_KEYS):
        raise RuntimeError(f"obs.manifest NARROW_KEYS drifted from the "
                           f"roofline producer {set(vals)}")
    return vals
