"""The fused-chunk kernel: many whole ticks per launch, each group's
state in shared memory for the whole launch and one lane per Raft node
(csrc/fused_chunk.cu), with the JAX package's
`sim/pkernel.py` API — `kinit` / `kstep` / `kfinish` / `prun`, and
`kcommitted` / `kelections` / `khist` / `kreads` / `kacked` /
`kretries` / `kflight` / `klane` on the wire form — and its packed wire
codec (csrc/wire_codec.cu) and byte model. `krun` is the chunked launch
loop every driver shares: it puts an `obs.trace` chunk span on each
launch and a heartbeat after it (no-ops unless installed); the codec
wrappers put a span on each of their launches, and `prun`, `kinit`,
`kfinish` and `kflight` one on their whole body, with their parts
(`kinit encode`, `kfinish overflow check`, `kfinish decode`, `kstep
alloc`, `kstep launch`) inside.

The wire form is a pair of tensors, `(wire, acc)`:
- `wire`: int32, every State leaf plus the per-group metric lanes
  (committed, leaderless, safety; client_acked and client_retries
  with clients on), structure of arrays with the group axis minor.
  The kernel's working form is `[W, G]` (`_wire_rows`): bools are
  0/1, u32 digests their int32 bit pattern, and the rings and the
  mailbox come last, the region the kernel double-buffers across
  ticks in shared memory. The PreVote, TimeoutNow and session-table
  mailbox slots, the dedup tables and the client state ride the wire
  only when their features are on; the six flight-recorder rings (`[RING]` rows each)
  only when `kinit` was given a Flight.
- `acc`: int32, the `[H]` election-latency histogram, the election
  count and the longest completed streak, then, with clients on, the
  `[H]` ack-latency histogram and the longest ack latency, accumulated
  from zero since `kinit`; `kfinish` folds a caller's base metrics back
  in. Under `wire_hist=False` it holds no `[H]` rows (H = 0), the
  kernel tracks no histogram and `kfinish` passes the caller's through.

Between launches the wire rests in the layout the config's dials give
it (`_layout`, config.LAYOUT_FIELDS). `pack_bools` packs `votes` into
one bit lane per node, `alive_prev` into one word, and every bool
mailbox slot into ceil(n_bool * k / 32) shared words per destination
(bit = field x k + src); `pack_ring` stores `log_term` as 16-bit deltas
two to a word against a per-group base lane whose bit 31 is the sticky
overflow flag (an in-group term spread above 0xFFFF cannot be encoded,
and `kfinish` refuses it). The rows stay structure of arrays. A launch
unpacks the wire into the working form, runs the unchanged tick kernel
on it in place and packs it again (`unpack_wire`, `pack_wire`: the
codec kernels, whose plain versions are `unpack` and `pack`), so the
codec runs only at the launch boundary and the tick kernel never sees
the packed layout. Under `alias_wire` the launch writes its output over
its input wire and accumulators (the caller's input is consumed).

`kinit`/`kfinish` transpose the whole state, so chunked drivers call
them once around the chunk loop, never per chunk. A narrow resident
State (sim/state.py `narrow_spec`) is widened by `kinit` and narrowed
again, latch checked, by `kfinish`.

`kstep` launches the kernels for CUDA tensors; for CPU tensors it runs
the plain version, `kstep_plain` (sim/run.py `run`, or
obs/recorder.py `run_recorded` with a flight, over the same ticks,
through the same wire boundary). There is no fallback from one to the
other. The four protocol features (PreVote, leadership transfer,
membership change, scheduled reads), the scheduled clients and the
nemesis program are compile-time flags of the tick kernel: each flag
set is its own build of the one source (`load`), the all-off build
carrying none of their code. The flight ring is a launch parameter (its
ring length, 0 = off), and so are the histogram size and the nemesis
program's clauses (grouped by seam on the host, `_nem_words`, and
handed to the kernel as a device tensor, `_nem_table`). The kernel
takes k <= `K_LIMIT` and any shape whose group, with the clause table,
fits one block's shared memory (`shared_bytes` <= `SMEM_PER_BLOCK`);
`launch_plan` reports the block shape the launcher picks. The codec is
one flag-free build (`load_codec`). A build runs `nvcc` at first use,
into a directory git ignores, and is bound through ctypes.

The byte model (`hbm_bytes`, `hbm_ceiling_groups`, `host_bytes`,
`cohort_hbm_bytes`, `streamed_ceiling_groups`, `finish_bytes`,
`mesh_hbm_bytes`, `mesh_ceiling_groups`, `supported`) counts the port's
own wire and launch: a launch holds the wire at rest once under
`alias_wire` (else an input and an output copy), plus, when a packing
dial is on, the full-width working wire (the double buffer lives in
shared memory). The budgets are the memory free now,
less a margin, per card: a run sharded over a mesh (`parallel/kmesh.py`,
`parallel/cohort.py`) fits when each card holds every shard placed on it,
and a resident one when its first card also holds the whole fleet's
gather and finish, or, when the run returns shards (`shards_out`), when
each card also holds the finish of its own shards.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.clients.state import (ADMISSION_LEAVES, CLIENT_LEAVES,
                                          ClientState, active_client_leaves)
from raft_tpu_torch.config import CONFIG_FLAG, NARROW_FIELDS, RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.obs import trace
from raft_tpu_torch.obs.recorder import FLIGHT_LEAVES, Flight
from raft_tpu_torch.sim import run as run_mod
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim import streams
from raft_tpu_torch.sim.run import HIST_SIZE, Metrics
from raft_tpu_torch.sim.state import (BOOL, I32, MB_BOOL, MB_CS, MB_FIELDS,
                                      Mailbox, PerNode, State,
                                      mailbox_dtype, mb_fields)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "fused_chunk.cu"
CODEC_SOURCE = CSRC / "wire_codec.cu"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The kernel's compile-time feature flags, in the order of its macros.
FEATURES = ("prevote", "transfer", "reconfig", "reads", "clients",
            "nemesis")
K_LIMIT = 30   # one warp of lanes per group (pkernel.supported's bound)
# Shared memory one block may use on the H100 (232,448 B, the opt-in
# maximum): one group and the clause table must fit it.
SMEM_PER_BLOCK = 232_448
# What the budgets leave free: the card's allocator rounds and splits
# its segments, and the host runs the process around the run.
HBM_MARGIN = 2 * 2 ** 30
HOST_MARGIN = 4 * 2 ** 30
GB = 1024            # groups per block: the unit of a cohort window
# The synthetic rows of the packed layout.
MB_BOOLS_PACKED = "mailbox[bools packed]"
RING_BASE = "log_term[ring base]"

_PEER = ("votes", "next_index", "match_index", "ack_time")
_RING = ("log_term", "log_payload")
_U32_FIELDS = ("snap_digest", "digest", "is_req_snap_digest")
_SESS = ("session_seq", "snap_session_seq")
_CLIENT = tuple("clients." + f for f in CLIENT_LEAVES + ADMISSION_LEAVES)
_CLIENT_LANES = ("client_acked", "client_retries")
_FLIGHT = tuple("flight." + f for f in FLIGHT_LEAVES)
# Wire fields in the order of the kernel's `Field` enum: node leaves
# (rings excluded), alive_prev, group_id, the metric lanes, the rings,
# the mailbox, then the client leaves and the flight rings. A universe's
# wire holds the fields it carries (`wire_fields`), the double-buffered
# region (rings, mailbox) last.
_NODE_STATIC = tuple(f for f in PerNode._fields[:26] if f not in _RING)
_HEAD = (_NODE_STATIC
         + ("alive_prev", "group_id", "committed", "leaderless", "safety")
         + _RING)
WIRE_FIELDS = (_HEAD + MB_FIELDS + MB_CS + _SESS + _CLIENT + _CLIENT_LANES
               + _FLIGHT)
_DB = _RING + MB_FIELDS + MB_CS
_LANES = ("group_id", "committed", "leaderless", "safety") + _CLIENT_LANES


def wire_fields(cfg: RaftConfig, ring: int = 0) -> tuple:
    """The fields a universe's wire carries, in `WIRE_FIELDS` order;
    `ring` is the flight ring's length (0: no flight)."""
    on = _HEAD + mb_fields(cfg)
    if cfg.clients_u32:
        on += (_SESS + tuple("clients." + f for f in active_client_leaves(cfg))
               + _CLIENT_LANES)
    if ring:
        on += _FLIGHT
    return on


def features(cfg: RaftConfig) -> tuple:
    """The kernel's feature flags for a universe, in `FEATURES` order."""
    return (bool(cfg.prevote), cfg.transfer_u32 != 0,
            cfg.reconfig_u32 != 0, cfg.read_every != 0,
            cfg.clients_u32 != 0, len(cfg.nemesis) > 0)


def flag_name(flags: tuple) -> str:
    """A flag set's name: the features it turns on, or "base"."""
    return "+".join(f for f, on in zip(FEATURES, flags) if on) or "base"


def _shape(cfg: RaftConfig, field: str, ring: int = 0) -> tuple:
    """Per-group shape of one field (its trailing dims)."""
    k, s = cfg.k, cfg.client_slots
    if field in _RING:
        return (k, cfg.log_cap)
    if field in _PEER or field in MB_FIELDS:
        return (k, k)
    if field in MB_CS:
        return (k, k, s)
    if field in _SESS:
        return (k, s)
    if field in _CLIENT:
        return (s,)
    if field in _FLIGHT:
        return (ring,)
    if field in _LANES:
        return ()
    return (k,)


def _rows(cfg: RaftConfig, field: str, ring: int = 0) -> int:
    """Wire rows (i32 words per group) of one field."""
    return int(np.prod(_shape(cfg, field, ring), dtype=np.int64))


def _physical(cfg: RaftConfig, ring: int) -> tuple:
    """The carried fields in wire row order: the static region first,
    then the double-buffered one."""
    on = wire_fields(cfg, ring)
    return (tuple(f for f in on if f not in _DB)
            + tuple(f for f in on if f in _DB))


@functools.cache
def _wire_rows(cfg: RaftConfig, ring: int = 0):
    """(offsets, n_words, db_start): each field's first row, in
    WIRE_FIELDS order, -1 for a field the universe does not carry.
    Offsets of the double-buffered fields are relative to `db_start`."""
    at, db_start, first = 0, None, {}
    for f in _physical(cfg, ring):
        if f in _DB and db_start is None:
            db_start = at
        first[f] = at - (db_start or 0)
        at += _rows(cfg, f, ring)
    return [first.get(f, -1) for f in WIRE_FIELDS], at, db_start


def packs(cfg: RaftConfig) -> bool:
    """True iff the wire rests in a packed layout (a packing dial is on)."""
    return bool(cfg.pack_bools or cfg.pack_ring)


def _mb_bools(cfg: RaftConfig) -> tuple:
    """The bool mailbox slots a universe carries, in Mailbox order: the
    shared-lane set of `pack_bools` (bit = field position x k + src)."""
    return tuple(f for f in mb_fields(cfg) if f in MB_BOOL)


def _mb_words(cfg: RaftConfig) -> int:
    """Shared words per destination of the packed bool mailbox slots."""
    return -(-len(_mb_bools(cfg)) * cfg.k // 32)


@functools.cache
def _layout(cfg: RaftConfig, ring: int = 0) -> tuple:
    """(name, rows) of the wire at rest, in row order: the working form's
    fields (`_physical`) with the packing dials' rewrites in place —
    `votes` as k bit lanes and `alive_prev` as one word (`pack_bools`),
    the bool mailbox slots as one shared-lane field at the first one's
    place (`pack_bools`), `log_term` as k * L / 2 words of 16-bit deltas
    followed by the `RING_BASE` lane (`pack_ring`). The same fields as
    the working form with every packing dial off."""
    k, out = cfg.k, []
    bools = set(_mb_bools(cfg)) if cfg.pack_bools else set()
    for f in _physical(cfg, ring):
        if cfg.pack_bools and f == "votes":
            out.append((f, k))
        elif cfg.pack_bools and f == "alive_prev":
            out.append((f, 1))
        elif cfg.pack_ring and f == "log_term":
            out += [(f, k * cfg.log_cap // 2), (RING_BASE, 1)]
        elif f in bools:
            if f == _mb_bools(cfg)[0]:
                out.append((MB_BOOLS_PACKED, _mb_words(cfg) * k))
        else:
            out.append((f, _rows(cfg, f, ring)))
    return tuple(out)


def _starts(layout) -> dict:
    """name -> (first row, rows) of a (name, rows) layout."""
    out, at = {}, 0
    for name, n in layout:
        out[name] = (at, n)
        at += n
    return out


@functools.cache
def _rest_at(cfg: RaftConfig, ring: int = 0) -> dict:
    """Field -> (first row, rows) in the wire at rest."""
    return _starts(_layout(cfg, ring))


@functools.cache
def _work_at(cfg: RaftConfig, ring: int = 0) -> dict:
    """Field -> (first row, rows) in the working wire."""
    return _starts((f, _rows(cfg, f, ring)) for f in _physical(cfg, ring))


def _ring_of(cfg: RaftConfig, wire: torch.Tensor,
             working: bool = False) -> int:
    """The flight ring length a wire at rest (or, `working`, a working
    wire) carries, from its row count."""
    base = (_wire_rows(cfg)[1] if working else wire_words_per_group(cfg))
    extra = wire.shape[0] - base
    if extra < 0 or extra % len(_FLIGHT):
        raise ValueError(f"wire has {wire.shape[0]} rows, the config needs "
                         f"{base} (plus 6 x the flight ring)")
    return extra // len(_FLIGHT)


def _hist_size(cfg: RaftConfig, acc: torch.Tensor) -> int:
    """H of an `acc` of [H] + 2 counters (+ [H] + 1 with clients); 0
    under wire_hist=False."""
    n = acc.shape[0]
    return (n - 3) // 2 if cfg.clients_u32 else n - 2


# -------------------------------------------------------------- byte model


def wire_words_per_group(cfg: RaftConfig, ring: int = 0) -> int:
    """int32 words per group of the wire at rest (`_layout`); `ring` is
    the flight ring's length (0: no flight)."""
    return sum(n for _, n in _layout(cfg, ring))


def working_words_per_group(cfg: RaftConfig, ring: int = 0) -> int:
    """int32 words per group of the full-width working wire."""
    return _wire_rows(cfg, ring)[1]


def shared_words_per_group(cfg: RaftConfig) -> int:
    """int32 words of shared memory per group (the kernel's `Args::gs`):
    the static rows (the flight rows stay in device memory) and the
    double-buffered rows twice, each from an even word, and the nemesis
    participation words, padded to twice an odd number."""
    _, n_words, db_start = _wire_rows(cfg)
    part = -(-len(cfg.nemesis) // 32)

    def even(x):
        return x + (x & 1)

    words = even(even(db_start) + 2 * even(n_words - db_start) + part)
    return words + 2 if words % 4 == 0 else words


def shared_bytes(cfg: RaftConfig) -> int:
    """Shared bytes of the smallest block: one group and the clause
    table (eight words a clause)."""
    return 4 * (shared_words_per_group(cfg) + 8 * len(cfg.nemesis))


def acc_words(cfg: RaftConfig, hist: int = HIST_SIZE) -> int:
    """int32 words of `acc` for histograms of `hist` buckets."""
    h = hist if cfg.wire_hist else 0
    return h + 2 + (h + 1 if cfg.clients_u32 else 0)


def _residency(cfg: RaftConfig) -> int:
    """Copies of the wire at rest across a launch: 1 under alias_wire
    (the output is written over the input), else 2."""
    return 1 if cfg.alias_wire else 2


def launch_words_per_group(cfg: RaftConfig, ring: int = 0) -> int:
    """int32 words per group on the card during one `kstep`: the wire at
    rest x `_residency`, plus the full-width working wire when a packing
    dial is on (unpacked, the working wire is the output itself)."""
    if packs(cfg):
        return (_residency(cfg) * wire_words_per_group(cfg, ring)
                + working_words_per_group(cfg, ring))
    return _residency(cfg) * working_words_per_group(cfg, ring)


def hbm_bytes(cfg: RaftConfig, n_groups: int, ring: int = 0) -> int:
    """Peak device bytes of one `kstep` over `n_groups` groups, its input
    included: `launch_words_per_group` per group and the accumulators
    (written over under alias_wire, else copied). Sharded, by device:
    `mesh_hbm_bytes`."""
    return 4 * (launch_words_per_group(cfg, ring) * n_groups
                + _residency(cfg) * acc_words(cfg))


def hbm_budget(device=None) -> int:
    """Device bytes a run may still take: the card's free memory
    (`torch.cuda.mem_get_info`) plus what PyTorch's allocator holds
    unused, less `HBM_MARGIN` (2 GiB) for the allocator's rounding and
    fragmentation."""
    free = torch.cuda.mem_get_info(device)[0]
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return max(0, int(free + cached) - HBM_MARGIN)


def host_budget() -> int:
    """Host bytes a run may still take: `/proc/meminfo` MemAvailable less
    `HOST_MARGIN` (4 GiB) for the process around the run."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return max(0, int(line.split()[1]) * 1024 - HOST_MARGIN)
    raise RuntimeError("/proc/meminfo has no MemAvailable line")


def hbm_ceiling_groups(cfg: RaftConfig, ring: int = 0,
                       hbm: int | None = None) -> int:
    """The most groups one resident `kstep` fits in `hbm` bytes (default:
    `hbm_budget()`): the exact boundary of `hbm_bytes`. A sharded run's
    is `mesh_ceiling_groups`."""
    budget = hbm_budget() if hbm is None else hbm
    spare = budget - 4 * _residency(cfg) * acc_words(cfg)
    return max(0, spare // (4 * launch_words_per_group(cfg, ring)))


@functools.cache
def state_bytes_per_group(cfg: RaftConfig, ring: int = 0) -> int:
    """Bytes of one group's State (narrow under the narrow dials), its
    per-group metric lanes and its flight rows, as `prun_streamed` takes
    and returns them."""
    st = state_mod.init(cfg, 1, device="cpu")   # narrow when its dials are
    leaves = []
    state_mod._map_named(st, "", lambda _, a: leaves.append(a))
    return (sum(a.numel() * a.element_size() for a in leaves)
            + 4 * _lanes(cfg) + 4 * len(_FLIGHT) * ring)


def _lanes(cfg: RaftConfig) -> int:
    """The per-group metric lanes: committed, leaderless, safety (and
    client_acked, client_retries with clients)."""
    return 5 if cfg.clients_u32 else 3


def finish_bytes(cfg: RaftConfig, n_groups: int, ring: int = 0) -> int:
    """Peak device bytes of `kfinish` and `kflight` of a wire pair of
    `n_groups` groups, the pair included: the wire at rest and `acc`, the
    working wire `unpack_wire` makes beside them under a packing dial,
    and what the decode holds at once: the wide State, the metric lanes
    and the flight rows (`state_bytes_per_group` of the wide config),
    under the narrow dials the narrow State beside them (counted whole,
    a bound: the leaves it keeps wide are shared), and the fleet-wide
    metrics."""
    per = (4 * wire_words_per_group(cfg, ring)
           + (4 * working_words_per_group(cfg, ring) if packs(cfg) else 0)
           + state_bytes_per_group(_wide(cfg), ring))
    if state_mod.narrow_active(cfg):
        per += state_bytes_per_group(cfg) - 4 * _lanes(cfg)
    fleet = acc_words(dataclasses.replace(cfg, wire_hist=True))
    return per * n_groups + 4 * (acc_words(cfg) + fleet)


def host_bytes(cfg: RaftConfig, n_groups: int, ring: int = 0,
               state_on_host: bool = True) -> int:
    """Host bytes of a streamed run: the pinned copy of the fleet's wire
    at rest and, when the State lies on the host, the input State and
    the gathered output."""
    per = 4 * wire_words_per_group(cfg, ring)
    if state_on_host:
        per += 2 * state_bytes_per_group(cfg, ring)
    return per * n_groups


def stream_blocks_per_device(cfg: RaftConfig, n_devices: int = 1) -> int:
    """Whole blocks of one cohort window that land on each of `n_devices`
    devices: `cohort_blocks` split over them, rounded up (the JAX
    package's `pkernel.stream_blocks_per_device`)."""
    return -(-cfg.cohort_blocks // n_devices)


def window_groups(cfg: RaftConfig, n_devices: int = 1) -> int:
    """Groups of one cohort window: `cohort_blocks` blocks of `GB`; over
    `n_devices`, `stream_blocks_per_device` blocks for each."""
    return stream_blocks_per_device(cfg, n_devices) * n_devices * GB


def window_slices(s0: int, s1: int, n_devices: int) -> list:
    """[(j, lo, hi), ...]: device j's groups of the window [s0, s1),
    relative to the window: ceil((s1 - s0) / (n_devices x GB)) whole
    blocks each, in device order, the last clipped to the window; a
    device left with none is not listed (the JAX package pads the tail
    window to whole blocks on every device and drops nothing but pad)."""
    n = s1 - s0
    per = -(-n // (n_devices * GB)) * GB
    return [(j, j * per, min((j + 1) * per, n)) for j in range(n_devices)
            if j * per < n]


def _stream_windows(cfg: RaftConfig) -> int:
    """Windows at rest on the card in the streamed pipeline at its peak:
    the previous one awaiting its copy back, the next one prefetched,
    and the current one under the launch (x `_residency`)."""
    return 2 + _residency(cfg)


def cohort_hbm_bytes(cfg: RaftConfig, ring: int = 0,
                     n_devices: int = 1) -> int:
    """Peak device bytes of the streamed pipeline: the previous and the
    next window at rest beside the current window's launch
    (`hbm_bytes`), O(cohort_blocks) whatever the fleet's size. Over
    `n_devices`, one device's pipeline of its window slices
    (`stream_blocks_per_device` blocks)."""
    win = stream_blocks_per_device(cfg, n_devices) * GB
    return (4 * (_stream_windows(cfg) - _residency(cfg))
            * wire_words_per_group(cfg, ring) * win
            + hbm_bytes(cfg, win, ring))


def streamed_ceiling_groups(cfg: RaftConfig, ring: int = 0,
                            hbm: int | None = None,
                            host: int | None = None,
                            state_on_host: bool = True,
                            n_devices: int = 1) -> int:
    """The most groups a streamed run fits: `host_bytes` per group in
    `host` bytes (default: `host_budget()`), in whole blocks; 0 when one
    device's window pipeline (over `n_devices` cards, each its own) does
    not fit `hbm` (default: `hbm_budget()`). One process on one host
    keeps the whole fleet's wire, so more cards do not raise it."""
    hbm = hbm_budget() if hbm is None else hbm
    host = host_budget() if host is None else host
    if cohort_hbm_bytes(cfg, ring, n_devices) > hbm:
        return 0
    return host // (host_bytes(cfg, GB, ring, state_on_host)) * GB


def shape_supported(cfg: RaftConfig) -> bool:
    """True iff the kernel takes the config's shape: k <= K_LIMIT and one
    group with the clause table in one block's shared memory
    (`shared_bytes(cfg) <= SMEM_PER_BLOCK`)."""
    return cfg.k <= K_LIMIT and shared_bytes(cfg) <= SMEM_PER_BLOCK


def _device(d) -> torch.device:
    """A mesh entry as a device; a CUDA device without an index names the
    current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def mesh_hbm_bytes(cfg: RaftConfig, n_groups: int, mesh,
                   ring: int = 0, shards_out: bool = False) -> dict:
    """{device: bytes} of a run sharded over `mesh` (a sequence of
    devices, which may repeat). Under `stream_groups`, on each device the
    sum over the shards it holds of each shard's window pipeline
    (`cohort_hbm_bytes` over the mesh). Resident (`parallel.kmesh`
    `prun_sharded`), on each device the sum of the launches (`hbm_bytes`
    of each span, `parallel.groups.spans`) of the shards it holds, and
    the larger of that and the run's end. A run that gathers ends on the
    first device with the gather (`kmesh.gather`: the whole wire pair
    beside the wire pairs of the shards that device holds, and the copy
    of the largest shard another device holds; none for one shard) and
    then, the shards dropped, `finish_bytes` of the whole fleet. A run
    that returns shards (`shards_out`) ends on each device with the
    `finish_bytes` of each shard it holds (a bound: a shard's pair goes
    once it is decoded), and on the first device also with
    `fleet_metrics_bytes`."""
    from raft_tpu_torch.parallel.groups import spans
    if cfg.stream_groups:
        first = min(n_groups, window_groups(cfg, len(mesh)))
        held = [j for j, _, _ in window_slices(0, first, len(mesh))]
        each = [cohort_hbm_bytes(cfg, ring, len(mesh))] * len(held)
    else:
        parts = spans(n_groups, len(mesh))
        held = range(len(parts))
        each = [hbm_bytes(cfg, s1 - s0, ring) for s0, s1 in parts]
    need = {}
    for j, b in zip(held, each):
        d = _device(mesh[j])
        need[d] = need.get(d, 0) + b
    if cfg.stream_groups:
        return need
    first = _device(mesh[0])
    if shards_out:
        end = {first: fleet_metrics_bytes(cfg, n_groups, len(parts))}
        for j, (s0, s1) in zip(held, parts):
            d = _device(mesh[j])
            end[d] = end.get(d, 0) + finish_bytes(cfg, s1 - s0, ring)
        return {d: max(b, end[d]) for d, b in need.items()}
    rest, pair = 4 * wire_words_per_group(cfg, ring), 4 * acc_words(cfg)
    gather = 0
    if len(parts) > 1:
        here = [_device(mesh[j]) == first for j in held]
        gather = rest * n_groups + pair + sum(
            rest * (s1 - s0) + pair
            for (s0, s1), h in zip(parts, here) if h) + rest * max(
            (s1 - s0 for (s0, s1), h in zip(parts, here) if not h),
            default=0)
    need[first] = max(need[first], gather,
                      finish_bytes(cfg, n_groups, ring))
    return need


def fleet_metrics_bytes(cfg: RaftConfig, n_groups: int,
                        n_shards: int) -> int:
    """Device bytes of a shards-out finish's fleet-wide Metrics on the
    first device: the per-group lanes twice (each shard's copied there,
    then joined) and the shards' accumulators stacked beside their
    reduction (`kmesh.reduce_acc`)."""
    return 4 * (2 * _lanes(cfg) * n_groups
                + (n_shards + 1) * acc_words(cfg))


def mesh_ceiling_groups(cfg: RaftConfig, mesh, ring: int = 0,
                        hbm: int | None = None,
                        shards_out: bool = False) -> int:
    """The most groups a resident run sharded over `mesh` fits with every
    device's `mesh_hbm_bytes` in `hbm` bytes (default: `hbm_budget()` of
    the current card, for each device): the exact boundary of
    `supported(mesh=...)`. At most len(mesh) x `hbm_ceiling_groups` (the
    launches alone, one shard a card); a run that gathers is brought
    down by the first device's gather and finish, which hold the whole
    fleet, one that returns shards (`shards_out`) by each card's finish
    of its own shards."""
    budget = hbm_budget() if hbm is None else hbm
    lo, hi = 0, len(mesh) * hbm_ceiling_groups(cfg, ring, budget)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if max(mesh_hbm_bytes(cfg, mid, mesh, ring,
                              shards_out).values()) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def supported(cfg: RaftConfig, n_groups: int | None = None, ring: int = 0,
              hbm: int | None = None, host: int | None = None,
              state_on_host: bool = True, mesh=None,
              shards_out: bool = False) -> bool:
    """True iff the kernel takes the config (`shape_supported`) and, with
    `n_groups`, the run fits: resident, one launch in `hbm` bytes; under
    `stream_groups`, one window's pipeline in `hbm` and the run's host
    copies (`host_bytes`) in `host` bytes (defaults: `hbm_budget()` of
    the card, `host_budget()`). Sharded over `mesh`, every card holds
    the shards placed on it (`mesh_hbm_bytes`, summed over shards that
    share it) within its budget: two shards on one card share that
    card's `hbm`, they are not each granted it; resident, the first card
    also holds the whole fleet's gather and finish, or with `shards_out`
    each card the finish of its own shards. A CPU device of a mesh is
    budgeted only against an `hbm` given."""
    if not shape_supported(cfg):
        return False
    if n_groups is None:
        return True
    if cfg.stream_groups:
        host = host_budget() if host is None else host
        if host_bytes(cfg, n_groups, ring, state_on_host) > host:
            return False
    if mesh is None:
        hbm = hbm_budget() if hbm is None else hbm
        return (cohort_hbm_bytes(cfg, ring) if cfg.stream_groups
                else hbm_bytes(cfg, n_groups, ring)) <= hbm
    return all(need <= (hbm_budget(d) if hbm is None else hbm)
               for d, need in mesh_hbm_bytes(cfg, n_groups, mesh, ring,
                                             shards_out).items()
               if hbm is not None or d.type == "cuda")


def shape_refusal(cfg: RaftConfig) -> str:
    """Why the kernel refuses a config's shape (`shape_supported`)."""
    return (f"the kernel takes k <= {K_LIMIT} and a group whose shared "
            f"memory, with the nemesis clause table, fits one block's "
            f"{SMEM_PER_BLOCK} B; k={cfg.k}, log_cap={cfg.log_cap} and "
            f"{len(cfg.nemesis)} nemesis clauses need "
            f"{shared_bytes(cfg)} B")


# --------------------------------------------------------------- wire form


def _to_i32(a: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.int64:   # u32 in int64 -> its int32 bit pattern
        a = torch.where(a >= 2 ** 31, a - 2 ** 32, a)
    return a.to(I32)


def _from_i32(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == BOOL:
        return a != 0
    if dtype == torch.int64:
        return a.to(torch.int64) & 0xFFFFFFFF
    return a.clone()


def _encode(cfg: RaftConfig, st: State, m: Metrics,
            flight: Flight | None = None):
    """(State, Metrics[, Flight]) -> the working wire and `acc`."""
    g = st.alive_prev.shape[0]
    leaves = st.nodes._asdict()
    leaves.update(st.mailbox._asdict())
    leaves.update(alive_prev=st.alive_prev, group_id=st.group_id,
                  committed=m.committed, leaderless=m.leaderless,
                  safety=m.safety)
    hist = cfg.wire_hist
    acc = ([m.hist] if hist else []) + [m.elections.reshape(1),
                                        m.max_latency.reshape(1)]
    if cfg.clients_u32:
        leaves.update({"clients." + f: v
                       for f, v in st.clients._asdict().items()})
        leaves.update(client_acked=m.client_acked,
                      client_retries=m.client_retries)
        acc += ([m.client_hist] if hist else []) + [
            m.client_max_lat.reshape(1)]
    ring = 0
    if flight is not None:
        ring = flight.tick.shape[0]
        leaves.update({"flight." + f: v.T for f, v in
                       flight._asdict().items()})
    wire = torch.cat([_to_i32(leaves[f]).reshape(g, -1).T
                      for f in _physical(cfg, ring)]).contiguous()
    return wire, torch.cat(acc).to(I32)


def _acc_metrics(cfg: RaftConfig, lanes: dict, acc: torch.Tensor) -> Metrics:
    """Metrics of the per-group `lanes` (committed, leaderless, safety,
    and the client lanes with clients; `[G]` each) and an `acc`, the
    metrics as accumulated. Under wire_hist=False the histograms are
    zeros of `HIST_SIZE` (nothing was tracked)."""
    h = _hist_size(cfg, acc)

    def rows(at):
        if h:
            return acc[at:at + h].clone()
        return torch.zeros(HIST_SIZE, dtype=I32, device=acc.device)

    cl = {}
    if cfg.clients_u32:
        cl = dict(client_acked=lanes["client_acked"],
                  client_retries=lanes["client_retries"],
                  client_hist=rows(h + 2),
                  client_max_lat=acc[2 * h + 2].clone())
    return Metrics(committed=lanes["committed"],
                   leaderless=lanes["leaderless"],
                   elections=acc[h].clone(), hist=rows(0),
                   max_latency=acc[h + 1].clone(), safety=lanes["safety"],
                   **cl)


def _decode(cfg: RaftConfig, wire: torch.Tensor, acc: torch.Tensor):
    """(State, Metrics, Flight or None) of a working wire and its `acc`,
    the metrics as accumulated on them. Under wire_hist=False the
    histograms are zeros of `HIST_SIZE` (nothing was tracked)."""
    g, ring = wire.shape[1], _ring_of(cfg, wire, working=True)
    vals, at = {}, 0
    for f in _physical(cfg, ring):
        n = _rows(cfg, f, ring)
        vals[f] = wire[at:at + n].T.reshape((g,) + _shape(cfg, f, ring))
        at += n
    node_dt = {f: (torch.int64 if f in _U32_FIELDS
                   else BOOL if f == "votes" else I32)
               for f in PerNode._fields}
    nodes = PerNode(**{f: _from_i32(vals[f], node_dt[f])
                       for f in PerNode._fields if f in vals})
    mailbox = Mailbox(**{f: _from_i32(vals[f], mailbox_dtype(f))
                         for f in mb_fields(cfg)})
    clients = None
    if cfg.clients_u32:
        clients = ClientState(**{f: vals["clients." + f].clone()
                                 for f in active_client_leaves(cfg)})
    st = State(nodes=nodes, mailbox=mailbox,
               alive_prev=vals["alive_prev"] != 0,
               group_id=vals["group_id"].clone(), clients=clients)
    met = _acc_metrics(cfg, {f: vals[f].clone() for f in _LANES[1:]
                             if f in vals}, acc)
    flight = None
    if ring:
        flight = Flight(*(vals["flight." + f].T.contiguous()
                          for f in FLIGHT_LEAVES))
    return st, met, flight


# ----------------------------------------------------------- wire codec


def ring_base_ov(log_term: torch.Tensor):
    """(base, overflow) of the ring-delta encoding, from `log_term`'s
    `[K * L, G]` working rows: the per-group min term over the ring, and
    True where the spread above it exceeds the 16-bit half-lane (the
    encoding would wrap, so `kfinish` refuses the flag)."""
    base = log_term.amin(dim=0)
    spread = log_term.amax(dim=0).to(torch.int64) - base.to(torch.int64)
    return base, spread > 0xFFFF


def ring_flags(cfg: RaftConfig, wire: torch.Tensor) -> torch.Tensor:
    """int32[G]: the sticky ring-overflow flag (bit 31 of `RING_BASE`)
    of a wire at rest under `pack_ring`."""
    at, _ = _rest_at(cfg, _ring_of(cfg, wire))[RING_BASE]
    return (wire[at] >> 31) & 1


def _bits(v: torch.Tensor) -> torch.Tensor:
    """0/1 words `v[b, ...]` -> the int64 word with bit b = v[b]."""
    shift = torch.arange(v.shape[0], device=v.device).reshape(
        (-1,) + (1,) * (v.dim() - 1))
    return ((v.to(torch.int64) & 1) << shift).sum(dim=0)


def _unbits(w: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words `w[..., G]` -> their low n bits, `[..., n, G]`."""
    shift = torch.arange(n, dtype=I32, device=w.device).reshape(n, 1)
    return (w.unsqueeze(-2) >> shift) & 1


def pack(cfg: RaftConfig, wire: torch.Tensor,
         ring_ov: torch.Tensor | None = None) -> torch.Tensor:
    """The pack kernel's plain version (the JAX package's `_pack_wire`):
    a working wire `[W, G]` -> the wire at rest `[P, G]`. The ring base
    is the per-group min term over the `[K, L]` ring, its flag the
    spread above 0xFFFF ORed with `ring_ov` (int32[G], the flags the
    wire came in with; None for a fresh encode). Identity when no
    packing dial is on."""
    if not packs(cfg):
        return wire
    ring = _ring_of(cfg, wire, working=True)
    at = _work_at(cfg, ring)
    k, g = cfg.k, wire.shape[1]

    def rows(f):
        s, n = at[f]
        return wire[s:s + n]

    parts = []
    for name, n in _layout(cfg, ring):
        if name == MB_BOOLS_PACKED:
            v = torch.stack([rows(f).reshape(k, k, g)
                             for f in _mb_bools(cfg)])   # [field, dst, src]
            v = v.permute(1, 0, 2, 3).reshape(k, -1, g)  # bit field x k + src
            w = _mb_words(cfg)
            v = torch.cat([v, v.new_zeros(k, 32 * w - v.shape[1], g)], 1)
            parts.append(_to_i32(_bits(v.reshape(k, w, 32, g)
                                       .permute(2, 0, 1, 3))
                                 .reshape(k * w, g)))
        elif name == RING_BASE:
            base, ov = ring_base_ov(rows("log_term"))
            if ring_ov is not None:
                ov = ov | (ring_ov != 0)
            parts.append(_to_i32(base.to(torch.int64)
                                 | (ov.to(torch.int64) << 31))[None])
        elif cfg.pack_ring and name == "log_term":
            lt = rows("log_term").to(torch.int64)
            d = ((lt - lt.amin(dim=0)) & 0xFFFF).reshape(-1, 2, g)
            parts.append(_to_i32(d[:, 0] | (d[:, 1] << 16)))
        elif cfg.pack_bools and name == "votes":
            parts.append(_to_i32(_bits(rows(name).reshape(k, k, g)
                                       .transpose(0, 1))))
        elif cfg.pack_bools and name == "alive_prev":
            parts.append(_to_i32(_bits(rows(name)))[None])
        else:
            parts.append(rows(name))
    return torch.cat(parts)


def unpack(cfg: RaftConfig, packed: torch.Tensor):
    """The unpack kernel's plain version (the JAX package's
    `_unpack_wire`): a wire at rest -> (the working wire, the sticky
    ring-overflow flags as int32[G], or None without `pack_ring`). The
    exact inverse of `pack` for every encoding whose flag is clear.
    Identity when no packing dial is on."""
    if not packs(cfg):
        return packed, None
    ring = _ring_of(cfg, packed)
    rest = _rest_at(cfg, ring)
    k, g = cfg.k, packed.shape[1]

    def rows(name):
        s, n = rest[name]
        return packed[s:s + n]

    fields, ov = {}, None
    if cfg.pack_bools:
        fields["votes"] = _unbits(rows("votes"), k).reshape(k * k, g)
        fields["alive_prev"] = _unbits(rows("alive_prev")[0], k)
        bools = _mb_bools(cfg)
        pm = rows(MB_BOOLS_PACKED).reshape(k, _mb_words(cfg), g)
        b = _unbits(pm, 32).reshape(k, -1, g)[:, :len(bools) * k]
        b = b.reshape(k, len(bools), k, g)               # [dst, field, src]
        for fi, f in enumerate(bools):
            fields[f] = b[:, fi].reshape(k * k, g)
    if cfg.pack_ring:
        bl = rows(RING_BASE)[0]
        ov = (bl >> 31) & 1
        base = (bl & 0x7FFFFFFF).to(torch.int64)
        pk = rows("log_term")
        d = torch.stack([pk & 0xFFFF, (pk >> 16) & 0xFFFF], 1)
        fields["log_term"] = _to_i32(
            (base + d.reshape(-1, g).to(torch.int64)) & 0xFFFFFFFF)
    return torch.cat([fields[f] if f in fields else rows(f)
                      for f in _physical(cfg, ring)]), ov


@functools.cache
def _codec_plan(cfg: RaftConfig, ring: int) -> np.ndarray:
    """The layout as the codec kernels take it (int32): k, L, the
    working and at-rest rows of votes, alive_prev, log_term and its base
    (-1 where a dial leaves them as they are), the shared bool rows, the
    words per destination, the bool slots' working rows, then the runs
    of rows copied as they are (working row, at-rest row, rows)."""
    work, rest = _work_at(cfg, ring), _rest_at(cfg, ring)
    bools = _mb_bools(cfg) if cfg.pack_bools else ()

    def pair(f, on, name=None):
        return [work[f][0], rest[name or f][0]] if on else [-1, -1]

    plan = [cfg.k, cfg.log_cap]
    plan += pair("votes", cfg.pack_bools) + pair("alive_prev",
                                                 cfg.pack_bools)
    plan += pair("log_term", cfg.pack_ring)
    plan += [rest[RING_BASE][0] if cfg.pack_ring else -1]
    plan += [rest[MB_BOOLS_PACKED][0] if bools else -1,
             _mb_words(cfg) if bools else 0, len(bools)]
    plan += [work[f][0] for f in bools]
    runs = []
    rewritten = {"votes", "alive_prev"} if cfg.pack_bools else set()
    rewritten |= {"log_term"} if cfg.pack_ring else set()
    for name, (r, n) in rest.items():
        if name not in work or name in rewritten or name in bools:
            continue
        w = work[name][0]
        if runs and runs[-1][0] + runs[-1][2] == w \
                and runs[-1][1] + runs[-1][2] == r:
            runs[-1][2] += n
        else:
            runs.append([w, r, n])
    plan += [len(runs)] + [x for run in runs for x in run]
    return np.array(plan, dtype=np.int32)


def _codec_check(name: str, a: torch.Tensor, rows: int, g: int):
    if a.dtype != I32 or a.dim() != 2 or not a.is_contiguous() \
            or a.shape != (rows, g):
        raise ValueError(f"{name} must be a contiguous int32 [{rows}, {g}] "
                         f"tensor, not {a.dtype} {tuple(a.shape)}")


def unpack_wire(cfg: RaftConfig, packed: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The unpack kernel's wrapper: a wire at rest -> the working wire,
    written into `out` (allocated when None). CUDA tensors launch the
    kernel on their device's current stream, with that device current
    (counted in `unpack_wire.launches`);
    CPU tensors run `unpack`. Identity when no packing dial is on."""
    if not packs(cfg):
        return packed
    g, ring = packed.shape[1], _ring_of(cfg, packed)
    n_work = working_words_per_group(cfg, ring)
    if packed.device.type == "cpu":
        work, _ = unpack(cfg, packed)
        return work if out is None else out.copy_(work)
    if out is None:
        out = torch.empty((n_work, g), dtype=I32, device=packed.device)
    _codec_check("the wire at rest", packed, wire_words_per_group(cfg, ring),
                 g)
    _codec_check("the working wire", out, n_work, g)
    plan = _codec_plan(cfg, ring)
    with trace.launch_span("wire_unpack cuda", packed.device, groups=g), \
            torch.cuda.device(packed.device):
        rc = load_codec().wire_unpack_launch(
            packed.data_ptr(), out.data_ptr(), plan.ctypes.data, len(plan),
            g, torch.cuda.current_stream(packed.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wire_unpack launch failed: error {rc}")
    unpack_wire.launches += 1
    return out


unpack_wire.launches = 0


def pack_wire(cfg: RaftConfig, wire: torch.Tensor,
              flags_from: torch.Tensor | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The pack kernel's wrapper: a working wire -> the wire at rest,
    written into `out` (allocated when None). `flags_from` is a wire at
    rest whose sticky ring-overflow flags are ORed in (kstep's input; it
    may be `out` itself). CUDA tensors launch the kernel on their
    device's current stream, with that device current (counted in
    `pack_wire.launches`); CPU tensors run `pack`.
    Identity when no packing dial is on."""
    if not packs(cfg):
        return wire
    g, ring = wire.shape[1], _ring_of(cfg, wire, working=True)
    n_rest = wire_words_per_group(cfg, ring)
    flagged = flags_from is not None and cfg.pack_ring
    if wire.device.type == "cpu":
        ov = ring_flags(cfg, flags_from) if flagged else None
        packed = pack(cfg, wire, ov)
        return packed if out is None else out.copy_(packed)
    if out is None:
        out = torch.empty((n_rest, g), dtype=I32, device=wire.device)
    _codec_check("the working wire", wire, working_words_per_group(cfg, ring),
                 g)
    _codec_check("the wire at rest", out, n_rest, g)
    flags = None
    if flagged:
        _codec_check("the flags' wire", flags_from, n_rest, g)
        # the RING_BASE row: bit 31 of each word is a group's flag
        flags = flags_from[_rest_at(cfg, ring)[RING_BASE][0]].data_ptr()
    plan = _codec_plan(cfg, ring)
    with trace.launch_span("wire_pack cuda", wire.device, groups=g), \
            torch.cuda.device(wire.device):
        rc = load_codec().wire_pack_launch(
            wire.data_ptr(), out.data_ptr(), flags, plan.ctypes.data,
            len(plan), g, torch.cuda.current_stream(wire.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wire_pack launch failed: error {rc}")
    pack_wire.launches += 1
    return out


pack_wire.launches = 0


def check_ring_overflow(cfg: RaftConfig, wire: torch.Tensor) -> None:
    """The host-side refusal of a set ring-overflow flag: an in-group term
    spread >= 2^16 cannot be 16-bit delta-encoded, and wrong terms must
    never leave kfinish."""
    if not cfg.pack_ring:
        return
    n = int(ring_flags(cfg, wire).sum())  # sync-ok: kfinish's refusal
    if n:
        raise ValueError(
            f"pack_ring: ring-term delta overflowed the 16-bit half-lane "
            f"in {n} group(s) (in-group term spread >= 2^16) — state "
            f"cannot be decoded; re-run with pack_ring=False")


# ---------------------------------------------------------- entry points


@trace.spanned("kinit")
def kinit(cfg: RaftConfig, st: State, metrics: Metrics | None = None,
          flight: Flight | None = None):
    """(State, Metrics[, Flight]) -> the wire form at rest, once per run.
    Returns (leaves, g). committed/leaderless/safety (and the client
    lanes) continue in place on the wire; the histograms, the election
    count and the longest streak and ack latency start from zero
    (kfinish folds `metrics_base` back in). A narrow State is widened.
    A `flight` (obs/recorder.py `flight_init`) turns the in-kernel
    flight ring on; `kflight` reads it back."""
    st = state_mod.widen_state(cfg, st)
    g = st.alive_prev.shape[0]
    dev = st.alive_prev.device
    clients = cfg.clients_u32 != 0
    if metrics is None:
        metrics = run_mod.metrics_init(g, clients=clients, device=dev)
    base = run_mod.metrics_init(g, hist_size=metrics.hist.shape[0],
                                clients=clients, device=dev)
    m = base._replace(committed=metrics.committed,
                      leaderless=metrics.leaderless, safety=metrics.safety)
    if clients and metrics.client_acked is not None:
        m = m._replace(client_acked=metrics.client_acked,
                       client_retries=metrics.client_retries)
    with trace.span("kinit encode"):
        wire, acc = _encode(cfg, st, m, flight)
    return (pack_wire(cfg, wire), acc), g


@trace.spanned("kfinish")
def kfinish(cfg: RaftConfig, leaves, g: int,
            metrics_base: Metrics | None = None):
    """Wire form -> (State, Metrics), folding `metrics_base`'s election
    count, longest streak and histograms into the accumulated ones
    (under wire_hist=False its histograms pass through unchanged).
    Refuses a set ring-overflow flag and a latched narrow state; a
    narrow config's State comes back narrow. The flight rings, when
    present, are read with `kflight`."""
    wire, acc = leaves
    with trace.span("kfinish overflow check"):
        check_ring_overflow(cfg, wire)
    work = unpack_wire(cfg, wire)
    with trace.span("kfinish decode"):
        st, m, _ = _decode(cfg, work, acc)
        if state_mod.narrow_active(cfg):
            st = state_mod.narrow_state(cfg, st)
            state_mod.check_narrow_overflow(cfg, st)
        return st, _fold_base(cfg, m, metrics_base)


def kmetrics(cfg: RaftConfig, lanes: dict, acc: torch.Tensor,
             metrics_base: Metrics | None = None) -> Metrics:
    """`kfinish`'s Metrics from the per-group `lanes` (committed,
    leaderless, safety and, with clients, the client lanes; `[G]` each)
    and an `acc`: what a sharded run's shards-out finish
    (`parallel/kmesh.py`) gives with its shards' lanes joined and their
    accumulators reduced."""
    return _fold_base(cfg, _acc_metrics(cfg, lanes, acc), metrics_base)


def _fold_base(cfg: RaftConfig, m: Metrics,
               metrics_base: Metrics | None) -> Metrics:
    """`m` with `metrics_base`'s election count, longest streak and
    histograms folded in (under wire_hist=False its histograms pass
    through unchanged)."""
    if metrics_base is not None:
        hist = (m.hist + metrics_base.hist if cfg.wire_hist
                else metrics_base.hist)
        m = m._replace(
            elections=m.elections + metrics_base.elections, hist=hist,
            max_latency=torch.maximum(m.max_latency,
                                      metrics_base.max_latency))
        if cfg.clients_u32 and metrics_base.client_hist is not None:
            chist = (m.client_hist + metrics_base.client_hist
                     if cfg.wire_hist else metrics_base.client_hist)
            m = m._replace(
                client_hist=chist,
                client_max_lat=torch.maximum(m.client_max_lat,
                                             metrics_base.client_max_lat))
    return m


@trace.spanned("kflight")
def kflight(cfg: RaftConfig, leaves, g: int) -> Flight | None:
    """The Flight on the wire, or None when kinit ran without one."""
    wire = leaves[0]
    ring = _ring_of(cfg, wire)
    if not ring:
        return None
    rest = _rest_at(cfg, ring)
    return Flight(*(wire[rest[f][0]:rest[f][0] + ring].clone()
                    for f in _FLIGHT))


def klane(cfg: RaftConfig, leaves, g: int, field: str) -> torch.Tensor:
    """One field's rows of the wire at rest over the first g groups
    (`[rows, g]`, int32, a view): a metric lane such as "leaderless" or
    "safety" is one row."""
    wire = leaves[0]
    at = _rest_at(cfg, _ring_of(cfg, wire)).get(field)
    if at is None:
        raise ValueError(f"the universe's wire carries no {field}")
    s, n = at
    return wire[s:s + n, :g]


def _lane_sum(cfg: RaftConfig, leaves, g: int, field: str) -> int:
    """The int64 sum of one field's rows over the first g groups."""
    # sync-ok: a host readout of the wire, after the launches
    return int(klane(cfg, leaves, g, field).to(torch.int64).sum())  # sync-ok


def kcommitted(cfg: RaftConfig, leaves, g: int) -> int:
    """Total committed rounds straight from the wire (int64 sum)."""
    return _lane_sum(cfg, leaves, g, "committed")


def kreads(cfg: RaftConfig, leaves, g: int) -> int:
    """Total completed scheduled reads (the sum of the per-node
    `reads_done` counters) straight from the wire (int64 sum)."""
    return _lane_sum(cfg, leaves, g, "reads_done")


def kmembership_changed(cfg: RaftConfig, leaves, g: int) -> int:
    """Groups whose voter set changed (`run.membership_changed`: a
    snapshot's voters other than all k, or a membership-change entry in
    some node's window), straight from the wire."""
    voters = klane(cfg, leaves, g, "snap_voters") != cfg.full_mask
    config = (klane(cfg, leaves, g, "log_payload") & CONFIG_FLAG) != 0
    # sync-ok: a host readout of the wire, after the launches
    return int((voters.any(dim=0) | config.any(dim=0)).sum())  # sync-ok


def kacked(cfg: RaftConfig, leaves, g: int) -> int:
    """Client-visible ops acked exactly once (`run.total_client_ops`),
    straight from the wire."""
    return _lane_sum(cfg, leaves, g, "client_acked")


def kretries(cfg: RaftConfig, leaves, g: int) -> int:
    """Client re-submissions (`run.total_client_retries`), straight from
    the wire."""
    return _lane_sum(cfg, leaves, g, "client_retries")


def kelections(cfg: RaftConfig, leaves, g: int) -> int:
    acc = leaves[1]
    return int(acc[_hist_size(cfg, acc)])  # sync-ok: a host readout


def khist(cfg: RaftConfig, leaves, g: int, name: str = "hist") -> np.ndarray:
    """The [H] election-latency histogram (or, `name="client_hist"`, the
    ack-latency one) accumulated since kinit; empty under
    wire_hist=False."""
    acc = leaves[1]
    h = _hist_size(cfg, acc)
    at = h + 2 if name == "client_hist" else 0
    return acc[at:at + h].cpu().numpy()


# ------------------------------------------------------------ plain version


def _wide(cfg: RaftConfig) -> RaftConfig:
    """The config with the narrow dials off: the kernel computes every
    tick of a launch at int32, and so does its plain version."""
    return dataclasses.replace(cfg, **{f: False for f in NARROW_FIELDS})


def kstep_plain(cfg: RaftConfig, leaves, t0: int, n_ticks: int):
    """The kernel's plain PyTorch version: `unpack`, decode, `run.run`
    the ticks (`recorder.run_recorded` when the wire carries a flight),
    encode, `pack` — on whatever device the wire lies on. Returns a new
    (wire, acc) pair."""
    wire, acc = leaves
    work, ov = unpack(cfg, wire)
    st, m, flight = _decode(cfg, work, acc)
    if flight is None:
        st, m = run_mod.run(_wide(cfg), st, n_ticks, t0, m)
    else:
        st, m, flight = recorder.run_recorded(_wide(cfg), st, n_ticks, t0,
                                              m, flight)
    work, acc = _encode(cfg, st, m, flight)
    return pack(cfg, work, ov), acc


# ------------------------------------------------------------------ kernel


def _check_leaves(cfg: RaftConfig, leaves):
    if len(leaves) != 2:
        raise ValueError("leaves must be the (wire, acc) pair of kinit")
    wire, acc = leaves
    for name, a, dim in (("wire", wire, 2), ("acc", acc, 1)):
        if not isinstance(a, torch.Tensor) or a.dtype != I32 \
                or a.dim() != dim or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"of {dim} dims")
    _ring_of(cfg, wire)   # raises on a row count the config cannot have
    if wire.shape[1] < 1:
        raise ValueError("wire holds no group")
    h = _hist_size(cfg, acc)
    if (h >= 1) != cfg.wire_hist or acc.shape[0] != acc_words(cfg, h):
        raise ValueError("acc must hold a histogram (none under "
                         "wire_hist=False) and two counters (and, with "
                         "clients on, a second histogram and a max)")
    if wire.device != acc.device:
        raise ValueError("wire and acc lie on different devices")


def _params(cfg: RaftConfig, g: int, hist: int, ring: int, t0: int,
            n_ticks: int):
    """The launch parameters, in the order of the kernel's `Param` enum."""
    _, n_words, db_start = _wire_rows(cfg, ring)
    return np.array([
        g, cfg.k, cfg.log_cap, cfg.max_entries_per_msg, cfg.seed & 0xFFFFFFFF,
        cfg.election_min, cfg.election_range, cfg.heartbeat_every,
        cfg.compact_every, cfg.cmds_per_tick, cfg.crash_u32, cfg.crash_epoch,
        cfg.partition_u32, cfg.partition_epoch, cfg.drop_u32, cfg.majority,
        cfg.full_mask, hist, n_words, db_start, n_words - db_start,
        t0, n_ticks, *features(cfg), cfg.transfer_u32, cfg.transfer_epoch,
        cfg.reconfig_u32, cfg.reconfig_epoch, cfg.effective_min_voters,
        cfg.read_every, cfg.client_slots, cfg.clients_u32,
        cfg.client_retry_backoff, cfg.client_queue_cap, ring],
        dtype=np.int64)


def _nem_words(cfg: RaftConfig) -> np.ndarray:
    """The nemesis program as the kernel takes it (uint32): the clause
    count of each seam (link, crash, skew, disk, compaction), then each
    clause's eight words, grouped by seam. Times are clamped to 2**31 - 1
    (no tick reaches it) and the signed skew amount is its bit pattern."""
    seams = (cfg.nem_link, cfg.nem_crash, cfg.nem_skew, cfg.nem_disk,
             cfg.nem_compact)
    words = [len(sm) for sm in seams]
    for sm in seams:
        for kind, t0, t1, group_u32, p_u32, a, b, cid in sm:
            words += [kind, min(t0, 2 ** 31 - 1), min(t1, 2 ** 31 - 1),
                      group_u32, p_u32, a & 0xFFFFFFFF, b, cid & 0xFFFFFFFF]
    return np.array(words, dtype=np.uint32)


@functools.cache
def _nem_table(cfg: RaftConfig, device: torch.device):
    """The clause words of `_nem_words` on `device` (int32 bit patterns),
    which each block copies into its shared memory; None without
    clauses."""
    words = _nem_words(cfg)[5:]
    if not len(words):
        return None
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are built from csrc/ "
                       "on a machine with the CUDA toolkit")


def _defines(flags: tuple) -> list:
    return [f"-DFC_{f.upper()}={int(on)}" for f, on in zip(FEATURES, flags)]


CODEC = "codec"   # build()'s key of the codec build


def _target(key) -> tuple:
    """(source, defines, library name) of a build: a flag set of the
    tick kernel, or `CODEC`."""
    if key == CODEC:
        return CODEC_SOURCE, [], "wire_codec"
    return SOURCE, _defines(key), f"fused_chunk_{flag_name(key)}"


def _so_path(key) -> Path:
    """The build of a flag set (or of the codec), cached on disk by the
    source, the nvcc flags and the defines."""
    source, defines, name = _target(key)
    tag = hashlib.sha256(source.read_bytes() + " ".join(
        NVCC_FLAGS + tuple(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{tag[:16]}.so"


def build(flag_sets, codec: bool = False) -> dict:
    """Compile every flag set not yet on disk (and, with `codec`, the
    codec), one `nvcc` per build, all started together. Returns {flag
    set: ptxas report} (and {CODEC: report}): registers, frame and
    spills of each build, as `nvcc -Xptxas -v` printed them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    keys = list(dict.fromkeys(tuple(f) for f in flag_sets))
    keys += [CODEC] if codec else []
    procs = {}
    for key in keys:
        so = _so_path(key)
        if so.exists():
            continue
        source, defines, _ = _target(key)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[key] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp, str(source)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    with trace.span(f"nvcc {len(procs)} builds", keys=[
            CODEC if k == CODEC else flag_name(k) for k in procs]):
        logs = {key: proc.communicate()[0]
                for key, (_, _, proc) in procs.items()}
    for key, (so, tmp, proc) in procs.items():
        log = logs[key]
        if proc.returncode == 0:
            so.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, so)
        else:
            name = CODEC if key == CODEC else flag_name(key)
            failed.append(f"nvcc failed on {_target(key)[0]} ({name}):"
                          f"\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {key: _so_path(key).with_suffix(".ptxas.txt").read_text()
            for key in keys}


@functools.cache
def load(flags: tuple) -> ctypes.CDLL:
    """The tick kernel built for one flag set (compiled at first use),
    loaded once per process."""
    build([flags])
    with trace.span(f"load fused_chunk_{flag_name(flags)}"):
        lib = ctypes.CDLL(str(_so_path(flags)))
    fn = lib.fused_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = lib.fused_chunk_plan
    plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p]
    plan.restype = ctypes.c_int
    return lib


@functools.cache
def load_codec() -> ctypes.CDLL:
    """The codec kernels (compiled at first use), loaded once per
    process."""
    build([], codec=True)
    with trace.span("load wire_codec"):
        lib = ctypes.CDLL(str(_so_path(CODEC)))
    lib.wire_unpack_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wire_pack_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wire_unpack_launch.restype = ctypes.c_int
    lib.wire_pack_launch.restype = ctypes.c_int
    return lib


def _launch_args(cfg: RaftConfig, g: int, hist: int, ring: int, t0: int,
                 n_ticks: int):
    """The host arrays the launcher parses: offsets, params, nemesis."""
    offs = np.array(_wire_rows(cfg, ring)[0], dtype=np.int32)
    return offs, _params(cfg, g, hist, ring, t0, n_ticks), _nem_words(cfg)


_RC = {-1: "bad argument", -2: "the config's feature flags are not the "
       "build's", -3: "one group does not fit a block's shared memory"}


def launch_plan(cfg: RaftConfig, g: int, ring: int = 0) -> dict:
    """The block shape a launch over `g` groups takes on the current card
    (the launcher's occupancy query): lanes per group, groups and threads
    per block, shared bytes per block, blocks and groups per SM."""
    if not shape_supported(cfg):
        raise ValueError(shape_refusal(cfg))
    hist = HIST_SIZE if cfg.wire_hist else 0
    offs, params, nem = _launch_args(cfg, g, hist, ring, 0, 0)
    out = np.zeros(6, dtype=np.int32)
    rc = load(features(cfg)).fused_chunk_plan(
        offs.ctypes.data, len(offs), params.ctypes.data, len(params),
        nem.ctypes.data, len(nem), out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"fused_chunk plan failed: "
                           f"{_RC.get(rc, f'error {rc}')}")
    return dict(zip(("lanes_per_group", "groups_per_block",
                     "threads_per_block", "shared_bytes_per_block",
                     "blocks_per_sm", "groups_per_sm"), out.tolist()))


def kstep(cfg: RaftConfig, leaves, t0: int, n_ticks: int):
    """One launch: `n_ticks` ticks from absolute tick `t0`. Returns the
    (wire, acc) pair after them: new tensors, or, under `alias_wire`,
    the input pair written over (the input is consumed). CUDA tensors
    launch the tick kernel built for the universe's flag set on their
    device's current stream, with that device made current whichever
    the caller has (counted in `kstep.launches`), between `unpack_wire`
    and `pack_wire` when a packing dial is on; CPU tensors run
    `kstep_plain`."""
    _check_leaves(cfg, leaves)
    wire, acc = leaves
    if wire.device.type == "cpu":
        out, acc_out = kstep_plain(cfg, leaves, t0, n_ticks)
        if cfg.alias_wire:
            return wire.copy_(out), acc.copy_(acc_out)
        return out, acc_out
    if wire.device.type != "cuda":
        raise ValueError(f"no fused-chunk kernel for {wire.device}")
    if not shape_supported(cfg):
        raise ValueError(shape_refusal(cfg))
    if n_ticks < 0 or t0 < 0 or t0 + n_ticks >= 2 ** 31:
        raise ValueError("ticks must lie in [0, 2**31)")
    lib = load(features(cfg))
    g, ring = wire.shape[1], _ring_of(cfg, wire)
    # The outputs (none under alias_wire); a span, as the allocator may
    # stall the host here for a new device segment.
    with trace.span("kstep alloc", groups=g):
        acc_out = acc if cfg.alias_wire else acc.clone()
        fresh = None if cfg.alias_wire else torch.empty_like(wire)
    if packs(cfg):
        # The working wire the tick kernel runs on in place, and the
        # output at rest (the input itself under alias_wire).
        work, wire_in = unpack_wire(cfg, wire), None
        out = wire if cfg.alias_wire else fresh
    elif cfg.alias_wire:   # in place on the input: no copy, no aliasing
        work, wire_in = wire, None
    else:
        work, wire_in = fresh, wire
    with trace.span("kstep launch", groups=g):
        offs, params, nem = _launch_args(cfg, g, _hist_size(cfg, acc), ring,
                                         int(t0), int(n_ticks))
        table = _nem_table(cfg, wire.device)
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        with torch.cuda.device(wire.device):   # the C side launches there
            rc = lib.fused_chunk_launch(
                None if wire_in is None else wire_in.data_ptr(),
                work.data_ptr(), acc_out.data_ptr(),
                None if table is None else table.data_ptr(),
                offs.ctypes.data, len(offs), params.ctypes.data, len(params),
                nem.ctypes.data, len(nem), stream)
    if rc != 0:
        raise RuntimeError(f"fused_chunk launch failed: "
                           f"{_RC.get(rc, f'error {rc}')}")
    kstep.launches += 1
    if packs(cfg):
        return pack_wire(cfg, work, flags_from=wire, out=out), acc_out
    return work, acc_out


kstep.launches = 0


def krun(cfg: RaftConfig, leaves, t0: int, n_ticks: int,
         chunk_ticks: int | None = None, label: str | None = None,
         engine: str | None = None, **span_args):
    """The chunked launch loop every driver shares: `n_ticks` ticks from
    tick `t0` in `kstep` launches of `chunk_ticks` ticks (default: one
    launch; each through the stream table, `sim/streams.py`), each
    inside an `obs.trace.chunk_span` of `engine` (default: "cuda" on a
    card, else "plain"; `span_args` added to its args, and on "cuda" the
    kernel build's flag name as `build`) and,
    with a `label`, followed by an `obs.trace.heartbeat_wire` at the
    launch's last tick, the host's time between them traced as gaps
    (`obs.trace.covered`). All are no-ops unless a tracer or heartbeat
    is installed. Returns the wire pair after the ticks (under `alias_wire`,
    the input pair written over)."""
    if engine is None:
        engine = "cuda" if leaves[0].device.type == "cuda" else "plain"
    if engine == "cuda" and trace.get_tracer() is not None:
        span_args = dict(span_args, build=flag_name(features(cfg)))
    chunk = chunk_ticks or n_ticks
    at, end = int(t0), int(t0) + int(n_ticks)
    with trace.covered(label or engine):
        while at < end:
            step = min(chunk, end - at)
            with trace.chunk_span(engine, at, step, leaves[0].device,
                                  **span_args):
                leaves = streams.cuda.kstep(cfg, leaves, at, step)
            at += step
            if label is not None:
                trace.heartbeat_wire(label, at, cfg, leaves,
                                     leaves[0].shape[1])
    return leaves


@trace.spanned("prun")
def prun(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0,
         metrics: Metrics | None = None, flight: Flight | None = None):
    """Drop-in for `run.run` (for `recorder.run_recorded` with a
    `flight`: then a (State, Metrics, Flight) triple comes back): one
    launch between the two conversions, with its chunk span and a
    heartbeat labelled "prun" (`krun`). For chunked loops use kinit,
    `krun` and kfinish."""
    leaves, g = kinit(cfg, st, metrics, flight)
    leaves = krun(cfg, leaves, t0, n_ticks, label="prun")
    st, m = kfinish(cfg, leaves, g, metrics)
    return (st, m) if flight is None else (st, m, kflight(cfg, leaves, g))
