"""The fused-chunk kernel: many whole ticks per launch, one CUDA thread
per Raft group (csrc/fused_chunk.cu), with the JAX package's
`sim/pkernel.py` API — `kinit` / `kstep` / `kfinish` / `prun`, and
`kcommitted` / `kelections` / `khist` / `kreads` on the wire form.

The wire form is a pair of tensors, `(wire, acc)`:
- `wire`: int32 `[W, G]`, every State leaf plus the per-group metric
  lanes (committed, leaderless, safety), structure of arrays with the
  group axis minor (`_wire_rows`). Bools are 0/1, u32 digests their
  int32 bit pattern. The rings and the mailbox come last: the kernel
  double-buffers that region across ticks. The PreVote and TimeoutNow
  mailbox slots ride the wire only when their features are on.
- `acc`: int32 `[H + 2]`, the election-latency histogram, the election
  count and the longest completed streak, accumulated from zero since
  `kinit`; `kfinish` folds a caller's base metrics back in.

`kinit`/`kfinish` transpose the whole state, so chunked drivers call
them once around the chunk loop, never per chunk.

`kstep` launches the kernel for CUDA tensors; for CPU tensors it runs
the plain version, `kstep_plain` (sim/run.py `run` over the same ticks,
through the same wire boundary). There is no fallback from one to the
other. The four protocol features (PreVote, leadership transfer,
membership change, scheduled reads) are compile-time flags of the
kernel: each flag set is its own build of the one source (`load`), the
all-off build carrying none of their code. A build runs `nvcc` at first
use, into a directory git ignores, and is bound through ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import run as run_mod
from raft_tpu_torch.sim.run import Metrics
from raft_tpu_torch.sim.state import (BOOL, I32, MB_FIELDS, Mailbox,
                                      PerNode, State, mailbox_dtype,
                                      mb_fields)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "fused_chunk.cu"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The kernel's compile-time feature flags, in the order of its macros.
FEATURES = ("prevote", "transfer", "reconfig", "reads")
KMAX, LMAX = 8, 64   # the kernel's per-thread array bounds

_PEER = ("votes", "next_index", "match_index", "ack_time")
_RING = ("log_term", "log_payload")
_U32_FIELDS = ("snap_digest", "digest", "is_req_snap_digest")
# Wire fields in the order of the kernel's `Field` enum: node leaves
# (rings excluded), alive_prev, group_id, the metric lanes, then the
# double-buffered region (rings, mailbox). A universe's wire holds the
# mailbox slots it carries (`wire_fields`).
_NODE_STATIC = tuple(f for f in PerNode._fields[:26] if f not in _RING)
_HEAD = (_NODE_STATIC
         + ("alive_prev", "group_id", "committed", "leaderless", "safety")
         + _RING)
WIRE_FIELDS = _HEAD + MB_FIELDS
_DB_FIRST = "log_term"
_METRIC_LANES = ("committed", "leaderless", "safety")


def wire_fields(cfg: RaftConfig) -> tuple:
    return _HEAD + mb_fields(cfg)


def features(cfg: RaftConfig) -> tuple:
    """The kernel's feature flags for a universe, in `FEATURES` order."""
    return (bool(cfg.prevote), cfg.transfer_u32 != 0,
            cfg.reconfig_u32 != 0, cfg.read_every != 0)


def flag_name(flags: tuple) -> str:
    """A flag set's name: the features it turns on, or "base"."""
    return "+".join(f for f, on in zip(FEATURES, flags) if on) or "base"


def _shape(cfg: RaftConfig, field: str) -> tuple:
    """Per-group shape of one field (its trailing dims)."""
    k = cfg.k
    if field in _RING:
        return (k, cfg.log_cap)
    if field in _PEER or field in MB_FIELDS:
        return (k, k)
    if field in ("group_id",) + _METRIC_LANES:
        return ()
    return (k,)


def _rows(cfg: RaftConfig, field: str) -> int:
    """Wire rows (i32 words per group) of one field."""
    return int(np.prod(_shape(cfg, field), dtype=np.int64))


def _wire_rows(cfg: RaftConfig):
    """(offsets, n_words, db_start): each field's first row, in
    WIRE_FIELDS order, -1 for a mailbox slot the universe does not
    carry. Offsets of the double-buffered fields are relative to
    `db_start`."""
    on = set(wire_fields(cfg))
    offsets, at, db_start = [], 0, None
    for f in WIRE_FIELDS:
        if f not in on:
            offsets.append(-1)
            continue
        if f == _DB_FIRST:
            db_start = at
        offsets.append(at - (db_start or 0) if db_start is not None else at)
        at += _rows(cfg, f)
    return offsets, at, db_start


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


def _encode(cfg: RaftConfig, st: State, m: Metrics):
    g = st.alive_prev.shape[0]
    leaves = st.nodes._asdict()
    leaves.update(st.mailbox._asdict())
    leaves.update(alive_prev=st.alive_prev, group_id=st.group_id,
                  committed=m.committed, leaderless=m.leaderless,
                  safety=m.safety)
    wire = torch.cat([_to_i32(leaves[f]).reshape(g, -1).T
                      for f in wire_fields(cfg)]).contiguous()
    acc = torch.cat([m.hist, m.elections.reshape(1),
                     m.max_latency.reshape(1)]).to(I32)
    return wire, acc


def _decode(cfg: RaftConfig, leaves):
    """(State, Metrics) of a wire pair, the metrics as accumulated on it."""
    wire, acc = leaves
    g = wire.shape[1]
    vals, at = {}, 0
    for f in wire_fields(cfg):
        n = _rows(cfg, f)
        vals[f] = wire[at:at + n].T.reshape((g,) + _shape(cfg, f))
        at += n
    node_dt = {f: (torch.int64 if f in _U32_FIELDS
                   else BOOL if f == "votes" else I32)
               for f in PerNode._fields[:26]}
    nodes = PerNode(**{f: _from_i32(vals[f], node_dt[f])
                       for f in PerNode._fields[:26]})
    mailbox = Mailbox(**{f: _from_i32(vals[f], mailbox_dtype(f))
                         for f in mb_fields(cfg)})
    st = State(nodes=nodes, mailbox=mailbox,
               alive_prev=vals["alive_prev"] != 0,
               group_id=vals["group_id"].clone())
    h = acc.shape[0] - 2
    met = Metrics(committed=vals["committed"].clone(),
                  leaderless=vals["leaderless"].clone(),
                  elections=acc[h].clone(), hist=acc[:h].clone(),
                  max_latency=acc[h + 1].clone(),
                  safety=vals["safety"].clone())
    return st, met


def kinit(cfg: RaftConfig, st: State, metrics: Metrics | None = None):
    """(State, Metrics) -> the wire form, once per run. Returns
    (leaves, g). committed/leaderless/safety continue in place on the
    wire; the histogram, election count and longest streak start from
    zero (kfinish folds `metrics_base` back in)."""
    g = st.alive_prev.shape[0]
    dev = st.alive_prev.device
    if metrics is None:
        metrics = run_mod.metrics_init(g, device=dev)
    base = run_mod.metrics_init(g, hist_size=metrics.hist.shape[0],
                                device=dev)
    m = base._replace(committed=metrics.committed,
                      leaderless=metrics.leaderless, safety=metrics.safety)
    return _encode(cfg, st, m), g


def kfinish(cfg: RaftConfig, leaves, g: int,
            metrics_base: Metrics | None = None):
    """Wire form -> (State, Metrics), folding `metrics_base`'s election
    count, longest streak and histogram into the accumulated ones."""
    st, m = _decode(cfg, leaves)
    if metrics_base is not None:
        m = m._replace(
            elections=m.elections + metrics_base.elections,
            hist=m.hist + metrics_base.hist,
            max_latency=torch.maximum(m.max_latency,
                                      metrics_base.max_latency))
    return st, m


def kcommitted(cfg: RaftConfig, leaves, g: int) -> int:
    """Total committed rounds straight from the wire (int64 sum)."""
    off = _wire_rows(cfg)[0][WIRE_FIELDS.index("committed")]
    return int(leaves[0][off, :g].to(torch.int64).sum())


def kreads(cfg: RaftConfig, leaves, g: int) -> int:
    """Total completed scheduled reads (the sum of the per-node
    `reads_done` counters) straight from the wire (int64 sum)."""
    off = _wire_rows(cfg)[0][WIRE_FIELDS.index("reads_done")]
    return int(leaves[0][off:off + cfg.k, :g].to(torch.int64).sum())


def kelections(cfg: RaftConfig, leaves, g: int) -> int:
    acc = leaves[1]
    return int(acc[acc.shape[0] - 2])


def khist(cfg: RaftConfig, leaves, g: int) -> np.ndarray:
    """The [H] election-latency histogram accumulated since kinit."""
    acc = leaves[1]
    return acc[:acc.shape[0] - 2].cpu().numpy()


# ------------------------------------------------------------ plain version


def kstep_plain(cfg: RaftConfig, leaves, t0: int, n_ticks: int):
    """The kernel's plain PyTorch version: decode, `run.run` the ticks,
    encode — on whatever device the wire lies on."""
    st, m = _decode(cfg, leaves)
    st, m = run_mod.run(cfg, st, n_ticks, t0, m)
    return _encode(cfg, st, m)


# ------------------------------------------------------------------ kernel


def _check_leaves(cfg: RaftConfig, leaves):
    if len(leaves) != 2:
        raise ValueError("leaves must be the (wire, acc) pair of kinit")
    wire, acc = leaves
    n_words = _wire_rows(cfg)[1]
    for name, a, dim in (("wire", wire, 2), ("acc", acc, 1)):
        if not isinstance(a, torch.Tensor) or a.dtype != I32 \
                or a.dim() != dim or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"of {dim} dims")
    if wire.shape[0] != n_words or wire.shape[1] < 1:
        raise ValueError(f"wire has {wire.shape[0]} rows, the config "
                         f"needs {n_words}")
    if acc.shape[0] < 3:
        raise ValueError("acc must hold a histogram and two counters")
    if wire.device != acc.device:
        raise ValueError("wire and acc lie on different devices")


def _params(cfg: RaftConfig, g: int, hist: int, t0: int, n_ticks: int):
    """The launch parameters, in the order of the kernel's `Param` enum."""
    _, n_words, db_start = _wire_rows(cfg)
    return np.array([
        g, cfg.k, cfg.log_cap, cfg.max_entries_per_msg, cfg.seed & 0xFFFFFFFF,
        cfg.election_min, cfg.election_range, cfg.heartbeat_every,
        cfg.compact_every, cfg.cmds_per_tick, cfg.crash_u32, cfg.crash_epoch,
        cfg.partition_u32, cfg.partition_epoch, cfg.drop_u32, cfg.majority,
        cfg.full_mask, hist, n_words, db_start, n_words - db_start,
        t0, n_ticks, *features(cfg), cfg.transfer_u32, cfg.transfer_epoch,
        cfg.reconfig_u32, cfg.reconfig_epoch, cfg.effective_min_voters,
        cfg.read_every], dtype=np.int64)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused-chunk kernel is built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _defines(flags: tuple) -> list:
    return [f"-DFC_{f.upper()}={int(on)}" for f, on in zip(FEATURES, flags)]


def _so_path(flags: tuple) -> Path:
    """The build of one flag set, cached on disk by the source, the
    nvcc flags and the flag set."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        NVCC_FLAGS + tuple(_defines(flags))).encode()).hexdigest()
    return BUILD_DIR / f"fused_chunk_{flag_name(flags)}_{tag[:16]}.so"


def build(flag_sets) -> dict:
    """Compile every flag set not yet on disk, one `nvcc` per set, all
    started together. Returns {flag set: ptxas report}: registers, frame
    and spills of each build, as `nvcc -Xptxas -v` printed them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for flags in dict.fromkeys(tuple(f) for f in flag_sets):
        so = _so_path(flags)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[flags] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *_defines(flags), "-o", tmp, str(SOURCE)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for flags, (so, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            so.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, so)
        else:
            failed.append(f"nvcc failed on {SOURCE} ({flag_name(flags)}):"
                          f"\n{log}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {tuple(f): _so_path(tuple(f)).with_suffix(".ptxas.txt")
            .read_text() for f in flag_sets}


@functools.cache
def load(flags: tuple) -> ctypes.CDLL:
    """The kernel built for one flag set (compiled at first use), loaded
    once per process."""
    build([flags])
    lib = ctypes.CDLL(str(_so_path(flags)))
    fn = lib.fused_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def kstep(cfg: RaftConfig, leaves, t0: int, n_ticks: int):
    """One launch: `n_ticks` ticks from absolute tick `t0`. Returns a new
    (wire, acc) pair; the inputs are left as they were. CUDA tensors
    launch the kernel built for the universe's flag set on the current
    stream (counted in `kstep.launches`); CPU tensors run
    `kstep_plain`."""
    _check_leaves(cfg, leaves)
    wire, acc = leaves
    if wire.device.type == "cpu":
        return kstep_plain(cfg, leaves, t0, n_ticks)
    if wire.device.type != "cuda":
        raise ValueError(f"no fused-chunk kernel for {wire.device}")
    if cfg.k > KMAX or cfg.log_cap > LMAX:
        raise ValueError(f"the kernel takes k <= {KMAX} and log_cap <= "
                         f"{LMAX}, not k={cfg.k}, log_cap={cfg.log_cap}")
    if n_ticks < 0 or t0 < 0 or t0 + n_ticks >= 2 ** 31:
        raise ValueError("ticks must lie in [0, 2**31)")
    flags = features(cfg)
    lib = load(flags)
    g = wire.shape[1]
    offsets, n_words, db_start = _wire_rows(cfg)
    out = torch.empty_like(wire)
    scratch = torch.empty((n_words - db_start, g), dtype=I32,
                          device=wire.device)
    acc_out = torch.empty_like(acc)
    acc_out.copy_(acc)
    offs = np.array(offsets, dtype=np.int32)
    params = _params(cfg, g, acc.shape[0] - 2, int(t0), int(n_ticks))
    stream = torch.cuda.current_stream(wire.device).cuda_stream
    rc = lib.fused_chunk_launch(
        wire.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        acc_out.data_ptr(), offs.ctypes.data, len(offs), params.ctypes.data,
        len(params), stream)
    if rc != 0:
        raise RuntimeError(f"fused_chunk launch failed: error {rc}")
    kstep.launches += 1
    return out, acc_out


kstep.launches = 0


def prun(cfg: RaftConfig, st: State, n_ticks: int, t0: int = 0,
         metrics: Metrics | None = None):
    """Drop-in for `run.run`: one launch between the two conversions.
    For chunked loops use kinit/kstep/kfinish directly."""
    leaves, g = kinit(cfg, st, metrics)
    leaves = kstep(cfg, leaves, t0, n_ticks)
    return kfinish(cfg, leaves, g, metrics)

