"""Declarative gray-failure programs: the clause builders, program
assembly, JSON form and stable hash — the JAX package's
`nemesis/program.py`, kept as the port's own copy.

A program is a tuple of clauses — slow-but-alive followers, asymmetric
flaky links, WAN-style heterogeneous delivery, timeout skew,
crash-recovery storms, correlated partition waves, disk-full followers
and compaction pressure — each with a tick span and a per-group
participation probability. The builders quantize every probability to a
u32 threshold at construction (the `config._prob_to_u32` rule every
fault knob uses), so a program is nothing but ints: `RaftConfig(
nemesis=prog)` carries it, and the seams evaluate it as pure
`(seed, TAG_NEM_*, cid, coords)` hashes (utils/trng.py `nem_*`, and the
kernel's twins in csrc/fused_chunk.cu).

Every clause owns a `cid` that domain-separates its draws: `program()`
assigns cids positionally once and keeps explicit ones, so dropping a
clause never reshuffles another's schedule.
"""

from __future__ import annotations

from typing import NamedTuple

from raft_tpu_torch.config import _prob_to_u32
from raft_tpu_torch.utils import rng as _r

# JSON names of the clause kinds (stable: artifacts and manifests use them).
KIND_NAMES = {
    _r.NEM_SLOW: "slow_follower",
    _r.NEM_FLAKY: "flaky_link",
    _r.NEM_WAN: "wan_delay",
    _r.NEM_SKEW: "clock_skew",
    _r.NEM_STORM: "crash_storm",
    _r.NEM_WAVE: "partition_wave",
    _r.NEM_DISK: "disk_full_follower",
    _r.NEM_COMPACT: "compaction_pressure",
}
KIND_IDS = {v: k for k, v in KIND_NAMES.items()}

FIELDS = ("kind", "t0", "t1", "group_u32", "p_u32", "a", "b", "cid")

_UNASSIGNED = -1


class Clause(NamedTuple):
    """One clause: the 8-int layout the seams destructure (field meaning
    per kind: utils/rng.py's nemesis block)."""
    kind: int
    t0: int
    t1: int
    group_u32: int
    p_u32: int
    a: int = 0
    b: int = 0
    cid: int = _UNASSIGNED


def _clause(kind, t0, t1, groups, p, a=0, b=0):
    if not 0 <= t0 <= t1:
        raise ValueError(f"clause span [{t0}, {t1}) invalid")
    return Clause(kind=kind, t0=int(t0), t1=int(t1),
                  group_u32=_prob_to_u32(groups), p_u32=_prob_to_u32(p),
                  a=int(a), b=int(b))


def slow_follower(t0, t1, p=0.8, direction=3, groups=1.0):
    """One hash-chosen node per participating group keeps ticking but
    its links drop w.p. `p` per tick. `direction`: 1 = messages FROM it,
    2 = TO it, 3 = both."""
    if direction not in (1, 2, 3):
        raise ValueError(f"direction {direction} not in (1, 2, 3)")
    return _clause(_r.NEM_SLOW, t0, t1, groups, p, a=direction)


def flaky_link(t0, t1, p=0.9, burst_epoch=8, burst_p=0.5, groups=1.0):
    """ONE hash-chosen ordered (src -> dst) pair drops w.p. `p`, only
    inside bursts: `burst_epoch`-tick sub-epochs firing w.p. `burst_p`.
    The reverse direction is untouched."""
    if burst_epoch < 1:
        raise ValueError("burst_epoch must be >= 1")
    return _clause(_r.NEM_FLAKY, t0, t1, groups, p, a=burst_epoch,
                   b=_prob_to_u32(burst_p))


def wan_delay(t0, t1, sites=3, p=0.5, groups=1.0):
    """Nodes hash onto `sites` sites; cross-site links drop w.p. `p` per
    tick (with heartbeat retransmission, loss is added latency)."""
    if sites < 2:
        raise ValueError("sites must be >= 2")
    return _clause(_r.NEM_WAN, t0, t1, groups, p, a=sites)


def clock_skew(t0, t1, amount=8, node_p=0.5, groups=1.0):
    """Nodes selected w.p. `node_p` add the SIGNED `amount` ticks to
    every election-deadline draw made during the span (the skewed
    deadline clamps at 1)."""
    return _clause(_r.NEM_SKEW, t0, t1, groups, node_p, a=amount)


def crash_storm(t0, t1, p=0.4, epoch=4, groups=1.0):
    """A second, faster crash schedule — per node per `epoch`-tick
    sub-epoch, down w.p. `p` — ANDed into the base crash mask."""
    if epoch < 1:
        raise ValueError("epoch must be >= 1")
    return _clause(_r.NEM_STORM, t0, t1, groups, p, a=epoch)


def partition_wave(t0, t1, period=32, width=12, leak_p=1.0, groups=1.0):
    """A `width`-tick partition window sweeps the fleet with `period`
    (group g enters it g ticks after g - 1). Sides re-draw each period;
    cross-side links drop w.p. `leak_p` (below 1.0: a leaky partition)."""
    if period < 1 or width < 0:
        raise ValueError("period must be >= 1 and width >= 0")
    return _clause(_r.NEM_WAVE, t0, t1, groups, leak_p, a=period, b=width)


def disk_full_follower(t0, t1, p=0.8, epoch=8, groups=1.0):
    """ONE hash-chosen node per participating group exhausts its
    persistence budget during `epoch`-tick sub-epochs firing w.p. `p`:
    every local append on it fails, so the entries are never acked."""
    if epoch < 1:
        raise ValueError("epoch must be >= 1")
    return _clause(_r.NEM_DISK, t0, t1, groups, p, a=epoch)


def compaction_pressure(t0, t1, p=0.5, epoch=8, groups=1.0):
    """Per node per `epoch`-tick sub-epoch, w.p. `p`, the phase-A
    compaction step is delayed: the log_cap ring fills and the window
    becomes a backpressure path."""
    if epoch < 1:
        raise ValueError("epoch must be >= 1")
    return _clause(_r.NEM_COMPACT, t0, t1, groups, p, a=epoch)


def program(*clauses) -> tuple:
    """Assemble clauses into a program: fresh cids for builder output
    (positional), explicit cids kept, duplicates refused."""
    taken = {c[7] for c in clauses if c[7] != _UNASSIGNED}
    out, nxt = [], 0
    for c in clauses:
        c = Clause(*(int(x) for x in c))
        if c.cid == _UNASSIGNED:
            while nxt in taken:
                nxt += 1
            c = c._replace(cid=nxt)
            taken.add(nxt)
        out.append(c)
    if len({c.cid for c in out}) != len(out):
        raise ValueError("duplicate clause cids")
    return tuple(out)


def gray_mix(n_ticks: int, t0: int = 0) -> tuple:
    """The canonical gray-failure program (slow follower + flaky link),
    bench.py's nemesis segment."""
    return program(
        slow_follower(t0, t0 + n_ticks, p=0.7, direction=3),
        flaky_link(t0, t0 + n_ticks, p=0.9, burst_epoch=8, burst_p=0.6),
    )


def pressure_mix(n_ticks: int, t0: int = 0) -> tuple:
    """The canonical storage-pressure program (disk-full follower +
    compaction pressure), bench.py's pressure-knee segment."""
    return program(
        disk_full_follower(t0, t0 + n_ticks, p=0.8, epoch=8),
        compaction_pressure(t0, t0 + n_ticks, p=0.5, epoch=8),
    )


def to_json(prog) -> list:
    """One dict per clause, kinds by name."""
    return [{**dict(zip(FIELDS, c)), "kind": KIND_NAMES[c[0]]}
            for c in prog]


def from_json(doc) -> tuple:
    """Inverse of `to_json` (also accepts numeric kinds and bare
    8-lists)."""
    out = []
    for c in doc:
        if isinstance(c, dict):
            kind = c["kind"]
            kind = KIND_IDS[kind] if isinstance(kind, str) else int(kind)
            out.append(Clause(kind, *(int(c[f]) for f in FIELDS[1:])))
        else:
            out.append(Clause(*(int(x) for x in c)))
    return tuple(out)


def program_hash(prog) -> str:
    """Stable 8-hex-digit identity of a program: the repo's hash folded
    over the clause count and the flat clause ints."""
    flat = [len(prog)]
    for c in prog:
        flat.extend(int(x) for x in c)
    return format(_r.hash_u32(*flat), "08x")


def describe(prog) -> str:
    """One human line per clause."""
    lines = []
    for c in prog:
        kind, t0, t1, group_u32, p_u32, a, b, cid = c
        lines.append(
            f"#{cid} {KIND_NAMES[kind]} [{t0},{t1}) "
            f"groups={group_u32 / 2**32:.2f} p={p_u32 / 2**32:.2f} "
            f"a={a} b={b}")
    return "; ".join(lines) or "<empty>"
