"""The least time one H100 could take for a universe, frozen with the
benchmark: the published peaks and the work a universe needs, counted
from the cell's shapes and from the reference's own outputs, never from
the program's wire layout, dials or launches.

Peaks (NVIDIA H100 SXM, no override): device memory 3.35 TB/s (data
sheet); int32 on the CUDA cores 64 lanes x 132 SMs x 1.98 GHz (Hopper
architecture white paper). They assume the 700 W power limit; a share is
read beside the card's limit.

Bytes: each group's State, its per-group Metrics lanes and its flight
ring, at their semantic widths (bool 1 byte, int32 and u32 4 bytes), read
once and written once per universe.

Operations: the counter-based hashes the universe's schedules and states
need (the port's `obs/roofline.py` `run_ops`, copied here and counted over
the groups given): crash and partition draws once per group and epoch,
a drop draw per live link and tick, membership and transfer fire draws,
every deadline draw taken, a payload hash per committed fire-hose
command, a client arrival draw per slot and tick and a value hash per
submit pulse, a digest fold per applied entry, and the nemesis program's
draws. Where the count depends on the data (draws taken, entries
applied, pulses), it is read from the reference's run of the sampled
groups, which the check found equal to the program's.
"""

from __future__ import annotations

import collections

import torch

from raftbench.reference import rng, trng

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

MIX_OPS = 7              # mix32: 3 xors, 2 shifts, 2 multiplies
FOLD_OPS = MIX_OPS + 2   # one hash_u32 argument: multiply, add, mix32


def semantic_width(a: torch.Tensor, u32: bool) -> int:
    """Bytes of one element at its semantic width."""
    if a.dtype == torch.bool:
        return 1
    return 4 if u32 else a.element_size()


def group_bytes(state_leaves: dict, lanes: dict, flight: dict,
                u32_leaves: tuple) -> int:
    """Bytes of one group's State leaves ([G, ...] each), per-group
    Metrics lanes ([G]) and flight rows ([R, G]) at semantic widths."""
    total = 0
    for name, a in state_leaves.items():
        per = a[0].numel() if a.dim() > 1 else 1
        total += per * semantic_width(a, name in u32_leaves)
    for a in lanes.values():
        total += semantic_width(a, False)
    for a in flight.values():
        total += a.shape[0] * semantic_width(a, False)
    return total


def least_time(bytes_moved: float, ops: float) -> dict:
    """The least seconds for `bytes_moved` and `ops`, and the side that
    bounds it."""
    hbm_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = ops / INT32_OPS_PER_S
    return {"seconds": max(hbm_s, ops_s), "hbm_s": hbm_s, "ops_s": ops_s,
            "bound": "bytes" if hbm_s >= ops_s else "operations"}


def run_ops(cfg, gid, n_ticks: int, st0, st1, committed: int) -> float:
    """Integer operations the counter-based hashes of the groups `gid` need
    over a run of `n_ticks` from tick 0 (start State `st0`, end `st1`,
    `committed` their committed entries summed)."""
    k = cfg.k
    g = gid.numel()

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
    """The nemesis program's hash work over the groups `gid`."""
    k, g = cfg.k, gid.to(torch.int64)
    ops = len(cfg.nemesis) * g.numel() * 4 * FOLD_OPS
    for c in cfg.nemesis:
        kind, t0, t1, group_u32, _, a, _, cid = c
        part = trng.hash_u32(cfg.seed, rng.TAG_NEM_GROUP, cid, g) < group_u32
        n_part = int(part.sum())
        lo, hi = min(t0, n_ticks), min(t1, n_ticks)
        if kind in rng.NEM_LINK_KINDS:
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
    """[G, src, dst]: the links one link clause hits at tick t."""
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
    """The submit pulses phase C consumed in a run from tick 0."""
    return int(sum(getattr(cl, f).to(torch.int64).sum()
                   for f in ("done", "inflight", "retries"))
               - cl.submit.to(torch.int64).sum())


def live_links(cfg, gid, n_ticks: int) -> int:
    """The (tick, group, src, dst) with src != dst whose receiver is alive
    and whose link is not cut: the links whose drop draw is read."""
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
