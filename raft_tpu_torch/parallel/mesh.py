"""A 1-D mesh over the groups axis, and the plain tick run sharded over it
(the JAX package's `raft_tpu/parallel/mesh.py`).

Groups are embarrassingly parallel (no cross-group messages), so the
groups axis splits into contiguous spans, one per device of the mesh
(`groups.spans`: ceil(G / n) groups each, the last taking the remainder;
no padding, as nothing in the CUDA kernel needs whole 1,024-group
blocks), and the only traffic between devices is the reduction of the
metric aggregates at the end of a run. Correct sharding rides on
`State.group_id` travelling with the shard: each shard draws its own
global group ids' seed streams.

One process drives every device of the mesh, as JAX's single controller
does: the shards' work is queued device by device from one host thread,
and the reduction copies five scalars and one `[H]` row to the first
device and sums them there. The JAX package's only collective is this
one reduction per run, and its `run_sharded` returns the whole State, so
no process group (`torch.distributed`) is involved.

A mesh is a tuple of `torch.device`s, the default every visible card.
An explicit `devices=` list may repeat a device: several shards on one
card, or `["cpu"] * n` for the CPU tests. No platform is ever swapped
for another: a mesh asked of cards that are not there raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.parallel import groups
from raft_tpu_torch.sim.run import metrics_init, run
from raft_tpu_torch.sim.state import State

def make_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """The first `n_devices` of `devices` (default: every visible CUDA
    device, `cuda:0` ... `cuda:{n-1}`) as a tuple of `torch.device`s.
    A device may repeat. Raises `ValueError` when there are fewer than
    `n_devices`, or none."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        where = "visible CUDA devices"
    else:
        devices = [_resolved(torch.device(d)) for d in devices]
        where = "devices given"
    if n_devices is not None:
        if n_devices < 1 or len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)} {where}")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f"no device for a mesh: 0 {where} (the CPU is "
                         f"never taken in place of a card; pass "
                         f"devices=['cpu'] * n for it)")
    return tuple(devices)


def _resolved(d: torch.device) -> torch.device:
    """A CUDA device without an index names the current one."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def placement(g: int, mesh) -> list:
    """[(device, s0, s1), ...]: the span of groups each shard holds, in
    mesh order (`groups.spans`; a mesh longer than the fleet leaves its
    last devices without a shard)."""
    return [(_resolved(torch.device(mesh[j])), s0, s1)
            for j, (s0, s1) in enumerate(groups.spans(g, len(mesh)))]


def shard_state(st: State, mesh) -> list:
    """The State cut into its shards, shard j on `mesh[j]`."""
    return [groups.take(st, None, None, s0, s1, dev)[0]
            for dev, s0, s1 in placement(st.alive_prev.shape[0], mesh)]


def as_shards(st, mesh) -> list:
    """`st` as shards on `mesh`: a whole State is cut (`shard_state`); a
    list of shards (`shard_state`'s, or `checkpoint.load`'s with a mesh)
    must be the cut of its total over this mesh, each on its device."""
    if isinstance(st, State):
        return shard_state(st, mesh)
    shards = list(st)
    g = sum(s.alive_prev.shape[0] for s in shards)
    want = placement(g, mesh)
    got = [(s.alive_prev.device, s.alive_prev.shape[0]) for s in shards]
    if got != [(d, s1 - s0) for d, s0, s1 in want]:
        raise ValueError(f"shards {got} are not the cut of {g} groups over "
                         f"the mesh {[str(d) for d in mesh]}")
    return shards


class GlobalMetrics(NamedTuple):
    """Mesh-reduced counters of a sharded run, on the mesh's first
    device."""
    rounds: torch.Tensor       # committed entries, summed over the mesh
    elections: torch.Tensor    # completed leader acquisitions, summed
    hist: torch.Tensor         # i32[H] election-latency histogram, summed
    max_latency: torch.Tensor  # longest completed streak, max
    unsafe: torch.Tensor       # groups whose per-tick safety bit dropped
    # during the run (run.Metrics.safety), summed; 0 = a clean soak


def reduce_counters(parts, device) -> GlobalMetrics:
    """GlobalMetrics of per-shard (rounds, elections, hist, max_latency,
    unsafe) tensors: each copied to `device`, then summed (the max for
    max_latency)."""
    cols = list(zip(*parts))

    def on(vals):
        return torch.stack([v.to(device) for v in vals])

    return GlobalMetrics(
        rounds=on(cols[0]).sum(), elections=on(cols[1]).sum(),
        hist=on(cols[2]).sum(dim=0, dtype=cols[2][0].dtype),
        max_latency=on(cols[3]).amax(), unsafe=on(cols[4]).sum())


def run_sharded(cfg: RaftConfig, st, n_ticks: int, mesh, t0: int = 0):
    """Run `n_ticks` ticks of the plain tick (`run.run`) with the groups
    axis sharded over `mesh`. `st` is a whole State or its shards
    (`as_shards`). Returns (the whole State, gathered on the mesh's first
    device, GlobalMetrics reduced there). The plain tick is the
    reference, no yardstick of speed."""
    mesh = make_mesh(devices=mesh)
    shards = as_shards(st, mesh)
    outs, parts = [], []
    for sh in shards:
        dev = sh.alive_prev.device
        m0 = metrics_init(sh.alive_prev.shape[0],
                          clients=sh.clients is not None, device=dev)
        s, m = run(cfg, sh, n_ticks, t0, m0)
        outs.append(s)
        parts.append((m.committed.sum(), m.elections, m.hist,
                      m.max_latency, (1 - m.safety).sum()))
    return (groups.cat_states(outs, mesh[0]),
            reduce_counters(parts, mesh[0]))
