"""The group axis: the contiguous spans a fleet splits into, and State,
Metrics and Flight cut to a span and joined again.

Raft groups never talk to each other, so every driver that splits a
fleet (the mesh's shards, the cohort windows, a window's per-device
slices) cuts the same way: a State leaf is `[G, ...]`, a Flight leaf
`[RING, G]`, and of Metrics the per-group lanes (`PER_GROUP`) are `[G]`
while the rest are fleet-wide (their reduction over shards is
`mesh.reduce_counters` and `kmesh.reduce_acc`).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.obs.recorder import Flight
from raft_tpu_torch.sim import state as state_mod
from raft_tpu_torch.sim.run import Metrics
from raft_tpu_torch.sim.state import State

# Metrics lanes with one value per group; the others are fleet-wide.
PER_GROUP = ("committed", "leaderless", "safety", "client_acked",
             "client_retries")


def spans(g: int, n: int) -> list:
    """[(s0, s1), ...]: `g` groups in contiguous spans of ceil(g / n)
    groups, the last taking the remainder; at most `n` spans, none empty
    (fewer when `g` is too small to give each of `n` shards a group)."""
    if g < 1 or n < 1:
        raise ValueError(f"cannot split {g} groups over {n} shards")
    step = -(-g // n)
    return [(s0, min(s0 + step, g)) for s0 in range(0, g, step)]


def take(st: State, metrics: Metrics | None, flight: Flight | None,
         s0: int, s1: int, device):
    """The groups [s0, s1) of a State, Metrics and Flight (each may be
    None), on `device`: the per-group metric lanes cut, the fleet-wide
    ones whole."""
    st = state_mod._map_named(st, "", lambda _, a: a[s0:s1].to(device))
    if metrics is not None:
        metrics = metrics._replace(**{
            f: getattr(metrics, f)[s0:s1] for f in PER_GROUP
            if getattr(metrics, f) is not None})
        metrics = state_mod._map_named(metrics, "",
                                       lambda _, a: a.to(device))
    if flight is not None:
        flight = Flight(*(a[:, s0:s1].to(device) for a in flight))
    return st, metrics, flight


def cat_states(parts: list, device) -> State:
    """The States of consecutive spans joined on `device`."""
    def cat(trees):
        first = trees[0]
        if first is None:
            return None
        if isinstance(first, tuple) and hasattr(first, "_fields"):
            return type(first)(*(cat([getattr(t, f) for t in trees])
                                 for f in first._fields))
        return torch.cat([a.to(device) for a in trees])
    return cat(parts)


def cat_flights(parts: list, device) -> Flight | None:
    """The Flights of consecutive spans joined on `device` (None when
    the parts carry none)."""
    if parts[0] is None:
        return None
    return Flight(*(torch.cat([a.to(device) for a in rows], dim=1)
                    for rows in zip(*parts)))
