"""[Frozen copy of `raft_tpu_torch/clients/state.py` for the benchmark's reference,
its imports pointed at `raftbench.reference`.]

Per-group open-loop client state of the scheduled traffic model, as
torch tensors: the JAX package's `clients/state.py`.

Every leaf is int32 `[G, S]` (S = cfg.client_slots), or the dtype of
`NARROW_CLIENT_SPEC` in the narrow resident form (`narrow_clients`). This is client-side
(environment) state, not replicated state: it rides `State.clients` so
the run loop and the kernel wire carry it, but the tick sees it only
through phase C's submit pulses. The replicated dedup tables are
`PerNode.session_seq` / `snap_session_seq`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32

# Leaf order of the base client state; `ClientState._fields` is this
# tuple plus the admission leaves, which exist only when bounded
# admission is on (cfg.client_queue_cap > 0).
CLIENT_LEAVES = ("done", "backlog", "inflight", "t_start", "t_sub",
                 "submit", "retries", "last_lat")
ADMISSION_LEAVES = ("shed",)


def active_client_leaves(cfg) -> tuple:
    """The client leaves a universe carries, in ClientState order."""
    return CLIENT_LEAVES + (ADMISSION_LEAVES
                            if cfg.client_queue_cap > 0 else ())


# The narrow resident dtypes of the client leaves under
# `cfg.narrow_clients` (sim/state.py `narrow_spec`): op counters and tick
# stamps at u16 (the overflow latch refuses a run past their range), the
# 0/1 pulses at i8, the -1-sentinel ack latency at i16.
NARROW_CLIENT_SPEC = {
    "done": torch.uint16, "backlog": torch.uint16, "t_start": torch.uint16,
    "t_sub": torch.uint16, "retries": torch.uint16,
    "inflight": torch.int8, "submit": torch.int8,
    "last_lat": torch.int16, "shed": torch.uint16,
}


class ClientState(NamedTuple):
    """One open-loop exactly-once client per (group, sid) slot."""

    done: torch.Tensor      # ops fully acked == seq of the next op
    backlog: torch.Tensor   # arrived-but-not-started ops (open-loop queue)
    inflight: torch.Tensor  # 0/1: an op (seq == done) is being processed
    t_start: torch.Tensor   # tick the in-flight op was first submitted
    t_sub: torch.Tensor     # tick of the last submission (retry clock)
    submit: torch.Tensor    # 0/1 pulse: leaders append this op next tick
    retries: torch.Tensor   # re-submissions to date (potential duplicates)
    last_lat: torch.Tensor  # ack latency of an op acked this tick; -1 none
    shed: torch.Tensor | None = None   # arrivals rejected at the cap


def clients_init(cfg, n_groups: int, device="cuda") -> ClientState:
    """Fresh clients: idle, empty backlogs, no events."""
    device = torch.device(device)

    def z():
        return torch.zeros((n_groups, cfg.client_slots), dtype=I32,
                           device=device)

    return ClientState(
        done=z(), backlog=z(), inflight=z(), t_start=z(), t_sub=z(),
        submit=z(), retries=z(),
        last_lat=torch.full((n_groups, cfg.client_slots), -1, dtype=I32,
                            device=device),
        shed=z() if cfg.client_queue_cap > 0 else None)
