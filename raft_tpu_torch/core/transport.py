"""In-memory Transport: the message bus between a group's replicas.

Messages sent during tick ``t`` are delivered at tick ``t+1``, filtered at
delivery time by the fault model (DESIGN.md §4): dead destinations lose
their mail, partitioned or dropped links deliver nothing. In-flight mail
survives a *sender* crash — it already left the node.

This is the seam the batched path replaces with a dense device-resident
mailbox (sim/state.py `Mailbox`).
"""

from __future__ import annotations

from typing import List

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.core import rpc
from raft_tpu_torch.utils import rng


class Transport:
    def __init__(self, cfg: RaftConfig, group: int):
        self.cfg = cfg
        self.g = group
        self._outbox: List[rpc.Msg] = []      # sent this tick, in flight
        # Test hook: extra delivery predicate (tick, src, dst) -> bool.
        # Production faults use the hash-based model below; scenario tests
        # (staged partitions, targeted drops) use this.
        self.link_filter = None

    def send(self, msg: rpc.Msg):
        self._outbox.append(msg)

    def deliver(self, tick: int, alive_now: List[bool]) -> List[List[rpc.Msg]]:
        """Return per-destination inboxes for this tick and rotate buffers.

        Called at the start of tick ``tick``, before any phase runs, so
        ``_outbox`` holds exactly the messages sent during tick
        ``tick - 1`` — the t+1 delivery the tick contract specifies.
        """
        cfg = self.cfg
        inboxes: List[List[rpc.Msg]] = [[] for _ in range(cfg.k)]
        nem_link = cfg.nem_link   # one program filter per tick, not
        for m in self._outbox:    # one per in-flight message
            if not alive_now[m.dst]:
                continue
            if self.link_filter is not None and not self.link_filter(
                    tick, m.src, m.dst):
                continue
            if rng.link_partitioned(cfg.seed, self.g, tick, m.src, m.dst,
                                    cfg.partition_u32, cfg.partition_epoch):
                continue
            if rng.link_dropped(cfg.seed, self.g, tick, m.src, m.dst,
                                cfg.drop_u32):
                continue
            if nem_link and not rng.nem_link_ok(
                    cfg.seed, nem_link, self.g, tick, m.src, m.dst,
                    cfg.k):
                continue   # nemesis link clause blocked it (DESIGN.md §14)
            inboxes[m.dst].append(m)
        self._outbox = []
        return inboxes
