"""The CUDA stream primitives of the launch path, as one table.

`parallel/stream_sched.py`, `parallel/cohort.py`, `parallel/kmesh.py`
and `kernel.krun` order their copies and launches by hand, across a
compute stream and two copy streams per shard. They reach every
primitive that orders work on the card through `cuda`, the active table,
and never through `torch.cuda` directly:

- streams: `stream` (a new one), `own_stream` (a shard's own, made once
  per process), `current_stream`, and `use`, the `torch.cuda.stream`
  context;
- events: `event` (timed), `record`, `wait_stream`, `wait_event`;
- host waits: `event_sync` and `device_sync`;
- memory: `empty` (an int32 slice on the current stream), `pinned`,
  `record_stream`;
- the copies: `copy`, the non-blocking `copy_` between host and card
  (synchronous between host tensors), and `to_device`, a synchronous
  copy onto a CPU shard;
- the wire form: `kinit` (`kernel.kinit`), whose accumulator a streamed
  shard's first launch reads, on the card's current stream;
- the launch: `kstep` (`kernel.kstep`), and `join`, which marks that the
  caller's stream now reads a shard's outputs (no call on the card).

`Cuda` makes exactly the calls the drivers made before there was a
table. verify/hazards.py swaps in a recording table to prove the
pipelines' orderings: fakes on CPU tensors, so that the real loops run
without a card, or the real calls, each recorded before it is made.
The optional `groups` of `copy` and `to_device` names the fleet's
groups a slice holds, for the recorder; it changes no call.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sim.state import I32


class Cuda:
    """The table's real entries: each one the `torch.cuda` call, or
    tensor method, the launch path makes."""

    def __init__(self):
        self._own = {}

    def stream(self, device):
        return torch.cuda.Stream(device)

    def own_stream(self, device, j: int):
        """Shard `j`'s own stream on `device`, made once per table."""
        key = (torch.device(device), j)
        if key not in self._own:
            self._own[key] = self.stream(device)
        return self._own[key]

    def current_stream(self, device):
        return torch.cuda.current_stream(device)

    def use(self, stream):
        return torch.cuda.stream(stream)

    def event(self):
        return torch.cuda.Event(enable_timing=True)

    def record(self, event, stream):
        event.record(stream)

    def wait_stream(self, waiter, other):
        waiter.wait_stream(other)

    def wait_event(self, stream, event):
        stream.wait_event(event)

    def event_sync(self, event):
        event.synchronize()

    def device_sync(self, device):
        torch.cuda.synchronize(device)

    def empty(self, shape, device):
        return torch.empty(shape, dtype=I32, device=device)

    def pinned(self, tensor) -> bool:
        return tensor.is_pinned()

    def record_stream(self, tensor, stream):
        tensor.record_stream(stream)

    def copy(self, dst, src, groups=None, non_blocking: bool = True):
        dst.copy_(src, non_blocking=non_blocking)

    def to_device(self, src, device, groups=None):
        return src.to(device, copy=True)

    def kinit(self, cfg, st, metrics=None, flight=None):
        from raft_tpu_torch.sim import kernel
        return kernel.kinit(cfg, st, metrics, flight)

    def kstep(self, cfg, leaves, t0: int, n_ticks: int):
        from raft_tpu_torch.sim import kernel
        return kernel.kstep(cfg, leaves, t0, n_ticks)

    def join(self, tensors):
        """The caller's stream reads `tensors` from here on: nothing to
        do on the card (the drivers order it with `wait_stream`)."""


#: The active table. verify/hazards.py `capture` replaces it for the
#: length of a `with` block; callers look it up at each call.
cuda = Cuda()
