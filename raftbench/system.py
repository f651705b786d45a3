"""The system under test: `raft_tpu_torch`, driven as a user drives it.

The only module of the benchmark that imports the program. A universe is
`state.init` of its groups (`first_group` = its first global id),
`run.metrics_init`, `recorder.flight_init`, then `kernel.prun` on one
card or `kmesh.prun_sharded` over `mesh.make_mesh(chips)`: one launch
of the universe's ticks from tick 0, the State, Metrics and flight ring
back (whole, on the first card). The Metrics and the ring are then
copied into pinned host buffers (what a user reads, `runner.Runner`),
and the universe ends when they are there.

The program picks its own dials (layout, residency, narrow dtypes): the
config here holds only the cell's semantic fields.
"""

from __future__ import annotations

import contextlib

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder, trace
from raft_tpu_torch.parallel import kmesh, mesh as mesh_mod
from raft_tpu_torch.sim import kernel, run as run_mod, state as state_mod
from raftbench.runner import Runner


class System(Runner):
    """One cell's program: its config, its devices and its host buffers.

    `devices`: None takes the first `chips` cards (`mesh.make_mesh`);
    the CPU tests pass `["cpu"] * chips`, on which the program runs its
    plain tick in the kernel's place."""

    CSRC = kernel.CSRC   # the program's hand-written kernels' sources

    def __init__(self, fields: dict, groups: int, ticks: int, ring: int,
                 chips: int = 1, devices=None):
        self.cfg = RaftConfig(n_groups=groups, **fields)
        self.groups, self.ticks, self.ring = groups, ticks, ring
        super().__init__(mesh_mod.make_mesh(chips, devices))
        self.chips = chips
        self.clients = self.cfg.clients_u32 != 0

    def build(self) -> None:
        """Load (at a checkout's first run: compile) the kernel build of
        the cell's flag set, on a card."""
        if self.device.type == "cuda":
            kernel.load(kernel.features(self.cfg))

    @contextlib.contextmanager
    def tracing(self):
        """The program's tracer installed, without device times
        (`obs.trace.Tracer(device_times=False)`: no CUDA event, no wait),
        so that its spans are `raft_tpu_torch.<span>` profiler ranges;
        the tracer installed before restored on exit."""
        prev = trace.set_tracer(trace.Tracer(device_times=False))
        try:
            yield
        finally:
            trace.set_tracer(prev)

    def init(self, first_group: int):
        """A universe's start: (State, Metrics, Flight) of the cell's
        groups from global id `first_group`, on the first device."""
        g, dev = self.groups, self.device
        st = state_mod.init(self.cfg, g, device=dev, first_group=first_group)
        m = run_mod.metrics_init(g, clients=self.clients, device=dev)
        f = recorder.flight_init(g, self.ring, device=dev)
        return st, m, f

    def prun(self, st, m, f):
        """The universe's ticks from tick 0, in one launch per card:
        (State, Metrics, Flight) after them, whole on the first device."""
        if self.chips == 1:
            return kernel.prun(self.cfg, st, self.ticks, 0, m, f)
        return kmesh.prun_sharded(self.cfg, st, self.ticks, self.mesh, 0,
                                  m, f)
