"""What every system the harness drives shares: the devices, the copy of
a universe's Metrics and flight ring to the host, the sampled groups'
State, the peak memory. `system.System` (the program) and
`control.ControlSystem` (the reference with a guarantee broken) build
on it; neither this module nor the control imports the program."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def tree_leaves(tree, prefix: str = "") -> dict:
    """{dot path: tensor} of a NamedTuple tree, None leaves left out."""
    out = {}
    for f in tree._fields:
        v = getattr(tree, f)
        if v is None:
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(tree_leaves(v, f"{prefix}{f}."))
        else:
            out[prefix + f] = v
    return out


class Runner:
    """A universe runner on `mesh` (a tuple of torch devices; the first
    holds a universe's start and its results)."""

    CSRC = None   # the CUDA sources whose kernels are the system's own

    def __init__(self, mesh):
        self.mesh = tuple(mesh)
        self.device = self.mesh[0]
        self.host = None
        self.cfgs = {}

    def use_seed(self, seed: int) -> None:
        """Run the next universes with the universe seed `seed`: `cfg`
        with that seed (one config object a seed, made at its first use)."""
        if seed not in self.cfgs:
            self.cfgs[seed] = dataclasses.replace(self.cfg, seed=seed)
        self.cfg = self.cfgs[seed]

    def tracing(self):
        """A context inside which the system records its own spans as
        profiler ranges: none here."""
        return contextlib.nullcontext()

    def fetch(self, m, f) -> dict:
        """Copy the Metrics and the flight ring to the host (pinned
        buffers made at the first call, reused) and wait for them.
        Returns {"metrics.<leaf>" | "flight.<leaf>": host tensor}."""
        leaves = {**{"metrics." + k: v for k, v in tree_leaves(m).items()},
                  **{"flight." + k: v for k, v in tree_leaves(f).items()}}
        if self.host is None:
            pin = self.device.type == "cuda"
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=pin)
                         for k, v in leaves.items()}
        for k, v in leaves.items():
            self.host[k].copy_(v, non_blocking=True)
        self.synchronize()
        return self.host

    def synchronize(self) -> None:
        for d in self.mesh:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def sample_state(self, st, idx: torch.Tensor) -> dict:
        """{dot path: host tensor [len(idx), ...]}: the State leaves of
        the groups `idx` (positions in the universe), gathered on the
        device into one int64 block and copied to the host at once."""
        leaves = tree_leaves(st)
        n = idx.numel()
        idx = idx.to(self.device)
        parts = [v.index_select(0, idx).reshape(n, -1).to(torch.int64)
                 for v in leaves.values()]
        flat = torch.cat(parts, dim=1).cpu()
        out, at = {}, 0
        for (k, v), p in zip(leaves.items(), parts):
            w = p.shape[1]
            out[k] = flat[:, at:at + w].reshape(
                (n,) + tuple(v.shape[1:])).to(v.dtype)
            at += w
        return out

    def memory_peak_bytes(self) -> int:
        cards = [d for d in self.mesh if d.type == "cuda"]
        return max((torch.cuda.max_memory_allocated(d) for d in cards),
                   default=0)
