"""raft_tpu_torch — the batched Raft simulator on PyTorch and CUDA.

A port of the JAX package `raft_tpu` to one NVIDIA H100, slice by slice.
It imports nothing of that package: it keeps its own copies of the
config, the counter-based hashes and the invariants, so its State and
Metrics can be held bit-identical to the reference at the same
(cfg, seed, G, ticks).

- ``sim.step.tick`` / ``sim.run.run``: the plain PyTorch tick and loop.
- ``sim.kernel``: the fused-chunk CUDA kernel (``csrc/fused_chunk.cu``)
  behind ``kinit``/``kstep``/``kfinish``/``prun``, with the packed wire's
  codec kernels (``csrc/wire_codec.cu``) and the byte model.
- ``parallel.cohort``: the fleet's wire in host memory, streamed through
  one card (``prun_streamed``) or a mesh (``prun_streamed_sharded``);
  ``parallel.mesh`` / ``parallel.kmesh``: the groups axis sharded over a
  mesh of devices, one process driving them all (``run_sharded``,
  ``prun_sharded``).
- ``sim.checkpoint``: save and load, in the JAX package's file format.
- ``core``: the CPU oracle; ``obs.triage``: divergence bisection and the
  oracle differential; ``nemesis.search``: the adversarial search,
  shrinker and reproducers (``scripts/torch_nemesis_search.py``).
- ``analysis.bytemodel``: the wire's and the resident State's bytes per
  group, derived and reconciled against ``sim.kernel``'s model.
- ``obs.manifest`` (run records), ``obs.roofline`` (the H100 bound of a
  run and its attainment), ``obs.trace`` (timeline spans on every kernel
  launch, the heartbeat) and ``obs.history`` (the trajectory and its
  gate, ``scripts/torch_bench_history.py``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from raft_tpu_torch.config import RaftConfig

__all__ = ["RaftConfig"]
