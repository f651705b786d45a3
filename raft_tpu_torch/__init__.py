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
  one card (``prun_streamed``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from raft_tpu_torch.config import RaftConfig

__all__ = ["RaftConfig"]
