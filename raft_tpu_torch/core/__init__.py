"""The CPU oracle: classical Node / Transport / Cluster Raft, one group
at a time, in plain Python (the JAX package's `core/`, copied). Its
per-tick snapshots are what the batched tick is held to
(`obs.triage.oracle_divergence`)."""

from raft_tpu_torch.core.node import Node
from raft_tpu_torch.core.transport import Transport
from raft_tpu_torch.core.cluster import Cluster

__all__ = ["Node", "Transport", "Cluster"]
