"""Static analysis of the port: `bytemodel.py`, the derived byte model of
the wire and of the resident State, reconciled against `sim/kernel.py`."""

from raft_tpu_torch.analysis import bytemodel

__all__ = ["bytemodel"]
