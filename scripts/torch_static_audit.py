"""Static audit of the PyTorch port: its registries, the kernel's field
enum, the gating table, the shard rule, checkpoint coverage, the byte
model and the lint, and with `--level deep` the model checker's smoke
and the stream-ordering hazard prover; no card needed. The body is
`raft_tpu_torch.analysis.cli` (also the `raft-tpu-torch-audit` console
script).

    python scripts/torch_static_audit.py                # rc != 0 on drift
    python scripts/torch_static_audit.py --level deep   # + mcheck, hazards
    python scripts/torch_static_audit.py --json         # the whole report
    python scripts/torch_static_audit.py --bytes        # per-leaf bytes
    python scripts/torch_static_audit.py --inject-drift ghost   # rc 1
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable as `python scripts/...`

from raft_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
