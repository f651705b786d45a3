"""Static metric-surface parity check of the PyTorch/CUDA port: the run
loop's `Metrics`, the kernel wire's per-group lanes and `acc` rows, the
flight recorder's `Flight` and `FLIGHT_LEAVES`, and `ClientState` and
its leaf registries must stay aligned in name, dtype, order and shape:
`kfinish`'s decode and every comparison of the kernel with the plain
tick assume it. Exits 1 on any drift, 0 when aligned; no card needed.

It is a thin wrapper over the contract auditor's pass
(`raft_tpu_torch.analysis.contracts.metric_parity_problems`);
`scripts/torch_static_audit.py` runs it with the rest of the contracts.

    python3 scripts/torch_check_metric_parity.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def check() -> list[str]:
    """The parity problems (empty: aligned)."""
    from raft_tpu_torch.analysis.contracts import metric_parity_problems
    return metric_parity_problems()


def main() -> int:
    problems = check()
    if problems:
        for p in problems:
            print(f"METRIC PARITY DRIFT: {p}")
        return 1
    print("metric parity ok: Metrics == the wire's metric lanes + acc's "
          "rows (client lanes gated); Flight == FLIGHT_LEAVES; "
          "ClientState == CLIENT_LEAVES + ADMISSION_LEAVES; all leaves "
          "i32 at wire shapes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
