"""One process of the reference: runs the plain reference tick over a
list of groups, on the CPU, and writes what it produced.

    python3 -m raftbench.refworker IN.json OUT.npz

IN.json: {"fields": RaftConfig keyword arguments (seed included),
"ticks": T, "ring": R, "group_ids": [...]}. OUT.npz: "state.<leaf>"
([n, ...] per group), "metrics.<lane>" ([n]), "flight.<leaf>" ([R, n]),
and "ops" (the hash operations of the n groups) and "group_bytes" (one
group's bytes at semantic widths) for the roofline.

Imports nothing of the program: it rebuilds its groups from the config,
the seed and their global ids.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from raftbench import roofline
from raftbench.runner import tree_leaves
from raftbench.reference import recorder, run, state
from raftbench.reference.config import RaftConfig

# Metrics lanes that hold one value per group.
PER_GROUP_LANES = ("committed", "leaderless", "safety", "client_acked",
                   "client_retries")
# State leaves that hold u32 values (carried as int64 in [0, 2**32)).
U32_LEAVES = ("nodes.snap_digest", "nodes.digest",
              "mailbox.is_req_snap_digest")


def reference_run(fields: dict, ticks: int, ring: int, group_ids) -> dict:
    """The reference's State, per-group Metrics lanes and flight rows of
    `group_ids` after `ticks` ticks from tick 0, as numpy arrays, with
    their hash operations and one group's semantic bytes."""
    cfg = RaftConfig(n_groups=len(group_ids), **fields)
    n = len(group_ids)
    st0 = state.init(cfg, device="cpu", group_ids=group_ids)
    m = run.metrics_init(n, clients=cfg.clients_u32 != 0, device="cpu")
    f = recorder.flight_init(n, ring, device="cpu")
    st, m, f = recorder.run_recorded(cfg, st0, ticks, 0, m, f)
    st_leaves = tree_leaves(st)
    lanes = {k: v for k, v in tree_leaves(m).items() if k in PER_GROUP_LANES}
    fl = tree_leaves(f)
    out = {"state." + k: v.numpy() for k, v in st_leaves.items()}
    out.update({"metrics." + k: v.numpy() for k, v in lanes.items()})
    out.update({"flight." + k: v.numpy() for k, v in fl.items()})
    committed = int(m.committed.to(torch.int64).sum())
    out["ops"] = np.float64(roofline.run_ops(cfg, st0.group_id, ticks, st0,
                                             st, committed))
    out["group_bytes"] = np.int64(roofline.group_bytes(
        st_leaves, lanes, fl, U32_LEAVES))
    return out


def main(argv) -> int:
    torch.set_num_threads(1)
    job = json.loads(open(argv[1]).read())
    with torch.inference_mode():
        out = reference_run(job["fields"], job["ticks"], job["ring"],
                            job["group_ids"])
    np.savez(argv[2], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
