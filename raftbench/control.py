"""The control of the check: the plain reference, with one guarantee the
configurations state broken, put in the program's place. A sound check
must call it not correct.

The guarantee broken is election safety: a voter grants every candidate
of its term, not only the first (`_on_rv_req` without its `voted_for`
test), so two candidates of one term can both win. Both configurations
state election safety (`tick_safety`), and raft5-sessions builds its
exactly-once sessions on the leader the election makes.

On the chip, at the cell's own size, on three seeds or more:

    python3 -m raftbench.control --workload raft5.steady --seeds 11,12,13

runs one universe of the cell's groups with the control in the program's
place (the reference tick on the card), samples as many groups as a run
judges (`--samples`), and prints each run's checks. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from raftbench import spec
from raftbench.runner import Runner
from raftbench.reference import recorder, run as ref_run, state, step
from raftbench.reference.config import RaftConfig
from raftbench.reference.step import (W, _last_log_term, _put,
                                      _reset_timer, _step_down)


def _on_rv_req_double_vote(cfg, ns, out, g, i, src: int, ib, gl):
    """`step._on_rv_req` with the one-vote-per-term test left out."""
    present = ib.rv_req_present[:, :, src]
    m_term = ib.rv_req_term[:, :, src]
    m_lli = ib.rv_req_lli[:, :, src]
    m_llt = ib.rv_req_llt[:, :, src]
    ns = _step_down(cfg, ns, m_term, present & (m_term > ns.term))
    llt = _last_log_term(cfg, ns)
    log_ok = (m_llt > llt) | ((m_llt == llt) & (m_lli >= ns.last_index))
    grant = present & (m_term == ns.term) & log_ok
    ns = ns._replace(voted_for=W(grant, src, ns.voted_for))
    ns = _reset_timer(cfg, ns, g, i, grant, gl[2])
    _put(out, "rv_resp_present", src, present, True)
    _put(out, "rv_resp_term", src, present, ns.term)
    _put(out, "rv_resp_granted", src, present, grant)
    return ns


@contextlib.contextmanager
def broken_guarantee():
    """The reference tick with the double vote, for the block's length."""
    keep = step._on_rv_req
    step._on_rv_req = _on_rv_req_double_vote
    try:
        yield
    finally:
        step._on_rv_req = keep


class ControlSystem(Runner):
    """The reference tick with `broken_guarantee`, driven as the program
    is (`system.System`'s interface), on the first of `devices` (default
    the first card)."""

    def __init__(self, fields: dict, groups: int, ticks: int, ring: int,
                 chips: int = 1, devices=None):
        self.cfg = RaftConfig(n_groups=groups, **fields)
        self.groups, self.ticks, self.ring = groups, ticks, ring
        devs = devices or ["cuda:0"]
        super().__init__([torch.device(devs[0])])
        self.chips = chips
        self.clients = self.cfg.clients_u32 != 0

    def build(self) -> None:
        pass

    def init(self, first_group: int):
        g, dev = self.groups, self.device
        st = state.init(self.cfg, g, device=dev, first_group=first_group)
        m = ref_run.metrics_init(g, clients=self.clients, device=dev)
        f = recorder.flight_init(g, self.ring, device=dev)
        return st, m, f

    def prun(self, st, m, f):
        with broken_guarantee():
            return recorder.run_recorded(self.cfg, st, self.ticks, 0, m, f)


def main(argv=None) -> int:
    from raftbench import run
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one universe each")
    p.add_argument("--samples", type=int, default=240,
                   help="groups judged per run (a run judges about 240)")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(cell, seed, 0.0, False, system_cls=ControlSystem,
                           warmup=False, samples_per_universe=args.samples)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
        rc |= int(out["correct"])   # the control must come out not correct
    return rc


if __name__ == "__main__":
    sys.exit(main())
