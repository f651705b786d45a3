"""Where a tick's time goes, in the PyTorch/CUDA port.

Two views, each labelled as what it is:

- The plain reference's attribution (the JAX package's
  `scripts/perf_probe.py` ported): a 200-tick chunk of the plain
  PyTorch tick (`raft_tpu_torch.sim.step.tick` and the run loop's
  metrics) timed on the card with CUDA events, with one part of the
  tick knocked out per variant by patching `sim.step`'s `_handlers`,
  `_phase_t`, `_phase_c` or `_phase_a`, or by thinning the metrics. The
  difference from `full` is that part's cost in the plain tick, which is
  the reference the kernel is held to and launch-bound on the card: it
  says nothing of the kernel's speed.
- `--kernel`: the fused-chunk kernel's own split at the bench's shapes
  (headline 100,000, config-4 50,000, election rounds 10,000 groups;
  `chip_smoke.all_runs()`'s base-build runs): clock64() cycles per tile
  and tick before the node steps (buffer preparation, faults, filters),
  in them, and in the group-level tail, from
  `scripts/torch_kernel_ab.py`'s instrumented build (`phase_cycles`).

Usage (on the card; rc 2 without one):
    python3 scripts/torch_perf_probe.py [--groups 10000] [--variants ...]
        [--kernel]
Prints the card (nvidia-smi) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import raft_tpu_torch.sim.step as step_mod  # noqa: E402
from raft_tpu_torch.config import RaftConfig  # noqa: E402
from raft_tpu_torch.sim import run as run_mod  # noqa: E402
from raft_tpu_torch.sim import state as state_mod  # noqa: E402

CHUNK = 200
VARIANTS = ("full", "nometrics", "nohist", "nophaseD", "nophaseT",
            "nophaseC", "noapply")
# The names the variants patch, and their originals.
ORIG = dict(_handlers=step_mod._handlers, _phase_t=step_mod._phase_t,
            _phase_c=step_mod._phase_c, _phase_a=step_mod._phase_a)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def restore():
    """Every patched name of `sim.step` back to its original."""
    for name, fn in ORIG.items():
        setattr(step_mod, name, fn)


def _commit_only(cfg, ns, g, i, t):
    """Phase A's commit advance alone: no apply, digest or compaction."""
    n = step_mod.quorum.commit_candidate(ns.match_index, ns.last_index, i,
                                         cfg.k, cfg.majority)
    advance = ((ns.role == step_mod.LEADER) & (n > ns.commit)
               & (step_mod._term_at(cfg, ns, n) == ns.term))
    return ns._replace(commit=torch.where(advance, n, ns.commit))


def _digest_frozen(cfg, ns, g, i, t):
    """Phase A in full but the digest chain's output dropped."""
    return ORIG["_phase_a"](cfg, ns, g, i, t)._replace(digest=ns.digest)


def apply_variant(name: str) -> str:
    """Patch `sim.step` for the named variant (after restoring every
    name); returns the metrics mode: "full", "nohist" or "none".
    Variants: full, nometrics, nohist, nophaseD (no handler), noh_<rpc>
    (one handler out: ae_req, ae_resp, rv_req, rv_resp, is_req,
    is_resp), nodigest, nophaseT, nophaseC, noapply."""
    restore()
    if name == "full":
        return "full"
    if name == "nometrics":
        return "none"
    if name == "nohist":
        return "nohist"
    if name == "nophaseD":
        step_mod._handlers = lambda cfg: ()
        return "full"
    if name.startswith("noh_"):
        target = "_on_" + name[4:]
        if target not in vars(step_mod):
            raise ValueError(f"no handler {target} in sim.step")
        step_mod._handlers = lambda cfg: tuple(
            h for h in ORIG["_handlers"](cfg) if h.__name__ != target)
        return "full"
    if name == "nodigest":
        step_mod._phase_a = _digest_frozen
        return "full"
    if name == "nophaseT":
        step_mod._phase_t = lambda cfg, ns, out, g, i, t: ns
        return "full"
    if name == "nophaseC":
        step_mod._phase_c = (lambda cfg, ns, g, i, t, csub=None,
                             cpay=None: ns)
        return "full"
    if name == "noapply":
        step_mod._phase_a = _commit_only
        return "full"
    raise ValueError(name)


def advance(cfg, st, m, t0: int, n_ticks: int, mode: str):
    """`n_ticks` plain ticks from `t0` with the metrics of `mode`."""
    if mode == "full":
        return run_mod.run(cfg, st, n_ticks, t0, m)
    for t in range(t0, t0 + n_ticks):
        st = step_mod.tick(cfg, st, t)
        if mode == "nohist":
            m = m._replace(committed=torch.maximum(
                m.committed, st.nodes.commit.amax(dim=1)))
    return st, m


def run_variant(name: str, n_groups: int, device, warm_ticks: int = 2):
    """ms per tick of one 200-tick chunk of the plain tick under `name`
    on the card (CUDA events), after `warm_ticks` ticks of warm-up."""
    mode = apply_variant(name)
    try:
        cfg = RaftConfig(seed=42)
        st = state_mod.init(cfg, n_groups, device=device)
        m = run_mod.metrics_init(n_groups, device=device)
        st, m = advance(cfg, st, m, 0, warm_ticks, mode)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        st, m = advance(cfg, st, m, warm_ticks, CHUNK, mode)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / CHUNK
    finally:
        restore()
    log(f"plain reference {name:10s} G={n_groups:7d}: {ms:8.2f} ms/tick "
        f"({1e3 / ms:7.1f} ticks/s)")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="+",
                    default=[50_000, 100_000])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--kernel", action="store_true",
                    help="also the kernel's cycles per tile and tick by "
                         "phase at the bench's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("torch_perf_probe: CUDA is not available")
        return 2
    import chip_smoke
    card = chip_smoke.gpu_line()
    dev = torch.device("cuda")
    log(f"card: {card}")
    plain = {}
    for g in args.groups:
        for v in args.variants:
            plain[f"{v}@{g}"] = run_variant(v, g, dev)
    attribution = {}
    for g in args.groups:
        full = plain.get(f"full@{g}")
        if full is None:
            continue
        log(f"-- G={g}: the plain reference's attribution against full "
            f"({full:.2f} ms/tick; not the kernel's speed)")
        for v in args.variants:
            if v != "full":
                saved = full - plain[f"{v}@{g}"]
                attribution[f"{v}@{g}"] = saved
                log(f"   {v:10s}: {saved:7.2f} ms/tick attributable")
    cycles = None
    if args.kernel:
        import torch_kernel_ab
        cycles = torch_kernel_ab.phase_cycles(chip_smoke.all_runs())
    print(card)
    print(json.dumps({"card": card,
                      "plain_reference_ms_per_tick": plain,
                      "plain_reference_attribution_ms": attribution,
                      "kernel_cycles_per_tile_tick": cycles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
