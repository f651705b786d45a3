"""Run provenance: `config_hash`, the stable short hash of a semantic
config that reproducer artifacts and checkpoints are keyed by (the JAX
package's `obs/manifest.py` `config_hash`; the rest of its manifest is
not ported yet)."""

from __future__ import annotations

import dataclasses
import hashlib
import json

from raft_tpu_torch.config import LAYOUT_FIELDS, NARROW_FIELDS, STREAM_FIELDS


def config_hash(cfg) -> str:
    """Stable short hash of the semantic config: two runs with equal
    hashes simulated the same universe schedule, seed included. The
    layout, residency and narrow dials are left out: they never change
    what an engine computes, so an ablation pair over one of them hashes
    equal. Equal to the JAX package's hash of the same fields."""
    d = dataclasses.asdict(cfg)
    for k in LAYOUT_FIELDS + STREAM_FIELDS + NARROW_FIELDS:
        d.pop(k, None)
    blob = json.dumps(d, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]
