"""Run manifests: one JSONL provenance record per measured run, so every
published number carries its config, versions, card and roofline stamp
(the JAX package's `obs/manifest.py`).

Schema (one JSON object per line; `schema` bumps on a breaking change):

    schema        1
    segment       run name, e.g. "throughput" / "config-4 fault run"
    unix_time     emission time (host clock, seconds)
    config_hash   `config_hash(cfg)`
    config        the full RaftConfig dict
    torch, cuda   `torch.__version__`, `torch.version.cuda` (None on a
                  CPU build)
    device        "cuda:<card name>" or "cpu", passed in by the caller
    power_limit_w the card's power limit in watts (nvidia-smi
                  `power.limit`), when the caller passes it: a rate on
                  the card is read beside the limit it ran under
    mesh_shape, groups_per_device
                  null until the caller fills them
    the registries below, present in every record and null until filled
    ...           caller fields: engine, n_groups, ticks, rates, walls

The record goes to the file the caller names (appended); `path="-"`
writes nothing. The record is returned either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

from raft_tpu_torch.config import LAYOUT_FIELDS, NARROW_FIELDS, STREAM_FIELDS

# The key registries, letter for letter the JAX package's: each key is in
# every record from emission (null until the caller fills it), and
# `obs.history.backfill_record` adds it as null to an older record.
# The roofline stamp and the trace file of the run's process.
ROOFLINE_KEYS = ("predicted_rounds_per_sec", "attainment_pct", "bound",
                 "trace_path")

# The wire-layout dials (config.LAYOUT_FIELDS) the run's kernel used.
PACKING_KEYS = ("pack_bools", "pack_ring", "alias_wire", "wire_hist")

# The nemesis program the universe ran under: its hash and its clauses.
NEMESIS_KEYS = ("nemesis_program_hash", "nemesis_clauses")

# The residency dials (config.STREAM_FIELDS) and the predicted and
# measured overlap of the streamed pipeline (obs.roofline
# `stream_segment_fields`).
STREAM_KEYS = ("stream_groups", "cohort_blocks",
               "overlap_efficiency_predicted",
               "overlap_efficiency_measured")

# The device axis of the streamed pipeline (one device in the port).
STREAM_MESH_KEYS = ("stream_devices", "stream_blocks_per_device",
                    "overlap_efficiency_per_device_predicted",
                    "overlap_efficiency_per_device_measured",
                    "stream_slowest_device")

# The narrow dials (config.NARROW_FIELDS) and the resident bytes per
# group they give (obs.roofline `narrow_segment_fields`).
NARROW_KEYS = ("narrow_scalars", "narrow_ring", "narrow_mailbox",
               "narrow_clients", "donate_scan",
               "narrow_resident_bytes_per_group")

# The storage-pressure knee: the largest offered load meeting the ack
# SLO, the shed rate there, and the pressure program's hash.
PRESSURE_KEYS = ("knee_ops_per_sec", "shed_rate_at_knee",
                 "pressure_program_hash")

ALL_KEYS = (ROOFLINE_KEYS + PACKING_KEYS + NEMESIS_KEYS + STREAM_KEYS
            + STREAM_MESH_KEYS + NARROW_KEYS + PRESSURE_KEYS)


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


def _versions():
    import torch
    return torch.__version__, torch.version.cuda


def emit_manifest(segment: str, cfg, path: str, device: str | None = None,
                  power_limit_w: float | None = None, **fields) -> dict:
    """Append one record for `segment` under `cfg` to `path` ("-": no
    write) and return it. The caller passes `device` and the power limit:
    emitting never probes the card."""
    tv, cv = _versions()
    rec = {"schema": 1, "segment": segment,
           "unix_time": round(time.time(), 3),
           "config_hash": config_hash(cfg),
           "config": dataclasses.asdict(cfg),
           "torch": tv, "cuda": cv, "device": device,
           "power_limit_w": power_limit_w,
           "mesh_shape": None, "groups_per_device": None,
           **{k: None for k in ALL_KEYS}}
    rec.update(fields)
    if path != "-":
        with open(path, "a") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec
