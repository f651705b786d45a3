"""`scripts/torch_nemesis_search.py --device cpu` as a subprocess: a
budget-2 hunt with a persisted corpus and the cross-engine check (the
kernel's plain version on the CPU), the replay of the checked-in
`NEMESIS_repro_example.json`, a seeded violation shrunk to an artifact
the JAX package loads, and the refusals. No XLA compile."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from raft_tpu.nemesis import search as jsearch
from raft_tpu_torch.nemesis import search as nsearch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "NEMESIS_repro_example.json"
SCRIPT = ROOT / "scripts" / "torch_nemesis_search.py"


def _script(*args, cwd=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(SCRIPT), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_script_hunt_on_the_cpu(tmp_path):
    out = _script("--device", "cpu", "--budget", "2", "--groups", "8",
                  "--ticks", "32", "--corpus", str(tmp_path / "corpus"),
                  "--check-kernel", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "engines bit-identical under the best program" in out.stderr
    assert len(nsearch.load_corpus(str(tmp_path / "corpus"))) >= 2


def test_script_replays_the_example():
    out = _script("--device", "cpu", "--replay", str(EXAMPLE))
    assert out.returncode == 0, out.stderr
    assert "replay ok: tick 13" in out.stderr


def test_script_seeded_violation_writes_a_replayable_artifact(tmp_path):
    path = tmp_path / "seeded.json"
    out = _script("--device", "cpu", "--seed-violation", "9", "--ticks",
                  "16", "--groups", "2", "--out", str(path))
    assert out.returncode == 0, out.stderr
    cfg, art = jsearch.load_reproducer(str(path))
    assert art["violation"]["tick"] == 9
    assert art["violation"]["leaf"] == ".nodes.term"
    assert art["engines"] == "torch-vs-seeded-corruption"
    out = _script("--device", "cpu", "--replay", str(path))
    assert out.returncode == 0, out.stderr


def test_script_refusals(tmp_path, monkeypatch):
    """An incomplete mcheck artifact (a complete one replays:
    tests/test_torch_verify.py), and the card when none is there."""
    mcheck = tmp_path / "mcheck.json"
    mcheck.write_text(json.dumps({"kind": "mcheck-reproducer"}))
    out = _script("--device", "cpu", "--replay", str(mcheck))
    assert out.returncode == 2 and "verify/mcheck" in out.stderr
    sys.path.insert(0, str(SCRIPT.parent))
    try:
        import torch_nemesis_search
    finally:
        sys.path.remove(str(SCRIPT.parent))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_nemesis_search.main(["--budget", "1"]) == 2
