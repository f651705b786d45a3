"""One short run of each one-card cell on the card, untraced and traced,
as the benchmark command runs it: `correct`, the cell's metrics, the traced
run's device fields and breakdown. Skips without a card.

    python -m pytest raftbench/tests -m cuda -q     # on the card
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from raftbench import spec

ONE_CARD = [w["name"] for w in spec.load_benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(name: str, seed: int, trace: int) -> dict:
    p = subprocess.run([sys.executable, "-m", "raftbench.run", "--workload",
                        name, "--seed", str(seed), "--seconds", "2",
                        "--trace", str(trace)], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_short_run_on_the_card_is_correct(card, name):
    out = _run(name, 2 ** 31 + 101, 0)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.cell(name).end_to_end}
    assert out["device"]["platform"] == "gpu"
    traced = _run(name, 2 ** 31 + 103, 1)
    assert traced["correct"] is True
    assert traced["device"]["busy_s"] > 0
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "kernel_ms_per_universe" in traced["metrics"]
