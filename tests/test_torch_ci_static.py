"""scripts/torch_ci_static.sh, the port's pre-push gate: it exits 0 on the
committed trajectory (scripts/torch_bench_manifest.jsonl) and baseline
(scripts/torch_bench_baseline.json), and 2 when a later headline point
is planted 30% below the best (the history step alone, and the whole
script on a copy of its inputs); the committed records are full-size
card runs of bench_torch.py with default flags, each with its card,
power limit, rates and gate verdicts; the baseline is what
`torch_bench_history.py --write-baseline` writes from them. No card and
no XLA program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from raft_tpu_torch.obs import history

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
MANIFEST = SCRIPTS / "torch_bench_manifest.jsonl"
BASELINE = SCRIPTS / "torch_bench_baseline.json"
HISTORY = SCRIPTS / "torch_bench_history.py"

# bench_torch.py's segments and the manifest key of each one's rate
# (obs.history's series, and the gray-failure and knee segments).
RATES = {"throughput": "rounds_per_sec",
         "config-4 fault run": "rounds_per_sec",
         "config-5 fault mix": "rounds_per_sec",
         "election-rounds": "elections_per_sec",
         "reads": "reads_per_sec",
         "client-slo fault mix": "client_ops_per_sec",
         "nemesis gray mix": "rounds_per_sec",
         "pressure knee": None}


def records(path=MANIFEST) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines()
            if ln.strip()]


def test_gate_passes_on_the_committed_trajectory():
    proc = subprocess.run(["bash", str(SCRIPTS / "torch_ci_static.sh")],
                          capture_output=True, text=True, timeout=600,
                          env={k: v for k, v in os.environ.items()
                               if k != "JAX_PLATFORMS"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def _planted(tmp_path) -> Path:
    """A copy of the trajectory with a later headline point 30% below
    the latest one."""
    recs = records()
    head = [r for r in recs if r["segment"] == "throughput"][-1]
    low = dict(head, rounds_per_sec=0.7 * head["rounds_per_sec"],
               unix_time=max(r["unix_time"] for r in recs) + 1)
    path = tmp_path / "torch_bench_manifest.jsonl"
    path.write_text(MANIFEST.read_text() + json.dumps(low) + "\n")
    return path


def test_history_step_exits_2_on_a_planted_regression(tmp_path):
    path = _planted(tmp_path)
    proc = subprocess.run(
        [sys.executable, str(HISTORY), "--manifest", str(path), "--check",
         "--threshold", "0.15", "--baseline", str(BASELINE)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "REGRESSION: throughput [kernel]" in proc.stderr


def test_gate_script_exits_2_on_a_planted_regression(tmp_path):
    """The whole script, on a copy of its inputs with the planted point:
    the history step fails it before the audit runs."""
    (tmp_path / "scripts").mkdir()
    for name in ("torch_ci_static.sh", "torch_bench_history.py",
                 "torch_static_audit.py", "torch_bench_baseline.json"):
        shutil.copy(SCRIPTS / name, tmp_path / "scripts" / name)
    shutil.move(_planted(tmp_path),
                tmp_path / "scripts" / "torch_bench_manifest.jsonl")
    (tmp_path / "raft_tpu_torch").symlink_to(ROOT / "raft_tpu_torch")
    proc = subprocess.run(["bash", str(tmp_path / "scripts" /
                                       "torch_ci_static.sh")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "REGRESSION: throughput [kernel]" in proc.stderr


def test_committed_records_are_full_size_card_runs():
    recs = records()
    assert recs, "the trajectory is empty"
    for r in recs:
        assert r["device"].startswith("cuda:"), r["device"]
        assert r["power_limit_w"] and r["power_limit_w"] > 0
        assert r["engine"].startswith("cuda"), r["engine"]
        assert r["state_identical"] and r["metrics_identical"] \
            and r["flight_identical"], r["segment"]
        assert r["safety_ok"] is True
        assert r["n_groups"] >= history.QUICK_GROUP_FLOOR
        # default flags: no packed or streamed point in the series
        assert not (r["pack_bools"] or r["pack_ring"] or r["alias_wire"]
                    or r["stream_groups"]) and r["wire_hist"]
        assert r["segment"] in RATES, r["segment"]
        key = RATES[r["segment"]]
        if key is not None:
            assert r[key] and r[key] > 0, (r["segment"], key)
        assert r["attainment_pct"] and r["attainment_pct"] > 0
    segs = {r["segment"] for r in recs}
    assert segs == set(RATES)
    rows = history.load_history(str(MANIFEST))
    assert {r["segment"] for r in rows} == set(RATES) - {
        "nemesis gray mix", "pressure knee"}
    assert all(r["engine"] == "kernel" for r in rows)


def test_baseline_is_written_from_the_trajectory(tmp_path):
    out = tmp_path / "baseline.json"
    proc = subprocess.run(
        [sys.executable, str(HISTORY), "--manifest", str(MANIFEST),
         "--write-baseline", str(out)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(out.read_text()) == json.loads(BASELINE.read_text())


def test_gate_is_executable():
    assert os.access(SCRIPTS / "torch_ci_static.sh", os.X_OK)
