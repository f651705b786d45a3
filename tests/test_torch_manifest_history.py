"""The port's run manifests and bench history (`raft_tpu_torch.obs.manifest`,
`obs.history`, `scripts/torch_bench_history.py`) against the JAX
package's: the key registries letter for letter, the record's key set
(`torch` and `cuda` for `jax` and `jaxlib`, plus `power_limit_w`), the
history rows of the same records (a card's `cuda:` device for the port,
`tpu:` for the reference), the skip of off-card and smoke-size records,
and the script's table and gate. No XLA program, no card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.obs import history as jhistory
from raft_tpu.obs import manifest as jmanifest
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import history, manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_bench_history.py")
REGISTRIES = ("ROOFLINE_KEYS", "PACKING_KEYS", "NEMESIS_KEYS",
              "STREAM_KEYS", "STREAM_MESH_KEYS", "NARROW_KEYS",
              "PRESSURE_KEYS")
# The engine classes of the two packages, port -> reference.
CLASSES = {"kernel": "pallas", "plain": "xla"}


@pytest.mark.parametrize("name", REGISTRIES)
def test_registries_letter_for_letter(name):
    assert getattr(manifest, name) == getattr(jmanifest, name)


def test_record_keys_and_write(tmp_path):
    knobs = dict(seed=43, crash_prob=0.3, partition_prob=0.2, drop_prob=0.02)
    rec = manifest.emit_manifest("throughput", RaftConfig(**knobs), "-",
                                 device="cuda:NVIDIA H100 80GB HBM3",
                                 power_limit_w=700.0, rounds_per_sec=1.0)
    ref = jmanifest.emit_manifest("throughput", JaxConfig(**knobs),
                                  device="tpu:x", path="-",
                                  rounds_per_sec=1.0)
    assert set(rec) == (set(ref) - {"jax", "jaxlib"}) | {
        "torch", "cuda", "power_limit_w"}
    assert rec["config"] == ref["config"]
    assert rec["config_hash"] == ref["config_hash"]
    assert rec["power_limit_w"] == 700.0 and rec["torch"]
    assert all(rec[k] is None for k in manifest.ALL_KEYS)
    path = tmp_path / "m.jsonl"
    for seg in ("a", "b"):
        manifest.emit_manifest(seg, RaftConfig(), str(path), device="cpu")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["segment"] for r in lines] == ["a", "b"]
    assert history.backfill_record({"segment": "x"}).keys() \
        == jhistory.backfill_record({"segment": "x"}).keys()


def _records(platform, kernel_engine, plain_engine):
    """Rate-bearing and other records, in emission order."""
    dev = f"{platform}:card"
    base = dict(schema=1, device=dev, n_groups=100_000)
    return [
        dict(base, segment="throughput", engine=kernel_engine,
             rounds_per_sec=3.0e8, unix_time=1.0, attainment_pct=0.5,
             bound="bytes"),
        dict(base, segment="throughput", engine=kernel_engine,
             rounds_per_sec=2.0e8, unix_time=2.0),
        dict(base, segment="config-4 fault run", engine=plain_engine,
             rounds_per_sec=5.0e5, unix_time=3.0),
        dict(base, segment="election-rounds", engine=kernel_engine,
             elections_per_sec=9.0e6, unix_time=4.0, n_groups=10_000),
        dict(base, segment="client-slo fault mix", engine=kernel_engine,
             client_ops_per_sec=2.0e8, unix_time=5.0),
        dict(base, segment="nemesis gray mix", engine=kernel_engine,
             rounds_per_sec=1.0e8, unix_time=6.0),   # not trended
        dict(base, segment="throughput", engine=kernel_engine,
             rounds_per_sec=None, unix_time=7.0),    # no rate
    ]


def _write(dirpath, recs):
    dirpath.mkdir(exist_ok=True)
    path = dirpath / "manifest.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n{torn")
    return str(path)


def test_history_rows_equal_the_reference(tmp_path):
    port = _write(tmp_path / "port", _records("cuda", "cuda-fused-chunk",
                                              "plain (cuda mismatch!)"))
    ref = _write(tmp_path / "ref", _records("tpu", "pallas-fused-chunk",
                                            "xla-scan"))
    rows = history.load_history(port)
    jrows = jhistory.load_history(str(tmp_path / "ref"), manifest=ref)
    assert len(rows) == 5
    assert [dict(r, engine=CLASSES[r["engine"]]) for r in rows] == jrows
    assert history.regressions(rows, 0.15) \
        == [dict(r, engine=r["engine"].replace("pallas", "kernel"))
            for r in jhistory.regressions(jrows, 0.15)]
    assert history.regressions(rows, 0.15)[0]["drop_pct"] == 33.3
    assert history.trend_table(rows).replace("[kernel]", "[pallas]") \
        .replace("[plain]", "[xla]") == jhistory.trend_table(jrows)


def test_off_card_and_smoke_records_are_skipped(tmp_path, capsys):
    recs = [
        dict(segment="throughput", engine="cuda", rounds_per_sec=1.0,
             device="tpu:card", n_groups=100_000),          # a TPU
        dict(segment="throughput", engine="plain", rounds_per_sec=2.0,
             device="cpu", n_groups=100_000),               # the CPU
        dict(segment="throughput", engine="cuda", rounds_per_sec=3.0,
             device="cuda:card", n_groups=1_000),           # smoke size
        dict(segment="throughput", engine="cuda", rounds_per_sec=4.0,
             device="cuda:card", n_groups=100_000),
    ]
    rows = history.parse_manifest_file(_write(tmp_path / "m", recs))
    assert [r["value"] for r in rows] == [4.0]
    assert "skipped 3 off-card/smoke-shape record(s)" \
        in capsys.readouterr().err


def test_script_table_and_gate(tmp_path):
    ok = _write(tmp_path / "ok", _records("cuda", "cuda", "plain")[2:])
    bad = _write(tmp_path / "bad", _records("cuda", "cuda", "plain"))

    def script(*args):
        return subprocess.run([sys.executable, SCRIPT, *args],
                              capture_output=True, text=True, timeout=120)

    r = script("--manifest", ok)
    assert r.returncode == 0, r.stderr
    assert "election-rounds [kernel] (elections/s)" in r.stdout
    assert "3 points across 3 series" in r.stdout
    assert script("--manifest", ok, "--check").returncode == 0
    r = script("--manifest", bad, "--check")
    assert r.returncode == 2
    assert "REGRESSION: throughput [kernel]" in r.stderr
    assert script("--manifest", bad, "--check",
                  "--threshold", "0.5").returncode == 0
    known = str(tmp_path / "known.json")
    assert script("--manifest", bad, "--write-baseline",
                  known).returncode == 0
    r = script("--manifest", bad, "--check", "--baseline", known)
    assert r.returncode == 0 and "known regression" in r.stderr
    empty = _write(tmp_path / "empty", [])
    assert script("--manifest", empty).returncode == 1
    rows = json.loads(script("--manifest", ok, "--json").stdout)["rows"]
    assert len(rows) == 3
