"""chip_smoke.py phase (l)'s worker processes on the CPU: a worker
(`chip_smoke.py --sweep-reference`) gives what
`torch_kernel_sweep.reference_on_cpu` gives in the process itself, a
failed worker raises with its exit code, and `Children.close()` kills
the workers still running and waits for each, so that none outlives the
script (`live_children` no longer lists them). Phase (m)'s bench child
(`bench_torch.py --quick`) exits 2 here, with no card: `bench_quick`
raises with its exit code and leaves neither a process nor its
temporary directory behind."""

from __future__ import annotations

import importlib
import pickle
import sys
from pathlib import Path

import pytest

from raft_tpu_torch.utils.trees import trees_equal_why

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
smoke = importlib.import_module("chip_smoke")
sweep = importlib.import_module("torch_kernel_sweep")


def test_sweep_worker_gives_the_in_process_reference(tmp_path):
    cfg = list(sweep.sweep_configs(1000, True))[1]
    task, out = tmp_path / "0.task", tmp_path / "0.out"
    task.write_bytes(pickle.dumps((cfg, 4, 16, False)))
    pool = smoke.Children([[sys.executable, str(ROOT / "chip_smoke.py"),
                            "--sweep-reference", str(task), str(out)]],
                          1, tmp_path)
    try:
        pool.wait(0)
    finally:
        pool.close()
    st, m, div, _ = pickle.loads(out.read_bytes())
    want_st, want_m, want_div, _ = sweep.reference_on_cpu(cfg, 4, 16)
    assert trees_equal_why(st, want_st)[0]
    assert trees_equal_why(m, want_m)[0]
    assert div is None and want_div is None


def test_close_kills_and_waits_for_every_worker(tmp_path):
    marker = "chip-smoke-worker-sleeps"
    cmds = [[sys.executable, "-c", "import sys; sys.exit(3)"]] + [
        [sys.executable, "-c", f"import time; time.sleep(600)  # {marker}"]
        for _ in range(3)]
    pool = smoke.Children(cmds, 3, tmp_path)
    try:
        with pytest.raises(RuntimeError, match="worker 0 exited with 3"):
            pool.wait(0)
        pool.top_up()
        assert len(pool.live) == 3 and not pool.todo
        assert sum(marker in c for c in smoke.live_children()) == 3
    finally:
        pool.close()
    assert not pool.live and len(pool.rc) == 4
    assert not any(marker in c for c in smoke.live_children())


def test_bench_child_fails_without_a_card_and_leaves_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the bench child would run")
    before = set(ROOT.glob(".chip_smoke_*"))
    with pytest.raises(AssertionError, match="--quick exited 2"):
        smoke.bench_quick("cpu")
    assert set(ROOT.glob(".chip_smoke_*")) == before
    assert not any("bench_torch.py" in c for c in smoke.live_children())
