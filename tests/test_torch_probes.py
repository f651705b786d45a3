"""The port's probe scripts on the CPU: scripts/torch_perf_probe.py's
variants patch names of `sim.step` that exist and restore them (and the
restored tick is the unpatched one), and the kernel probe's anchors are
in fused_chunk.cu, and it launches an old kernel by the form of its
launcher; scripts/torch_layout_probe.py --bytes-only equals the
JAX package's `bytes_per_group_report` leaf for leaf but for the three
u32 leaves the port holds as int64; scripts/torch_check_metric_parity.py
exits 0, and 1 on an injected drift. The reference's report runs its
one-group `sim.init` (no scan or kernel is compiled)."""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import raft_tpu_torch.sim.step as step
from raft_tpu_torch.analysis import bytemodel
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import run, state
from raft_tpu_torch.utils.trees import trees_equal

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
probe = importlib.import_module("torch_perf_probe")
layout = importlib.import_module("torch_layout_probe")
parity = importlib.import_module("torch_check_metric_parity")

HANDLERS = ("ae_req", "ae_resp", "rv_req", "rv_resp", "is_req", "is_resp")
PATCHES = {"full": set(), "nometrics": set(), "nohist": set(),
           "nophaseD": {"_handlers"}, "nophaseT": {"_phase_t"},
           "nophaseC": {"_phase_c"}, "noapply": {"_phase_a"},
           "nodigest": {"_phase_a"},
           **{f"noh_{h}": {"_handlers"} for h in HANDLERS}}
CFG = RaftConfig(seed=42)


def _drive(mode: str, ticks: int = 30):
    st = state.init(CFG, 2, device="cpu")
    return probe.advance(CFG, st, run.metrics_init(2, device="cpu"), 0,
                         ticks, mode)


def test_variant_list_is_the_reference():
    assert probe.VARIANTS == ("full", "nometrics", "nohist", "nophaseD",
                              "nophaseT", "nophaseC", "noapply")
    assert set(probe.ORIG) <= set(vars(step))


@pytest.mark.parametrize("name", sorted(PATCHES))
def test_variant_patches_existing_names_and_restores(name):
    mode = probe.apply_variant(name)
    try:
        patched = {n for n, fn in probe.ORIG.items()
                   if getattr(step, n) is not fn}
        assert patched == PATCHES[name]
        st, m = _drive(mode, 12)
        assert st.nodes.term.shape == (2, CFG.k)
        if name.startswith("noh_"):
            kept = {h.__name__ for h in step._handlers(CFG)}
            assert f"_on_{name[4:]}" not in kept and len(kept) == 5
    finally:
        probe.restore()
    assert all(getattr(step, n) is fn for n, fn in probe.ORIG.items())


def test_restored_tick_is_the_unpatched_one():
    before = _drive("full")
    for name in PATCHES:
        probe.apply_variant(name)
    probe.restore()
    assert trees_equal(before, _drive("full"))
    assert int(before[0].nodes.commit.max()) > 0   # the run did commit
    probe.apply_variant("nophaseT")   # no timeouts: nobody is elected
    try:
        assert int(_drive("full")[0].nodes.commit.max()) == 0
    finally:
        probe.restore()
    with pytest.raises(ValueError):
        probe.apply_variant("noh_nonesuch")
    probe.restore()


def test_kernel_probe_anchors_are_in_the_source():
    from raft_tpu_torch.sim import kernel
    ab = importlib.import_module("torch_kernel_ab")
    src = ab.instrumented_source()
    assert src.count("clock64()") == 4 and "fc_read_cycles" in src
    # the ring words copied per tile-tick, beside the cycles, all summed
    # in registers and added once a launch
    assert ab.syncs_by_span(kernel.SOURCE.read_text())
    assert src.count("span_slots(wlo, whi, a.L)") == 1
    assert src.count("atomicAdd(&fc_cycles[4], fc_sum[4])") == 1
    assert "fc_cycles[5]" in src and "z[5]" in src
    assert src.count("atomicAdd(") == kernel.SOURCE.read_text().count(
        "atomicAdd(") + 2
    if not torch.cuda.is_available():
        assert probe.main([]) == 2   # the timings need the card


# The launcher of a fused_chunk.cu from before the double-buffered rows
# moved into shared memory: it took a scratch tensor for them.
SCRATCH_LAUNCHER = """
extern "C" int fused_chunk_launch(const void* wire_in, void* wire_out,
                                  void* scratch, void* acc,
                                  const int* offsets, int n_offsets,
                                  const long long* params, int n_params,
                                  const unsigned* nem, int n_nem,
                                  void* stream) {
"""


@pytest.mark.parametrize("form", ["current", "scratch"])
def test_kernel_ab_reads_the_old_launcher_form(form):
    """scripts/torch_kernel_ab.py launches OLD.cu by the form its text
    shows: with the scratch tensor (`old_step`) or as `kernel.kstep`
    launches the current source (`current_form_step`)."""
    from raft_tpu_torch.sim import kernel
    ab = importlib.import_module("torch_kernel_ab")
    text = kernel.SOURCE.read_text()
    if form == "scratch":
        head = text.index('extern "C" int fused_chunk_launch(')
        text = text[:head] + SCRATCH_LAUNCHER.lstrip() + \
            text[text.index("{", head) + 2:]
    assert ab.launcher_takes_scratch(text) == (form == "scratch")
    lib = object()
    step = ab.old_stepper(lib, text)
    assert step.args == (lib,)
    assert step.func is (ab.old_step if form == "scratch"
                         else ab.current_form_step)


ROW = re.compile(r"^\s+(\d+) B  (\S+)\s+([a-z0-9]+)(\[.*\])$")


def _reference_rows() -> dict:
    ref = importlib.import_module("layout_probe")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.bytes_per_group_report()
    rows = {}
    for line in buf.getvalue().split("state total")[0].splitlines():
        m = ROW.match(line)
        if m:
            rows[m.group(2)] = (int(m.group(1)), m.group(3), m.group(4))
    return rows


def test_bytes_report_equals_the_reference_but_u32(capsys):
    theirs = _reference_rows()
    mine = {name: (b, dt, str(shp))
            for b, name, dt, shp in layout.state_leaf_rows(CFG)}
    assert set(mine) == set(theirs) and len(mine) > 50
    widened = {n for n in mine if mine[n] != theirs[n]}
    assert widened == {"nodes.digest", "nodes.snap_digest",
                       "mailbox.is_req_snap_digest"}
    for n in widened:
        assert theirs[n][1] == "uint32" and mine[n][1] == "int64"
        assert mine[n][0] == 2 * theirs[n][0] and mine[n][2] == theirs[n][2]
    extra = sum(mine[n][0] - theirs[n][0] for n in widened)
    assert extra == 140 == bytemodel.resident_bytes_model(CFG)[
        "u32_widening_bytes"]
    assert layout.main(["--bytes-only"]) == 0
    rep = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rep["state_total"] == sum(b for b, *_ in theirs.values()) + 140
    assert rep["ceilings"]["x4_shards_out"] > rep["ceilings"]["x4_gathered"]


def test_shared_leaf_bytes_sum_to_the_group():
    from raft_tpu_torch.sim import kernel
    for cfg in (CFG, bytemodel.clients_cfg()):
        rows = layout.shared_leaf_bytes(cfg)
        assert sum(rows.values()) == 4 * kernel.shared_words_per_group(cfg)
        assert 0 <= rows["padding"] < 16
    assert 4 * kernel.shared_words_per_group(CFG) == 8600


def test_metric_parity_wrapper_exits_0_and_1_on_drift(monkeypatch, capsys):
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "torch_check_metric_parity.py")],
                         capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.startswith("metric parity ok")
    from raft_tpu_torch.obs import recorder
    monkeypatch.setattr(recorder, "FLIGHT_LEAVES",
                        tuple(reversed(recorder.FLIGHT_LEAVES)))
    assert parity.main() == 1
    assert "METRIC PARITY DRIFT: Flight fields" in capsys.readouterr().out
