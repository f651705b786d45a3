"""The port's static audit (raft_tpu_torch/analysis/): the full and deep
audits are clean on the port; synthetic drift is named (a fake State,
Mailbox or presence leaf, a drifted field enum, a dropped checkpoint
backfill, the CLI's --inject-drift); each lint rule names file:line on
a synthetic file and the real modules are clean; the gating table and
the mutant catalog equal the JAX package's data. Nothing here calls the
JAX package's audit or compiles an XLA program."""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest
import torch

from raft_tpu_torch import analysis
from raft_tpu_torch.analysis import contracts, lint
from raft_tpu_torch.sim import checkpoint, kernel
from raft_tpu_torch.sim.state import Mailbox, PerNode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_static_audit.py")


@pytest.fixture(scope="module")
def full_report():
    return analysis.audit_report(level="full")


def test_full_audit_clean(full_report):
    assert full_report["ok"], (full_report["problems"], full_report["lint"])
    assert full_report["byte_model"]["headline"]["wire_bytes_derived"] > 0
    assert full_report["kernel_plan"]["skipped"]


def test_static_startup_audit_passes_and_raises_on_drift(monkeypatch):
    logged = []
    analysis.startup_audit("static", log=logged.append)
    assert logged and "ok" in logged[0]
    monkeypatch.setattr(contracts, "contract_problems",
                        lambda **kw: ["PerNode leaf ['ghost'] drifted"])
    with pytest.raises(RuntimeError, match="ghost"):
        analysis.startup_audit("static")


def test_deep_audit_script_exits_0_and_names_its_passes():
    out = subprocess.run([sys.executable, SCRIPT, "--level", "deep"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    for word in ("mcheck smoke", "exhaustive", "hazard prover",
                 "scheduler configs", "7/7 negatives caught",
                 "kernel plan: skipped"):
        assert word in out.stdout, word


def test_deep_audit_names_verification_failures(monkeypatch):
    from raft_tpu_torch.verify import hazards, mcheck
    bad = mcheck.check(mcheck.Bounds(k=2, ticks=1, max_states=1))
    monkeypatch.setattr(mcheck, "smoke", lambda **kw: bad)
    monkeypatch.setattr(hazards, "prove_schedulers", lambda **kw: {
        "configs": 1, "events": 1, "counts": {},
        "hazards": ["pinned-reuse at cohort.py:1: synthetic"]})
    monkeypatch.setattr(contracts, "contract_problems", lambda **kw: [])
    rep = analysis.audit_report(level="deep")
    assert not rep["ok"]
    joined = "\n".join(rep["problems"])
    assert "mcheck smoke" in joined and "pinned-reuse" in joined


def test_inject_drift_names_the_leaf():
    out = subprocess.run([sys.executable, SCRIPT, "--inject-drift",
                          "ghost_leaf"], cwd=ROOT, capture_output=True,
                         text=True)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "ghost_leaf" in out.stdout
    assert "stream_slowest_device" in out.stdout


@pytest.mark.parametrize("kw,name", [
    ({"pernode_fields": PerNode._fields + ("ghost",)}, "ghost"),
    ({"mailbox_fields": Mailbox._fields + ("xx_slot",)}, "xx_slot"),
    ({"mailbox_fields": Mailbox._fields + ("xx_present",)},
     "occupancy registries"),
])
def test_wire_registry_names_a_fake_leaf(kw, name):
    problems = contracts.wire_registry_problems(**kw)
    assert any(name in p for p in problems), problems


def test_wire_registry_names_a_drifted_cuda_enum():
    src = kernel.SOURCE.read_text().replace(
        "F_COMMITTED, F_LEADERLESS", "F_LEADERLESS, F_COMMITTED")
    problems = contracts.wire_registry_problems(cuda_source=src)
    assert any("fused_chunk.cu" in p and "committed" in p
               for p in problems), problems
    assert contracts.cuda_field_enum() == list(kernel.WIRE_FIELDS)


def test_dropped_checkpoint_backfill_is_named():
    def load(path, cfg=None, device="cuda"):
        st, t, m = checkpoint.load(path, cfg, device)
        if m is not None:   # forgets the pre-r07 safety backfill
            m = m._replace(safety=torch.zeros_like(m.safety))
        return st, t, m

    drifted = types.SimpleNamespace(save=checkpoint.save, load=load)
    problems = contracts.checkpoint_problems(ckpt_mod=drifted)
    assert any("pre-r07 backfill" in p for p in problems), problems


def test_kernel_plan_skipped_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernel_cuda.py")
    with pytest.raises(RuntimeError, match="skipped"):
        contracts.kernel_plan_problems()


def test_gating_table_and_catalog_equal_the_reference():
    from raft_tpu.analysis.contracts import GATED_LEAVES
    from raft_tpu.verify.mutants import MUTANTS
    from raft_tpu_torch.verify import mutants
    assert contracts.GATED_LEAVES == GATED_LEAVES
    assert [m.name for m in mutants.MUTANTS] == [m.name for m in MUTANTS]


# ------------------------------------------------------------------ lint


def test_real_modules_lint_clean():
    assert lint.lint_default() == []


SYNTHETIC = '''\
import random
import torch
import numpy as np


def draw(x: torch.Tensor):
    a = torch.rand(3)
    b = np.random.randint(4)
    x.uniform_()
    return a, b


def sync(wire: torch.Tensor):
    n = wire.sum()
    if n > 0:
        pass
    k = int(n)
    v = n.item()
    ok = int(n)  # sync-ok: a deliberate readout
    return k, v, ok


def client_update(cfg, cs: ClientState):
    return cs.done.sum(dim=0)


def widen(ns: PerNode):
    t = ns.term.to(torch.int32)
    c = ns.commit.long()
    d = ns.digest.to(torch.int64)
    e = ns.applied.to(I32)  # widen-ok: the wire boundary
    return t, c, d, e
'''


def test_each_rule_names_file_and_line(tmp_path):
    path = tmp_path / "workload.py"   # the workload and widening rules
    path.write_text(SYNTHETIC)
    found = {(f.rule, f.line) for f in lint.lint_file(str(path))}
    lines = SYNTHETIC.splitlines()

    def at(text):
        return next(i for i, ln in enumerate(lines, 1) if text in ln)

    want = {("untagged-randomness", at("import random")),
            ("untagged-randomness", at("torch.rand(3)")),
            ("untagged-randomness", at("np.random")),
            ("untagged-randomness", at("uniform_")),
            ("host-sync", at("if n > 0")),
            ("host-sync", at("k = int(n)")),
            ("host-sync", at("n.item()")),
            ("non-elementwise-workload", at("cs.done.sum")),
            ("untagged-widening", at("ns.term.to")),
            ("untagged-widening", at("ns.commit.long"))}
    assert found == want, sorted(found ^ want)
    assert all(str(f).startswith(f"{path}:") for f in
               lint.lint_file(str(path)))


def test_cuda_draws_are_named(tmp_path):
    path = tmp_path / "k.cu"
    path.write_text("// rand( in a comment is fine\n"
                    "#include <curand_kernel.h>\n"
                    "int x = rand();\n")
    found = [(f.rule, f.line) for f in lint.lint_file(str(path))]
    assert found == [("untagged-randomness", 2), ("untagged-randomness", 3)]
