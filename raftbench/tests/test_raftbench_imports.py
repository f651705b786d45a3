"""The import check: nothing of the benchmark imports `jax`, `jaxlib`,
`flax` or `raft_tpu`, and the reference (with the reference worker, the
roofline arithmetic and the control) imports nothing of `raft_tpu_torch`.
Top-level module names are compared whole: `raft_tpu_torch` begins with
`raft_tpu` and is not it.

    python -m pytest raftbench/tests -q
"""

from __future__ import annotations

import ast
import subprocess
import sys

from raftbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "raft_tpu"}
PROGRAM = "raft_tpu_torch"
# What may import the program: the system under test and its tests.
MAY_IMPORT_PROGRAM = {"system.py"}


def _imports(path) -> set:
    """Top-level names of every module `path` imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources():
    return sorted(spec.HERE.rglob("*.py"))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_only_the_system_under_test_imports_the_program():
    for path in _sources():
        rel = path.relative_to(spec.HERE)
        if rel.parts[0] == "tests" or rel.name in MAY_IMPORT_PROGRAM:
            continue
        assert PROGRAM not in _imports(path), rel


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, raftbench.refworker, raftbench.control, "
            "raftbench.check, raftbench.roofline, raftbench.spec\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'raft_tpu_torch', 'raft_tpu', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_guard_names_whole_top_level_modules():
    loaded = ["raft_tpu_torch", "raft_tpu_torch.sim.kernel", "jaxtyping",
              "flaxen", "torch"]
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(loaded + ["jax.numpy"]) == ["jax"]
    assert run.forbidden_modules(loaded + ["raft_tpu.sim"]) == ["raft_tpu"]
    assert run.forbidden_modules(loaded + ["flax", "jaxlib"]) == [
        "flax", "jaxlib"]
