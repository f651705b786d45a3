"""Structural rules of the port: no module of raft_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package (an AST scan of every
import), entry points default to the CUDA device, and the kernel source
is the one the wrapper builds for sm_90a."""

from __future__ import annotations

import ast
import inspect
from pathlib import Path

import pytest

from raft_tpu_torch.clients import state as cstate
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.sim import kernel, run, state

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    roots.add(a.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "raft_tpu"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_imports():
    """The scanner has teeth: it finds each form of import."""
    src = ROOT / "tests" / "test_torch_run.py"
    roots = _imported_roots(src)
    assert {"jax", "raft_tpu", "raft_tpu_torch"} <= roots


@pytest.mark.parametrize("fn", [state.init, run.metrics_init,
                                cstate.clients_init, recorder.flight_init],
                         ids=["state.init", "run.metrics_init",
                              "clients_init", "flight_init"])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_source_and_build_flags():
    assert kernel.SOURCE.is_file()
    assert kernel.SOURCE.relative_to(ROOT) == \
        Path("raft_tpu_torch/csrc/fused_chunk.cu")
    flags = " ".join(kernel.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    text = kernel.SOURCE.read_text()
    assert "pkernel.py:1950" in text and "fused_chunk_launch" in text
    assert kernel.FEATURES == ("prevote", "transfer", "reconfig", "reads",
                               "clients", "nemesis")
    for f in kernel.FEATURES:
        assert f"#ifndef FC_{f.upper()}" in text, f
    assert kernel.flag_name((False,) * 5 + (True,)) == "nemesis"
    assert kernel.flag_name((False,) * 4 + (True, True)) == \
        "clients+nemesis"


def test_wire_fields_follow_the_kernel_enum():
    """The wrapper's field order is the kernel's `Field` enum order."""
    text = kernel.SOURCE.read_text()
    body = text[text.index("enum Field {"):text.index("F_MB0,")]
    enum = [w.strip() for w in body.split("{", 1)[1].replace("\n", " ")
            .split(",") if w.strip()]
    assert enum == ["F_" + f.upper() for f in kernel.WIRE_FIELDS[:len(enum)]]
    tail = text[text.index("F_MB0,"):text.index("N_FIELDS\n")]
    tail = [w.split("=")[0].split("//")[0].strip()
            for w in "".join(ln.split("//")[0] + " "
                             for ln in tail.splitlines()).split(",")]
    n_mb = len(state.MB_FIELDS)
    assert [w for w in tail[1:] if w] == [
        "F_" + f.upper().replace(".", "_")
        for f in kernel.WIRE_FIELDS[len(enum) + n_mb:]]
    assert f"F_IS_REQ_SNAP_SESSIONS = F_MB0 + {n_mb}," in text
    mb = text[text.index("enum Mb {"):text.index("N_MB\n")]
    mb_enum = [w.strip() for w in mb.split("{", 1)[1].replace("\n", " ")
               .split(",") if w.strip()]
    assert mb_enum == [f.upper() for f in state.MB_FIELDS]


def test_kstep_counts_no_launch_on_cpu():
    from raft_tpu_torch.config import RaftConfig
    cfg = RaftConfig(n_groups=2, k=3, log_cap=8, compact_every=4)
    leaves, _ = kernel.kinit(cfg, state.init(cfg, device="cpu"))
    before = kernel.kstep.launches
    kernel.kstep(cfg, leaves, 0, 2)
    assert kernel.kstep.launches == before


def test_nemesis_table_follows_the_kernel():
    """`_nem_words` groups the clauses in the kernel's `NemSeam` order,
    behind the per-seam counts, and both sides bound the program alike."""
    from raft_tpu_torch import nemesis as n
    from raft_tpu_torch.config import RaftConfig
    text = kernel.SOURCE.read_text()
    assert "enum NemSeam { NS_LINK, NS_CRASH, NS_SKEW, NS_DISK, " \
           "NS_COMPACT, N_SEAMS };" in text
    assert f"constexpr int NEM_MAX = {kernel.NEM_MAX};" in text
    prog = n.program(n.compaction_pressure(0, 9), n.clock_skew(0, 9, -3),
                     n.wan_delay(0, 2 ** 40), n.crash_storm(0, 9),
                     n.disk_full_follower(0, 9), n.slow_follower(0, 9))
    words = kernel._nem_words(RaftConfig(nemesis=prog)).tolist()
    assert words[:5] == [2, 1, 1, 1, 1]
    kinds = [words[5 + 8 * j] for j in range(6)]
    # WAN, SLOW (link), STORM, SKEW, DISK, COMPACT
    assert kinds == [3, 1, 5, 4, 7, 8]
    assert words[5 + 2] == 2 ** 31 - 1   # the WAN clause's t1, clamped
    assert words[5 + 8 * 3 + 5] == 2 ** 32 - 3   # the skew's -3, as u32
