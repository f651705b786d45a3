"""Structural rules of the port: no module of raft_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package (an AST scan of every
import), entry points default to the CUDA device (a mesh to every
visible card, never the CPU in its place), the kernel source is the
one the wrapper builds for sm_90a, and its ring writes go through the
one helper that records them."""

from __future__ import annotations

import ast
import inspect
import re
from pathlib import Path

import pytest
import torch

from raft_tpu_torch.clients import state as cstate
from raft_tpu_torch.nemesis import search
from raft_tpu_torch.obs import recorder, triage
from raft_tpu_torch.parallel import cohort
from raft_tpu_torch.sim import checkpoint, kernel, run, state

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
     ROOT / "scripts" / "torch_kernel_ab.py",
     ROOT / "scripts" / "torch_nemesis_search.py",
     ROOT / "scripts" / "torch_bench_history.py",
     ROOT / "scripts" / "torch_multichip_sweep.py",
     ROOT / "scripts" / "torch_static_audit.py",
     ROOT / "scripts" / "torch_kernel_sweep.py",
     ROOT / "scripts" / "torch_nemesis_fleet.py",
     ROOT / "scripts" / "torch_perf_probe.py",
     ROOT / "scripts" / "torch_layout_probe.py",
     ROOT / "scripts" / "torch_check_metric_parity.py",
     ROOT / "scripts" / "torch_span_split.py"]


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
                                cstate.clients_init, recorder.flight_init,
                                cohort.host_wire, cohort.prun_streamed,
                                checkpoint.load, triage.oracle_divergence,
                                search.run_signals, search.search,
                                search.first_unsafe_tick,
                                search.divergence_repro,
                                search.safety_repro],
                         ids=["state.init", "run.metrics_init",
                              "clients_init", "flight_init", "host_wire",
                              "prun_streamed", "checkpoint.load",
                              "oracle_divergence", "run_signals", "search",
                              "first_unsafe_tick", "divergence_repro",
                              "safety_repro"])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_make_mesh_defaults_to_cuda(monkeypatch):
    """The mesh's default is every visible card, and without one it
    raises rather than take the CPU; the CPU only when named."""
    from raft_tpu_torch.parallel import mesh
    assert inspect.signature(mesh.make_mesh).parameters[
        "devices"].default is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="never taken in place of a card"):
        mesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.make_mesh() == (torch.device("cuda", 0),
                                torch.device("cuda", 1))
    with pytest.raises(ValueError, match="need 3 devices"):
        mesh.make_mesh(3)
    assert mesh.make_mesh(devices=["cpu"] * 2) == (torch.device("cpu"),) * 2


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


def test_codec_source_and_plan():
    """The codec kernels' source is the one the wrapper builds, names the
    TPU functions it replaces, and parses the plan `_codec_plan` sends:
    a 12-word head, the bool slots' rows, then (working, at-rest, rows)
    runs that tile every row not rewritten."""
    from raft_tpu_torch.config import RaftConfig
    assert kernel.CODEC_SOURCE.relative_to(ROOT) == \
        Path("raft_tpu_torch/csrc/wire_codec.cu")
    text = kernel.CODEC_SOURCE.read_text()
    for needle in ("`_pack_wire` (:1847)", "`_unpack_wire` (:1901)",
                   "`_ring_base_ov` (:1837)", '"C" int wire_unpack_launch',
                   '"C" int wire_pack_launch', "if (n_plan < 12)"):
        assert needle in text, needle
    cfg = RaftConfig(seed=42, prevote=True, pack_bools=True, pack_ring=True)
    plan = kernel._codec_plan(cfg, 0).tolist()
    n_mb = plan[11]
    assert plan[:2] == [5, 32] and n_mb == len(kernel._mb_bools(cfg)) == 11
    runs = plan[12 + n_mb + 1:]
    assert len(runs) == 3 * plan[12 + n_mb]
    copied = sum(runs[2::3])
    rewritten = 25 + 5 + 160 + n_mb * 25
    assert copied + rewritten == kernel.working_words_per_group(cfg)


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
    behind the per-seam counts; the clause words go to the kernel as a
    device tensor (`_nem_table`) that each block copies into its shared
    memory, bounded only by it (`shared_bytes`)."""
    import torch
    from raft_tpu_torch import nemesis as n
    from raft_tpu_torch.config import RaftConfig
    text = kernel.SOURCE.read_text()
    assert "enum NemSeam { NS_LINK, NS_CRASH, NS_SKEW, NS_DISK, " \
           "NS_COMPACT, N_SEAMS };" in text
    assert "enum NemWord { NK, NT0, NT1, NGROUP, NP, NA, NB, NCID, " \
           "NEM_WORDS };" in text
    assert "nem[w] = nem_tab[w];" in text and "NEM_MAX" not in text
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
    cfg = RaftConfig(nemesis=prog)
    table = kernel._nem_table(cfg, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (6 * 8,)
    assert (table.numpy().view("uint32") == words[5:]).all()
    assert kernel._nem_table(RaftConfig(), torch.device("cpu")) is None
    # the table's 6 clauses, a participation word and its padding
    assert kernel.shared_bytes(cfg) == \
        kernel.shared_bytes(RaftConfig()) + 8 * 4 * 6 + 4 * 4


def _body(text: str, name: str) -> tuple:
    """(start, end) of the body of the kernel function `name`."""
    head = re.search(rf"\b(?:void|int|bool) {name}\(", text)
    assert head, name
    start = text.index("{", text.index(")", head.end()))
    depth = 0
    for at in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[at], 0)
        if depth == 0:
            return start, at
    raise AssertionError(f"{name}: unbalanced braces")


def _code_line(text: str, at: int) -> str:
    """The code of the line holding offset `at`, without its comment."""
    line = text[text.rindex("\n", 0, at) + 1:text.index("\n", at)]
    return line.split("//", 1)[0].strip()


RING_STORE = re.compile(r"\b\w+\.l[tp]\s*\[[^\]]*\]\s*=(?!=)")
RING_ROW = re.compile(r"gr\.x\(F_LOG_(?:TERM|PAYLOAD),")
NEXT_STORE = re.compile(r"gr\.nxt\)?\s*\[[^\]]*\]\s*=(?!=)|int2\*>\(gr\.nxt\)")
NODE_RING = ("n.lt = &gr.x(F_LOG_TERM, i * L);",
             "n.lp = &gr.x(F_LOG_PAYLOAD, i * L);")


def ring_write_problems(text: str) -> list:
    """Where fused_chunk.cu writes a node's ring other than through
    `put_entry` (which records the index it wrote), or writes the next
    buffer's ring rows other than by `ring_sync` and node_step's own ring
    pointers: each breaks the copy of only the written slots."""
    put, sync, step = (_body(text, f) for f in ("put_entry", "ring_sync",
                                                "node_step"))
    problems = []

    def inside(at, span):
        return span[0] <= at <= span[1]

    for m in RING_STORE.finditer(text):
        if not inside(m.start(), put):
            problems.append(f"ring store outside put_entry: {m.group(0)}")
    for m in re.finditer(r"\bn\.l[tp]\b(?!\s*\[)", text):
        line = _code_line(text, m.start())
        if line not in NODE_RING or not inside(m.start(), step):
            problems.append(f"ring pointer used other than indexed: {line}")
    for m in RING_ROW.finditer(text):
        line = _code_line(text, m.start())
        read = re.match(r"const int\* \w+ = &gr\.x\(", line) or \
            re.match(r"int \w+ = gr\.c\(", line)
        if not (read or inside(m.start(), sync) or
                (line in NODE_RING and inside(m.start(), step))):
            problems.append(f"second writer of the next rings: {line}")
    for m in NEXT_STORE.finditer(text):
        line = _code_line(text, m.start())
        if not inside(m.start(), sync) and "= ring_words +" not in line:
            problems.append(f"next buffer written over the rings: {line}")
    if not RING_STORE.search(text[put[0]:put[1]]):
        problems.append("put_entry stores no ring slot")
    return problems


SYNC_CALL = ("    if (node && whi >= wlo) ring_sync(gr, i, wlo, whi);"
             "   // wrote any?\n")
RING_MUTANTS = {
    "as_built": None,
    "bare_store": ("          if (same_p || do_append) put_entry(",
                   "          n.lt[sl] = et;\n"
                   "          if (same_p || do_append) put_entry("),
    "second_writer": (SYNC_CALL, SYNC_CALL +
                      "    if (node) gr.x(F_LOG_PAYLOAD, i * a.L) = 0;\n"),
    "whole_copy": (SYNC_CALL,
                   "    for (int w = i; w < ring_words / 2; w += tl.w)\n"
                   "      reinterpret_cast<int2*>(gr.nxt)[w] =\n"
                   "          reinterpret_cast<const int2*>(gr.cur)[w];\n"),
    "pointer_alias": ("          if (same_p || do_append) put_entry(",
                      "          int* t = n.lt;\n"
                      "          if (same_p || do_append) put_entry("),
}


@pytest.mark.parametrize("mutant", sorted(RING_MUTANTS))
def test_ring_writes_go_through_one_helper(mutant):
    """Each tick copies into the next buffer only the ring slots the last
    tick wrote (`ring_sync`), which is the whole difference between the
    two buffers only if every ring write goes through `put_entry`, and
    nothing else writes the next buffer's rings. The CPU cannot run the
    kernel, so the rule is read from its source; each mutant breaks it."""
    text = kernel.SOURCE.read_text()
    if RING_MUTANTS[mutant] is not None:
        anchor, repl = RING_MUTANTS[mutant]
        assert text.count(anchor) == 1, anchor
        text = text.replace(anchor, repl)
    problems = ring_write_problems(text)
    if mutant == "as_built":
        assert problems == []
    else:
        assert problems, mutant
