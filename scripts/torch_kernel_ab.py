"""Time the port's fused-chunk kernel against an earlier version of its
source on one NVIDIA GPU, at chip_smoke.py's runs and sizes.

    python3 scripts/torch_kernel_ab.py OLD.cu [--phase-cycles]

OLD.cu is an earlier fused_chunk.cu that takes the same offsets,
parameters and clause words as the current wrapper sends. Its launcher
is read from its text: either the current one, `fused_chunk_launch(
wire_in, out, acc, nem_tab, offsets, n_offsets, params, n_params, nem,
n_nem, stream)`, launched as `kernel.kstep` launches it, or the older
one that takes a scratch tensor for the double-buffered rows,
`fused_chunk_launch(wire_in, out, scratch, acc, offsets, ...)`.
For each run of chip_smoke.py: one CHUNK-tick launch from the run's
start on the old kernel, on the current one twice, on the old one again
(CUDA events, in that order on one card, after one untimed launch of
each); all four outputs must be identical. With --phase-cycles it also
builds both sources with clock64() probes (lane 0 of each tile, summed in
registers over a launch) and prints, for the base build's runs, old,
current, current, old, the cycles per tile and tick spent before the
node steps (buffer preparation, faults, filters), in them, and in the
group-level tail, and, for a source that copies only the written ring
slots, the ring words each tile copies into the next buffer per tick
(`ring_words_per_tile_tick`, beside the whole rings' 2·K·L,
`ring_words_whole`). Prints the card (nvidia-smi) and one JSON line.
Builds go to the kernel's build directory (git ignores it).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from raft_tpu_torch.obs import recorder  # noqa: E402
from raft_tpu_torch.sim import kernel, state  # noqa: E402

AB_DIR = kernel.BUILD_DIR / "ab"
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p]
# (anchor in fused_chunk.cu, probe inserted after it) for --phase-cycles.
# Each lane sums in registers, per launch: the cycles before, in and after
# the node steps and the tile-ticks (lane 0 of each tile), and the ring
# words its node's slots took to copy into the next buffer; one atomic
# each at the end of the launch (an atomic a tick would queue every tile
# on the same five words).
PROBES = (
    ("namespace {\n", "__device__ unsigned long long fc_cycles[5];\n"),
    ("  const int ring_words = 2 * K * a.L;   // the rings lead the region\n",
     "  unsigned long long fc_sum[5] = {0, 0, 0, 0, 0};\n"),
    ("    const uint32_t tu = static_cast<uint32_t>(tick);\n",
     "    const long long fc_c0 = clock64();\n"),
    ("    tile_sync(tl);   // the next buffer is ready\n",
     "    const long long fc_c1 = clock64();\n"),
    ("    tile_sync(tl);   // every node has stepped\n",
     "    const long long fc_c2 = clock64();\n"),
    ("    if (!safe) safety = 0;\n",
     "    fc_sum[0] += fc_c1 - fc_c0;\n"
     "    fc_sum[1] += fc_c2 - fc_c1;\n"
     "    fc_sum[2] += clock64() - fc_c2;\n"
     "    fc_sum[3] += 1;\n"),
    ("  if (node) gr.s(F_ALIVE_PREV, i) = (alive_prev >> i) & 1u;\n",
     "  if (i == 0)\n"
     "    for (int fc_j = 0; fc_j < 4; ++fc_j)\n"
     "      atomicAdd(&fc_cycles[fc_j], fc_sum[fc_j]);\n"
     "  atomicAdd(&fc_cycles[4], fc_sum[4]);\n"),
)
# The ring-words probe, in a source that copies by the written span (one
# that copies whole rings copies 2·K·L words a tile-tick, and reads null).
WORD_PROBES = (
    ("    const uint32_t tu = static_cast<uint32_t>(tick);\n",
     "    fc_sum[4] += node ? 2 * span_slots(wlo, whi, a.L) : 0;\n"),
)
READ_CYCLES = ('\nextern "C" void fc_read_cycles(unsigned long long* h) {\n'
               "  cudaMemcpyFromSymbol(h, fc_cycles, sizeof(fc_cycles));\n"
               "  const unsigned long long z[5] = {0, 0, 0, 0, 0};\n"
               "  cudaMemcpyToSymbol(fc_cycles, z, sizeof(z));\n}\n")


def nvcc(source: Path, flags: tuple, name: str) -> ctypes.CDLL:
    AB_DIR.mkdir(parents=True, exist_ok=True)
    so = AB_DIR / f"{name}_{kernel.flag_name(flags)}.so"
    r = subprocess.run([kernel._nvcc(), *kernel.NVCC_FLAGS,
                        *kernel._defines(flags), "-o", str(so), str(source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.fused_chunk_launch.argtypes = ARGTYPES
    lib.fused_chunk_launch.restype = ctypes.c_int
    return lib


def launcher_takes_scratch(source: str) -> bool:
    """Whether a fused_chunk.cu's launcher takes the scratch tensor (the
    older form), read from its parameter list."""
    head = source.index('extern "C" int fused_chunk_launch(')
    params = source[head:source.index(")", head)]
    return re.search(r"\bscratch\b", params) is not None


@contextlib.contextmanager
def loaded(lib):
    """Every `kernel.load` inside the block returns `lib`, so that
    `kernel.kstep` launches it whatever the flag set."""
    real_load = kernel.load
    kernel.load = lambda flags: lib
    try:
        yield
    finally:
        kernel.load = real_load


def current_form_step(lib, cfg, leaves, t0, n_ticks):
    """One launch of an old kernel with the current launcher, as
    `kernel.kstep` launches it: a new (wire, acc) pair."""
    with loaded(lib):
        return kernel.kstep(cfg, leaves, t0, n_ticks)


def old_stepper(lib, source: str):
    """The launch of the old kernel `lib`, built from `source`, by the
    form of its launcher: (cfg, leaves, t0, n_ticks) -> (wire, acc)."""
    step = old_step if launcher_takes_scratch(source) else current_form_step
    return functools.partial(step, lib)


def old_step(lib, cfg, leaves, t0, n_ticks):
    """One launch of an old kernel whose launcher takes the scratch
    tensor: a new (wire, acc) pair."""
    wire, acc = leaves
    g, ring = wire.shape[1], kernel._ring_of(cfg, wire)
    offs, params, nem = kernel._launch_args(
        cfg, g, kernel._hist_size(cfg, acc), ring, t0, n_ticks)
    _, n_words, db_start = kernel._wire_rows(cfg, ring)
    out, acc_out = torch.empty_like(wire), acc.clone()
    scratch = torch.empty((n_words - db_start, g), dtype=torch.int32,
                          device=wire.device)
    rc = lib.fused_chunk_launch(
        wire.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        acc_out.data_ptr(), offs.ctypes.data, len(offs), params.ctypes.data,
        len(params), nem.ctypes.data, len(nem),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old fused_chunk launch failed: {rc}")
    return out, acc_out


def timed(fn):
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def syncs_by_span(source: str) -> bool:
    """Whether a fused_chunk.cu copies only the ring slots the last tick
    wrote (and so carries the ring-words probe's anchor)."""
    return "int span_slots(" in source


def instrumented_source(source: str | None = None) -> str:
    """A fused_chunk.cu (default: the current one) with the clock64()
    probes (`PROBES`, and `WORD_PROBES` where it syncs by span) after
    their anchors and `fc_read_cycles`; raises when an anchor is
    missing."""
    src = kernel.SOURCE.read_text() if source is None else source
    probes = PROBES + (WORD_PROBES if syncs_by_span(src) else ())
    for anchor, probe in probes:
        if src.count(anchor) < 1:
            raise RuntimeError(f"probe anchor missing: {anchor!r}")
        src = src.replace(anchor, anchor + probe, 1)
    return src + READ_CYCLES


def cycles_build(source: str, name: str) -> ctypes.CDLL:
    """The base build of `source` with the probes."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    path = AB_DIR / f"fused_chunk_{name}.cu"
    path.write_text(instrumented_source(source))
    return nvcc(path, (False,) * len(kernel.FEATURES), name)


def phase_cycles(runs, lib, source: str, name: str) -> dict:
    """Cycles per tile and tick by phase, and ring words copied per
    tile-tick, on the base build's runs (the ones without a flight ring),
    from `lib`, the probed build of `source`: one untimed launch (the
    module's load), then one counted and timed."""
    base = (False,) * len(kernel.FEATURES)
    h, out = (ctypes.c_ulonglong * 5)(), {}
    with loaded(lib):
        for label, cfg, g, fl, _ in runs:
            if kernel.features(cfg) != base or fl:
                continue
            leaves = kernel.kinit(cfg, state.init(cfg, g))[0]
            kernel.kstep(cfg, leaves, 0, chip_smoke.CHUNK)
            torch.cuda.synchronize()
            lib.fc_read_cycles(h)
            _, ms = timed(lambda: kernel.kstep(cfg, leaves, 0,
                                               chip_smoke.CHUNK))
            lib.fc_read_cycles(h)
            n = h[3]
            words = h[4] / n if syncs_by_span(source) else None
            out[label] = {"ms_instrumented": ms,
                          "before_steps": h[0] / n, "node_steps": h[1] / n,
                          "tail": h[2] / n,
                          "ring_words_per_tile_tick": words,
                          "ring_words_whole": 2 * cfg.k * cfg.log_cap}
            print(f"{label} ({name}): cycles per tile and tick "
                  f"{out[label]}", flush=True)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    old_source = Path(argv[0]).resolve()
    old_text = old_source.read_text()
    card = chip_smoke.gpu_line()
    runs = chip_smoke.all_runs()
    flag_sets = sorted({kernel.features(cfg) for _, cfg, *_ in runs})
    kernel.build(flag_sets)
    with concurrent.futures.ThreadPoolExecutor(len(flag_sets)) as pool:
        old = dict(zip(flag_sets, pool.map(
            lambda f: old_stepper(nvcc(old_source, f, "old"), old_text),
            flag_sets)))
    results = {}
    for label, cfg, g, fl, _ in runs:
        flight = recorder.flight_init(g) if fl else None
        leaves = kernel.kinit(cfg, state.init(cfg, g), flight=flight)[0]
        step = old[kernel.features(cfg)]
        steps = (lambda: step(cfg, leaves, 0, chip_smoke.CHUNK),
                 lambda: kernel.kstep(cfg, leaves, 0, chip_smoke.CHUNK))
        for warm in steps:   # each module's lazy load, untimed
            warm()
        outs = [timed(steps[k]) for k in (0, 1, 1, 0)]
        same = all(torch.equal(outs[0][0][j], o[0][j])
                   for o in outs[1:] for j in (0, 1))
        if not same:
            raise AssertionError(f"{label}: old and current kernels differ")
        results[label] = {"groups": g, "old_ms": [outs[0][1], outs[3][1]],
                          "ms": [outs[1][1], outs[2][1]],
                          "plan": kernel.launch_plan(
                              cfg, g, recorder.RING if fl else 0)}
        print(f"{label} {g} groups: old {outs[0][1]:.2f} / {outs[3][1]:.2f} "
              f"ms, current {outs[1][1]:.2f} / {outs[2][1]:.2f} ms per "
              f"{chip_smoke.CHUNK}-tick launch, identical", flush=True)
        del leaves, outs
    cycles = None
    if "--phase-cycles" in argv:   # old, current, current, old
        sources = {"old": old_text, "current": kernel.SOURCE.read_text()}
        libs = {side: cycles_build(src, f"cycles_{side}")
                for side, src in sources.items()}
        cycles = {side: [] for side in sources}
        for side in ("old", "current", "current", "old"):
            cycles[side].append(phase_cycles(runs, libs[side], sources[side],
                                             f"cycles_{side}"))
    print(card)
    print(json.dumps({"card": card, "runs": results, "cycles": cycles}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
