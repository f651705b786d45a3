"""Time the port's fused-chunk kernel against an earlier version of its
source on one NVIDIA GPU, at chip_smoke.py's runs and sizes.

    python3 scripts/torch_kernel_ab.py OLD.cu [--phase-cycles]

OLD.cu is a fused_chunk.cu whose launcher takes a scratch tensor for the
double-buffered rows: `fused_chunk_launch(wire_in, out, scratch, acc,
offsets, n_offsets, params, n_params, nem, n_nem, stream)`, with the
same offsets, parameters and clause words as the current wrapper sends.
For each run of chip_smoke.py: one CHUNK-tick launch from the run's
start on the old kernel, on the current one twice, on the old one again
(CUDA events, in that order on one card); all four outputs must be
identical. With --phase-cycles it also rebuilds the current source with
clock64() probes (lane 0 of each tile) and prints, for the base build's
runs, the cycles per tile and tick spent before the node steps (buffer
preparation, faults, filters), in them, and in the group-level tail.
Prints the card (nvidia-smi) and one JSON line. Builds go to the
kernel's build directory (git ignores it).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
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
# (anchor in fused_chunk.cu, probe inserted after it) for --phase-cycles
PROBES = (
    ("namespace {\n", "__device__ unsigned long long fc_cycles[4];\n"),
    ("    const uint32_t tu = static_cast<uint32_t>(tick);\n",
     "    const long long fc_c0 = clock64();\n"),
    ("    tile_sync(tl);   // the next buffer is ready\n",
     "    const long long fc_c1 = clock64();\n"),
    ("    tile_sync(tl);   // every node has stepped\n",
     "    const long long fc_c2 = clock64();\n"),
    ("    if (!safe) safety = 0;\n",
     "    if (i == 0) {\n"
     "      atomicAdd(&fc_cycles[0], fc_c1 - fc_c0);\n"
     "      atomicAdd(&fc_cycles[1], fc_c2 - fc_c1);\n"
     "      atomicAdd(&fc_cycles[2], clock64() - fc_c2);\n"
     "      atomicAdd(&fc_cycles[3], 1ull);\n"
     "    }\n"),
)
READ_CYCLES = ('\nextern "C" void fc_read_cycles(unsigned long long* h) {\n'
               "  cudaMemcpyFromSymbol(h, fc_cycles, sizeof(fc_cycles));\n"
               "  const unsigned long long z[4] = {0, 0, 0, 0};\n"
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


def old_step(lib, cfg, leaves, t0, n_ticks):
    """One launch of the old kernel: a new (wire, acc) pair."""
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


def instrumented_source() -> str:
    """fused_chunk.cu with the clock64() probes (`PROBES`) after their
    anchors and `fc_read_cycles`; raises when an anchor is missing."""
    src = kernel.SOURCE.read_text()
    for anchor, probe in PROBES:
        if src.count(anchor) < 1:
            raise RuntimeError(f"probe anchor missing: {anchor!r}")
        src = src.replace(anchor, anchor + probe, 1)
    return src + READ_CYCLES


def phase_cycles(runs) -> dict:
    """Cycles per tile and tick by phase, on the base build's runs (the
    ones without a flight ring), from the instrumented build."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    source = AB_DIR / "fused_chunk_cycles.cu"
    source.write_text(instrumented_source())
    base = (False,) * len(kernel.FEATURES)
    lib = nvcc(source, base, "cycles")
    real_load = kernel.load
    kernel.load = lambda flags: lib
    h, out = (ctypes.c_ulonglong * 4)(), {}
    try:
        for label, cfg, g, fl, _ in runs:
            if kernel.features(cfg) != base or fl:
                continue
            leaves = kernel.kinit(cfg, state.init(cfg, g))[0]
            lib.fc_read_cycles(h)
            _, ms = timed(lambda: kernel.kstep(cfg, leaves, 0,
                                               chip_smoke.CHUNK))
            lib.fc_read_cycles(h)
            n = h[3]
            out[label] = {"ms_instrumented": ms,
                          "before_steps": h[0] / n, "node_steps": h[1] / n,
                          "tail": h[2] / n}
            print(f"{label}: cycles per tile and tick {out[label]}",
                  flush=True)
    finally:
        kernel.load = real_load
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    old_source = Path(argv[0]).resolve()
    card = chip_smoke.gpu_line()
    runs = chip_smoke.all_runs()
    flag_sets = sorted({kernel.features(cfg) for _, cfg, *_ in runs})
    kernel.build(flag_sets)
    with concurrent.futures.ThreadPoolExecutor(len(flag_sets)) as pool:
        old = dict(zip(flag_sets, pool.map(
            lambda f: nvcc(old_source, f, "old"), flag_sets)))
    results = {}
    for label, cfg, g, fl, _ in runs:
        flight = recorder.flight_init(g) if fl else None
        leaves = kernel.kinit(cfg, state.init(cfg, g), flight=flight)[0]
        lib = old[kernel.features(cfg)]
        steps = (lambda: old_step(lib, cfg, leaves, 0, chip_smoke.CHUNK),
                 lambda: kernel.kstep(cfg, leaves, 0, chip_smoke.CHUNK))
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
    cycles = phase_cycles(runs) if "--phase-cycles" in argv else None
    print(card)
    print(json.dumps({"card": card, "runs": results, "cycles": cycles}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
