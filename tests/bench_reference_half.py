"""The JAX half of tests/test_torch_bench.py, run as a child process so its
XLA compiles overlap the port's half:

    python tests/bench_reference_half.py CHUNK GROUPS FAULT_TICKS OUT

runs bench.py's bench_throughput(GROUPS, CHUNK) and
bench_fault_latency(43, GROUPS, FAULT_TICKS) on the CPU with bench.CHUNK
set to CHUNK (bench.py itself unchanged), its manifest in a file beside
OUT, and pickles to OUT: both segment dicts, `_timed_chunks`' result of
the throughput segment (its trees as numpy), and that reference extended
by one chunk to the kernel's end tick (bench.py:439-441)."""

from __future__ import annotations

import os
import pickle
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raft_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import bench  # noqa: E402
from raft_tpu.obs import run_recorded  # noqa: E402


def main(chunk: int, groups: int, fault_ticks: int, out: str) -> int:
    bench.CHUNK = chunk
    os.environ["RAFT_TPU_MANIFEST"] = out + ".manifest.jsonl"
    timed = []
    orig = bench._timed_chunks

    def rec(*args, **kw):
        res = orig(*args, **kw)
        timed.append(res)
        return res

    bench._timed_chunks = rec
    tp = bench.bench_throughput(groups, chunk)
    c4 = bench.bench_fault_latency(43, groups, fault_ticks,
                                   "config-4 fault run")
    res = timed[0]
    st, m, f = res[5:8]
    ext = run_recorded(bench._seg_cfg(seed=42), st, chunk,
                       chunk + res[3], m, f)
    host = [jax.tree.map(np.asarray, t) for t in (st, m, f, *ext)]
    with open(out + ".part", "wb") as fh:
        pickle.dump({"throughput": tp, "config-4": c4,
                     "timed": res[:5] + tuple(host[:3]),
                     "extended": tuple(host[3:])}, fh)
    os.replace(out + ".part", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4]))
