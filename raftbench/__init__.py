"""The benchmark of `raft_tpu_torch`, the PyTorch/CUDA port of raft-tpu.

One run measures one cell of `BENCHMARK.json` (a configuration under a
traffic mix) on the cards of the machine it starts on:

    python3 -m raftbench.run --workload raft5.steady --seed 7 \
        --seconds 30 --trace 0

It builds the kernel the cell needs, warms up one universe, then runs
back-to-back universes (`state.init` -> `kernel.prun` or
`kmesh.prun_sharded` -> Metrics and flight ring on the host) for the
window, checks a seed-drawn sample of the groups it ran against the
plain reference in `raftbench/reference/`, and prints one JSON line.

Everything of one configuration, traffic mix or metric is a file of its
own, found by its name: `configs/<config>.json` (through the `file` of
its `BENCHMARK.json` entry), `traffic/<traffic>.json` and
`metrics/<metric>.py`. `system.py` is the only module that imports the
program; nothing here imports `jax` or `raft_tpu`.
"""
