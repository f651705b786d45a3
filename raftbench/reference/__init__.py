"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch tick (`raft_tpu_torch/sim/step.py` and what it needs: the
config, the counter-based hashes, state init, the client workload, the
safety fold, the run loop's metrics and the flight recorder), with its
imports pointed at this package.

It imports nothing of `raft_tpu_torch`, `raft_tpu` or `jax`, and takes
nothing the program made: it rebuilds every group it judges from the
configuration, the seed and the group's global id (`state.init(...,
group_ids=...)`) and runs it tick by tick. Later changes to the program
do not reach it; a change of the semantics is a change of the benchmark.
"""
