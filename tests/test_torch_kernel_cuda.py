"""The fused-chunk CUDA kernel against its plain PyTorch version on the
card: full State and Metrics bit-identical (tolerance 0), on steady,
faulted and command-free universes and on states with planted safety
violations (where the kernel's own safety fold must clear exactly the
planted groups). Needs an NVIDIA GPU and nvcc; skips without CUDA.
Imports no JAX, so it runs on a card machine without it (skipping the
suite's JAX conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, run, state
from raft_tpu_torch.verify import plant

CONFIG4 = dict(seed=43, crash_prob=0.3, crash_epoch=64, partition_prob=0.2,
               partition_epoch=64, drop_prob=0.02)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def assert_same(cfg, g, leaves, plain):
    for a, b in zip(kernel.kfinish(cfg, leaves, g),
                    kernel.kfinish(cfg, plain, g)):
        for name, x, y in zip(a._fields, a, b):
            if x is None:
                continue
            for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert u is None or torch.equal(u, v), name


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(n_groups=300, k=3, seed=7, drop_prob=0.05, crash_prob=0.1,
         crash_epoch=16, partition_prob=0.2, partition_epoch=16, log_cap=8,
         compact_every=4),
    dict(n_groups=1000, **CONFIG4),
    # bench.py bench_election_rounds: no commands, crash 0.5/32
    dict(n_groups=500, seed=44, cmds_per_tick=0, crash_prob=0.5,
         crash_epoch=32),
], ids=["fault_mix", "config4", "election_rounds"])
def test_kernel_matches_plain_on_card(cuda, kw):
    cfg = RaftConfig(**kw)
    leaves, g = kernel.kinit(cfg, state.init(cfg, device=cuda))
    plain = leaves
    before = kernel.kstep.launches
    for at, n in ((0, 33), (33, 40)):
        leaves = kernel.kstep(cfg, leaves, at, n)
        plain = kernel.kstep_plain(cfg, plain, at, n)
    torch.cuda.synchronize()
    assert kernel.kstep.launches == before + 2
    assert_same(cfg, g, leaves, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(n_groups=64, seed=42),
                                dict(n_groups=1000, **CONFIG4)],
                         ids=["headline", "config4"])
def test_kernel_safety_fold_on_planted_violations(cuda, kw):
    cfg, t0 = RaftConfig(**kw), 37
    st, m = run.run(cfg, state.init(cfg, device=cuda), t0)
    st, planted = plant.plant_violations(cfg, st)
    leaves, g = kernel.kinit(cfg, st, m)
    out = kernel.kstep(cfg, leaves, t0, 3)
    plain = kernel.kstep_plain(cfg, leaves, t0, 3)
    assert_same(cfg, g, out, plain)
    _, mk = kernel.kfinish(cfg, out, g, m)
    unsafe = (~mk.safety.bool()).nonzero().flatten().tolist()
    assert unsafe == sorted(planted.values())
