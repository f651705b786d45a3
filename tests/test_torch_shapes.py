"""The shapes and budgets of the fused-chunk kernel, on the CPU: the port's
`kernel.supported` takes every shape the JAX package's
`pkernel.supported` takes over a grid of k, log_cap and program lengths
(both pure Python: no JAX program is compiled), refuses k=31 as the
reference does, sizes a group's shared memory from the config, and
budgets free memory less a stated margin."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.sim import pkernel
from raft_tpu_torch import nemesis
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.sim import kernel, state


def program(n: int) -> tuple:
    """n one-tick slow-follower clauses (fresh cids)."""
    return nemesis.program(*(nemesis.slow_follower(t, t + 1)
                             for t in range(n)))


def both(**kw):
    """The same universe in the port and in the JAX package."""
    return RaftConfig(**kw), JaxConfig(**kw)


@pytest.mark.parametrize("log_cap", [8, 32, 128, 1024])
@pytest.mark.parametrize("k", [1, 3, 5, 9, 16, 30])
def test_supported_includes_the_reference(k, log_cap):
    """Wherever the reference kernel takes a shape, so does the port's,
    for programs of 0, 16, 17 and 64 clauses."""
    for n in (0, 16, 17, 64):
        cfg, jcfg = both(k=k, log_cap=log_cap,
                         compact_every=min(8, log_cap - 2),
                         nemesis=program(n))
        if pkernel.supported(jcfg):
            assert kernel.supported(cfg), (k, log_cap, n)
        assert kernel.supported(cfg) == (
            kernel.shared_bytes(cfg) <= kernel.SMEM_PER_BLOCK)


def test_k31_is_refused():
    cfg, jcfg = both(k=31)
    assert not pkernel.supported(jcfg)
    assert not kernel.supported(cfg) and not kernel.shape_supported(cfg)
    assert "k <= 30" in kernel.shape_refusal(cfg)
    assert kernel.supported(RaftConfig(k=30))


def test_shared_memory_per_group():
    """A group's shared words: its static rows (no flight rows), the rings
    and the mailbox twice, each from an even word, the participation
    words, padded to twice an odd number; a block's least shared memory
    adds the clause table."""
    head = RaftConfig(seed=42)
    assert kernel.shared_words_per_group(head) == 210 + 2 * 970 == 2150
    assert kernel.shared_bytes(head) == 8600
    assert kernel.SMEM_PER_BLOCK // kernel.shared_bytes(head) == 27
    mix = RaftConfig(seed=1, prevote=True, read_every=8, reconfig_prob=0.3,
                     transfer_prob=0.3)
    assert kernel.shared_bytes(mix) == 10_600
    gray = dataclasses.replace(head, nemesis=nemesis.gray_mix(600))
    # one participation word: 2,151 -> 2,152, a multiple of 4 -> 2,154
    assert kernel.shared_bytes(gray) == 4 * 2154 + 4 * 8 * 2
    big = dataclasses.replace(head, nemesis=program(40))
    assert kernel.shared_words_per_group(big) == 2154
    # the flight ring stays in device memory
    assert kernel.working_words_per_group(head, 64) == \
        kernel.working_words_per_group(head) + 6 * 64


def test_budgets_are_free_memory_less_a_margin(monkeypatch):
    class Meminfo:
        def __init__(self, _):
            pass

        def read_text(self):
            return ("MemTotal:       105906176 kB\n"
                    "MemFree:         1000000 kB\n"
                    "MemAvailable:    90000000 kB\n")

    monkeypatch.setattr(kernel, "Path", Meminfo)
    assert kernel.host_budget() == 90_000_000 * 1024 - kernel.HOST_MARGIN
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (70 * 2 ** 30, 80 * 2 ** 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 5 * 2 ** 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 2 * 2 ** 30)
    assert kernel.hbm_budget() == (70 + 3) * 2 ** 30 - kernel.HBM_MARGIN


def test_host_bytes_count_every_host_copy():
    """A streamed run from a host State holds the input State, the pinned
    wire and the gathered output; from a State on the card, the wire."""
    cfg = RaftConfig(seed=42, pack_bools=True, pack_ring=True)
    st = state.init(cfg, 1, device="cpu")
    leaves = []
    state._map_named(st, "", lambda _, a: leaves.append(a))
    per_state = sum(a.numel() * a.element_size() for a in leaves) + 4 * 3
    assert kernel.state_bytes_per_group(cfg) == per_state
    wire = 4 * kernel.wire_words_per_group(cfg)
    assert kernel.host_bytes(cfg, 10) == 10 * (wire + 2 * per_state)
    assert kernel.host_bytes(cfg, 10, state_on_host=False) == 10 * wire
    assert kernel.state_bytes_per_group(cfg, 64) == per_state + 4 * 6 * 64
