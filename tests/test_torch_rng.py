"""Bit-parity of the port's counter-based hashes (raft_tpu_torch.utils.trng,
u32 emulated in int64) with the JAX lanes (raft_tpu.utils.jrng) and the
Python ints (raft_tpu.utils.rng), on coordinate grids: values near
2**32, negative int32 lanes (two's complement), ticks across epoch
boundaries. Tolerance 0: every value is an integer hash."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.utils import jrng
from raft_tpu.utils import rng as prng
from raft_tpu_torch.utils import rng as trng_consts
from raft_tpu_torch.utils import trng

EDGE_U32 = np.array([0, 1, 2, 3, 12345, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF,
                     0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_constants_match_reference():
    for name in ("GOLD", "TAG_TIMEOUT", "TAG_DROP", "TAG_CRASH", "TAG_PART",
                 "TAG_PART_SIDE", "TAG_CMD", "TAG_RECONFIG",
                 "TAG_RECONFIG_NODE", "TAG_TRANSFER", "TAG_TRANSFER_NODE",
                 "TAG_CLIENT_ARRIVAL", "TAG_CLIENT_VAL", "TAG_NEM_GROUP",
                 "TAG_NEM_NODE", "TAG_NEM_LINK", "TAG_NEM_CRASH",
                 "TAG_NEM_SIDE", "TAG_NEM_BURST", "TAG_NEM_DISK",
                 "TAG_NEM_COMPACT", "NEM_SLOW", "NEM_FLAKY", "NEM_WAN",
                 "NEM_SKEW", "NEM_STORM", "NEM_WAVE", "NEM_DISK",
                 "NEM_COMPACT", "NEM_KINDS", "NEM_LINK_KINDS",
                 "NEM_CRASH_KINDS", "NEM_TIMING_KINDS", "NEM_DISK_KINDS",
                 "NEM_COMPACT_KINDS"):
        assert getattr(trng_consts, name) == getattr(prng, name), name
    assert trng_consts.SEED0 == prng._SEED0


def test_mix32_parity_near_u32_edges():
    rs = np.random.default_rng(0)
    xs = np.concatenate([EDGE_U32, rs.integers(0, 2 ** 32, 4096,
                                               dtype=np.uint32)])
    got = _np(trng.mix32(_t(xs.astype(np.int64))))
    np.testing.assert_array_equal(got, np.asarray(jrng.mix32(xs)))
    assert [trng.mix32(int(x)) for x in EDGE_U32] == \
        [prng.mix32(int(x)) for x in EDGE_U32]


def test_hash_u32_folds_in_order_with_negative_lanes():
    rs = np.random.default_rng(1)
    a = rs.integers(-2 ** 31, 2 ** 31, (64, 1), dtype=np.int64).astype(
        np.int32)
    b = rs.integers(-2 ** 31, 2 ** 31, (1, 32), dtype=np.int64).astype(
        np.int32)
    got = _np(trng.hash_u32(42, 7, _t(a), _t(b)))
    want = np.asarray(jrng.hash_u32(42, 7, a, b))
    np.testing.assert_array_equal(got, want)
    assert got[3, 5] == prng.hash_u32(42, 7, int(a[3, 0]) & 0xFFFFFFFF,
                                      int(b[0, 5]) & 0xFFFFFFFF)
    swapped = _np(trng.hash_u32(42, 7, _t(b.T), _t(a.T)))
    assert (swapped != got.T).any()


def test_election_deadline_parity_and_range():
    seed, emin, erange = 3, 10, 10
    g = np.arange(64, dtype=np.int32)[:, None, None]
    n = np.arange(5, dtype=np.int32)[None, :, None]
    d = np.arange(40, dtype=np.int32)[None, None, :]
    got = trng.election_deadline(seed, _t(g), _t(n), _t(d), emin, erange)
    assert got.dtype == torch.int32
    want = np.asarray(jrng.election_deadline(seed, g, n, d, emin, erange))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= emin and int(got.max()) < emin + erange
    assert int(trng.election_deadline(seed, 2, 3, 4, emin, erange)) == \
        prng.election_deadline(seed, 2, 3, 4, emin, erange)


@pytest.mark.parametrize("prob", [0.02, 0.3, 1.0])
def test_link_dropped_parity(prob):
    drop_u32 = min(int(prob * 2 ** 32), 0xFFFFFFFF)
    g = np.arange(32, dtype=np.int32)[:, None, None, None]
    t = np.arange(0, 200, 7, dtype=np.int32)[None, :, None, None]
    s = np.arange(5, dtype=np.int32)[None, None, :, None]
    d = np.arange(5, dtype=np.int32)[None, None, None, :]
    got = trng.link_dropped(9, _t(g), _t(t), _t(s), _t(d), drop_u32)
    want = np.asarray(jrng.link_dropped(9, g, t, s, d, drop_u32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not trng.link_dropped(9, _t(g), _t(t), _t(s), _t(d), 0).any()


@pytest.mark.parametrize("epoch", [16, 64])
def test_node_alive_across_epoch_boundaries(epoch):
    crash_u32 = int(0.3 * 2 ** 32)
    g = np.arange(48, dtype=np.int32)[:, None, None]
    n = np.arange(5, dtype=np.int32)[None, :, None]
    ticks = np.array(sorted({e * epoch + o for e in range(6)
                             for o in (-1, 0, 1) if e * epoch + o >= 0}),
                     dtype=np.int32)
    t = ticks[None, None, :]
    got = trng.node_alive(43, _t(g), _t(n), _t(t), crash_u32, epoch)
    want = np.asarray(jrng.node_alive(43, g, n, t, crash_u32, epoch))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.all(dim=-1).logical_not().any()   # some crashes drawn
    assert bool(prng.node_alive(43, 5, 2, epoch, crash_u32, epoch)) == \
        bool(got[5, 2, list(ticks).index(epoch)])


def test_link_partitioned_parity():
    part_u32 = int(0.6 * 2 ** 32)
    g = np.arange(40, dtype=np.int32)[:, None, None, None]
    t = np.arange(0, 400, 13, dtype=np.int32)[None, :, None, None]
    s = np.arange(5, dtype=np.int32)[None, None, :, None]
    d = np.arange(5, dtype=np.int32)[None, None, None, :]
    got = trng.link_partitioned(15, _t(g), _t(t), _t(s), _t(d), part_u32, 40)
    want = np.asarray(jrng.link_partitioned(15, g, t, s, d, part_u32, 40))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any()


def test_client_payload_parity():
    g = np.arange(16, dtype=np.int32)[:, None, None]
    term = np.array([0, 1, 7, 2 ** 31 - 1], dtype=np.int32)[None, :, None]
    idx = np.arange(0, 300, 11, dtype=np.int32)[None, None, :]
    got = trng.client_payload(42, _t(g), _t(term), _t(idx))
    assert got.dtype == torch.int32
    want = np.asarray(jrng.client_payload(42, g, term, idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < 2 ** 30


def test_digest_update_parity():
    rs = np.random.default_rng(2)
    dig = np.concatenate([EDGE_U32, rs.integers(0, 2 ** 32, 246,
                                                dtype=np.uint32)])
    idx = rs.integers(0, 2 ** 31, 256, dtype=np.int64).astype(np.int32)
    pay = rs.integers(0, 2 ** 30, 256, dtype=np.int64).astype(np.int32)
    got = trng.digest_update(_t(dig.astype(np.int64)), _t(idx), _t(pay))
    want = np.asarray(jrng.digest_update(dig, idx, pay))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got[9]) == prng.digest_update(int(dig[9]), int(idx[9]),
                                             int(pay[9]))


@pytest.mark.parametrize("kind", ["reconfig", "transfer"])
@pytest.mark.parametrize("prob", [0.0, 0.3, 1.0])
def test_schedule_draws_parity(kind, prob):
    """The membership-change and transfer schedules: whether an epoch
    fires, and the node it names, for k in 1..8."""
    u32 = min(int(prob * 2 ** 32), 0xFFFFFFFF)
    g = np.arange(-4, 60, dtype=np.int32)[:, None]
    epoch = np.arange(0, 80, 3, dtype=np.int32)[None, :]
    fires = getattr(trng, f"{kind}_fires")(11, _t(g), _t(epoch), u32)
    want = np.asarray(getattr(jrng, f"{kind}_fires")(11, g, epoch, u32))
    np.testing.assert_array_equal(fires.numpy(), want)
    assert bool(fires.any()) == (u32 != 0)
    for k in (1, 3, 5, 8):
        got = getattr(trng, f"{kind}_target")(11, _t(g), _t(epoch), k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(getattr(jrng, f"{kind}_target")(11, g, epoch, k)))
    assert int(getattr(trng, f"{kind}_target")(11, 5, 7, 5)) == \
        getattr(prng, f"{kind}_target")(11, 5, 7, 5)


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
def test_client_draws_parity(rate):
    """Arrivals on a (group, sid, tick) grid and op values on a
    (group, sid, seq) grid, against jrng and the Python ints."""
    clients_u32 = min(int(rate * 2 ** 32), 0xFFFFFFFF)
    g = np.arange(40, dtype=np.int32)[:, None, None]
    sid = np.arange(16, dtype=np.int32)[None, :, None]
    t = np.arange(0, 300, 7, dtype=np.int32)[None, None, :]
    got = trng.client_arrives(9, _t(g), _t(sid), _t(t), clients_u32)
    want = np.asarray(jrng.client_arrives(9, g, sid, t, clients_u32))
    np.testing.assert_array_equal(_np(got), want)
    if rate:
        assert 0 < want.mean() < 1
        assert bool(got[3, 4, 5]) == prng.client_arrives(9, 3, 4, 35,
                                                         clients_u32)
    seq = np.arange(0, 1024, 31, dtype=np.int32)[None, None, :]
    val = trng.client_val(9, _t(g), _t(sid), _t(seq))
    assert val.dtype == torch.int32 and int(val.max()) <= 0x3FF
    np.testing.assert_array_equal(
        _np(val), np.asarray(jrng.client_val(9, g, sid, seq)))
    assert int(val[2, 7, 3]) == prng.client_val(9, 2, 7, 93)
