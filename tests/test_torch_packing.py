"""The port's packed wire (raft_tpu_torch/sim/kernel.py) against the JAX
package, tolerance 0: the layout's saving against `pkernel`'s pinned
registry, the byte model against the real wire, the plain codec
(`pack`/`unpack`) round trip and its sticky overflow flag, `prun` and
chunked `kstep` through the packed and aliased wire on CPU tensors
against JAX `run.run`, `wire_hist=False`, and the ring-overflow flag
against `pkernel._ring_base_ov` with `kfinish`'s refusal. The universes
are the shared `kmesh.faulted_64_cfg()` and `workload.clients_64_cfg()`
at the shapes the JAX tests compile (`run.run` over 48 ticks)."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.clients import clients_64_cfg
from raft_tpu.config import RaftConfig as JaxConfig
from raft_tpu.parallel.kmesh import faulted_64_cfg
from raft_tpu.sim import pkernel
from raft_tpu.sim import state as jstate
from raft_tpu.utils.trees import trees_equal_why
from raft_tpu_torch.config import LAYOUT_FIELDS, RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.sim import kernel, run, state
from jax_programs import release_jax_programs  # noqa: F401

jrun = importlib.import_module("raft_tpu.sim.run")

PACKED = dict(pack_bools=True, pack_ring=True)
JFAULT, JCLIENTS = faulted_64_cfg(), clients_64_cfg()


def port(jcfg, **kw) -> RaftConfig:
    return RaftConfig(**{**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(jcfg)}, **kw})


def assert_same(jax_tree, torch_tree, what):
    ok, why = trees_equal_why(jax.tree.map(np.asarray, jax_tree),
                              state.to_numpy(torch_tree))
    assert ok, f"{what}: {why}"


@pytest.fixture(scope="module")
def ref():
    """JAX `run.run` over 48 ticks of each universe, as
    tests/test_packing.py and tests/test_clients.py run them."""
    return {"faulted": jrun.run(JFAULT, jstate.init(JFAULT), 48, 0,
                                jrun.metrics_init(64)),
            "clients": jrun.run(JCLIENTS, jstate.init(JCLIENTS), 48)}


UNIVERSES = {"faulted": JFAULT, "clients": JCLIENTS}


def test_layout_registries_are_the_reference_ones():
    import raft_tpu.config as jconfig
    import raft_tpu_torch.config as tconfig
    for name in ("LAYOUT_FIELDS", "STREAM_FIELDS", "NARROW_FIELDS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert LAYOUT_FIELDS == ("pack_bools", "pack_ring", "alias_wire",
                             "wire_hist")


@pytest.mark.parametrize("clients", [False, True],
                         ids=["headline", "clients"])
def test_packed_saving_is_the_reference_pin(clients):
    """Packing saves 1,172 B/group at the headline and on the client
    universe (856 B of bit lanes, 316 B of ring deltas), as JAX's
    registry does (tests/test_packing.py); the at-rest headline wire is
    3,544 B/group."""
    kw = dict(seed=42)
    if clients:
        kw.update(sessions=True, cmds_per_tick=0, client_rate=0.2,
                  client_slots=4, client_retry_backoff=8)
    off, on = RaftConfig(**kw), RaftConfig(**kw, **PACKED)
    joff, jon = JaxConfig(**kw), JaxConfig(**kw, **PACKED)
    saved = 4 * (kernel.wire_words_per_group(off)
                 - kernel.wire_words_per_group(on))
    assert saved == 4 * (pkernel.wire_words_per_group(joff)
                         - pkernel.wire_words_per_group(jon)) == 1_172
    bools = 4 * (kernel.wire_words_per_group(off)
                 - kernel.wire_words_per_group(
                     RaftConfig(**kw, pack_bools=True)))
    assert bools == 856
    if not clients:
        assert 4 * kernel.wire_words_per_group(off) == 4_716
        assert 4 * kernel.wire_words_per_group(on) == 3_544


@pytest.mark.parametrize("knobs", [
    {}, dict(pack_bools=True), dict(pack_ring=True), PACKED,
    dict(PACKED, alias_wire=True, wire_hist=False)],
    ids=["off", "bools", "ring", "packed", "all_dials"])
@pytest.mark.parametrize("universe", list(UNIVERSES))
def test_byte_model_words_are_the_real_rows(universe, knobs):
    """The model's words at rest and accumulator words equal kinit's real
    tensors, with and without the flight ring, and a launch's words are
    the at-rest and working forms it holds (its double buffer lives in
    shared memory)."""
    cfg = port(UNIVERSES[universe], **knobs)
    st0 = state.init(cfg, device="cpu")
    for flight in (None, recorder.flight_init(64, device="cpu")):
        ring = 0 if flight is None else recorder.RING
        (wire, acc), g = kernel.kinit(cfg, st0, flight=flight)
        assert wire.shape == (kernel.wire_words_per_group(cfg, ring), g)
        assert acc.shape == (kernel.acc_words(cfg),)
        work = kernel.unpack_wire(cfg, wire)
        assert work.shape[0] == kernel.working_words_per_group(cfg, ring)
        rest = kernel.wire_words_per_group(cfg, ring)
        held = (2 - cfg.alias_wire) * rest + (
            work.shape[0] if kernel.packs(cfg) else 0)
        assert kernel.launch_words_per_group(cfg, ring) == held


def test_launch_model_at_the_headline():
    """The headline's launch: 9,432 B/group unpacked (wire in and out),
    11,804 packed without aliasing, 8,260 packed and aliased (the double
    buffer lives in shared memory); the resident ceiling is the exact
    boundary of hbm_bytes."""
    h = RaftConfig(seed=42)
    per_group = {}
    for name, knobs in (("off", {}), ("packed", PACKED),
                        ("aliased", dict(PACKED, alias_wire=True))):
        cfg = dataclasses.replace(h, **knobs)
        per_group[name] = 4 * kernel.launch_words_per_group(cfg)
        budget = 80 * 10 ** 9
        top = kernel.hbm_ceiling_groups(cfg, hbm=budget)
        assert kernel.hbm_bytes(cfg, top) <= budget \
            < kernel.hbm_bytes(cfg, top + 1)
        assert kernel.supported(cfg, top, hbm=budget)
        assert not kernel.supported(cfg, top + 1, hbm=budget)
    assert per_group == {"off": 9_432, "packed": 11_804,
                         "aliased": 8_260}
    nohist = RaftConfig(seed=42, wire_hist=False, alias_wire=True, **PACKED)
    assert kernel.acc_words(nohist) == 2
    assert kernel.hbm_bytes(nohist, 1000) == 4 * (8_260 // 4 * 1000 + 2)


def test_codec_round_trips_exactly_with_every_feature():
    """`unpack(pack(w)) == w` on a seeded working wire with every gated
    feature on (12 bool mailbox slots -> 2 shared words per destination
    at k=3), and the sticky flag survives an unpack and a re-pack."""
    cfg = port(JFAULT, prevote=True, transfer_prob=0.5, read_every=4,
               sessions=True, cmds_per_tick=0, client_rate=0.3,
               client_slots=2, **PACKED)
    assert len(kernel._mb_bools(cfg)) == 12 and kernel._mb_words(cfg) == 2
    rows = kernel.working_words_per_group(cfg)
    rng = np.random.default_rng(5)
    wire = torch.from_numpy(rng.integers(0, 2 ** 31 - 2 ** 16, (rows, 128),
                                         dtype=np.int64).astype(np.int32))
    at = kernel._work_at(cfg)
    for f in ("votes", "alive_prev") + kernel._mb_bools(cfg):
        s, n = at[f]
        wire[s:s + n] &= 1
    s, n = at["log_term"]   # an in-range spread in every group
    wire[s:s + n] = wire[s] + (wire[s:s + n] & 0xFFFF)
    packed = kernel.pack(cfg, wire)
    assert packed.shape[0] == kernel.wire_words_per_group(cfg) < rows
    back, ov = kernel.unpack(cfg, packed)
    assert torch.equal(back, wire) and int(ov.sum()) == 0
    flagged = torch.zeros(128, dtype=torch.int32)
    flagged[::3] = 1
    again = kernel.pack(cfg, back, flagged)
    back2, ov2 = kernel.unpack(cfg, again)
    assert torch.equal(back2, wire) and torch.equal(ov2, flagged)
    assert torch.equal(kernel.pack(cfg, back2, ov2), again)
    assert torch.equal(kernel.ring_flags(cfg, again), flagged)


@pytest.mark.parametrize("knobs", [
    dict(pack_bools=True), dict(pack_ring=True), dict(alias_wire=True),
    dict(PACKED, alias_wire=True)],
    ids=["bools", "ring", "alias", "packed_alias"])
@pytest.mark.parametrize("universe", list(UNIVERSES))
def test_packed_chunks_match_jax_run(ref, universe, knobs):
    """kinit -> two 24-tick ksteps -> kfinish through the layout, on CPU
    tensors, equals JAX `run.run` on State and Metrics; under alias_wire
    each launch returns its input tensors, written over."""
    cfg = port(UNIVERSES[universe], **knobs)
    sj, mj = ref[universe]
    leaves, g = kernel.kinit(cfg, state.init(cfg, device="cpu"))
    for at in (0, 24):
        out = kernel.kstep(cfg, leaves, at, 24)
        assert (out[0] is leaves[0] and out[1] is leaves[1]) \
            == cfg.alias_wire
        leaves = out
    st, m = kernel.kfinish(cfg, leaves, g)
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    assert kernel.kcommitted(cfg, leaves, g) == jrun.total_rounds(mj) > 0
    assert kernel.kelections(cfg, leaves, g) == int(mj.elections)


def test_packed_prun_with_flight_matches_the_unpacked_wire(ref):
    """`prun` with a flight ring through the packed, aliased wire: the
    State and Metrics of JAX `run.run`, and the flight rings of the
    unpacked wire (the rings are copied as they are)."""
    cfg = port(JCLIENTS, alias_wire=True, **PACKED)
    st0 = state.init(cfg, device="cpu")
    st, m, fl = kernel.prun(cfg, st0, 48,
                            flight=recorder.flight_init(64, device="cpu"))
    sj, mj = ref["clients"]
    assert_same(sj, st, "state")
    assert_same(mj, m, "metrics")
    _, _, fl0 = kernel.prun(port(JCLIENTS), st0, 48,
                            flight=recorder.flight_init(64, device="cpu"))
    for name, a, b in zip(fl._fields, fl, fl0):
        assert torch.equal(a, b), name
    assert kernel.kacked(cfg, kernel.kinit(cfg, st, m)[0], 64) \
        == jrun.total_client_ops(mj)


@pytest.mark.parametrize("universe", list(UNIVERSES))
def test_wire_hist_off_state_exact_hist_passes_through(ref, universe):
    """wire_hist=False: acc holds no histogram rows, the State and every
    lane equal JAX's, and kfinish passes the caller's histograms
    through unchanged (the kernel tracked none)."""
    cfg = port(UNIVERSES[universe], wire_hist=False)
    sj, mj = ref[universe]
    clients = cfg.clients_u32 != 0
    rng = np.random.default_rng(11)
    base = run.metrics_init(64, clients=clients, device="cpu")
    base = base._replace(hist=torch.from_numpy(
        rng.integers(0, 9, 512).astype(np.int32)))
    if clients:
        base = base._replace(client_hist=torch.from_numpy(
            rng.integers(0, 9, 512).astype(np.int32)))
    leaves, g = kernel.kinit(cfg, state.init(cfg, device="cpu"))
    assert leaves[1].shape == (3 if clients else 2,)
    leaves = kernel.kstep(cfg, leaves, 0, 48)
    st, m = kernel.kfinish(cfg, leaves, g, base)
    assert_same(sj, st, "state")
    assert torch.equal(m.hist, base.hist)
    assert kernel.khist(cfg, leaves, g).shape == (0,)
    lanes = ("committed", "leaderless", "elections", "max_latency",
             "safety")
    if clients:
        assert torch.equal(m.client_hist, base.client_hist)
        lanes += ("client_acked", "client_retries", "client_max_lat")
    for lane in lanes:
        assert np.array_equal(np.asarray(getattr(mj, lane)),
                              getattr(m, lane).numpy()), lane


def test_ring_overflow_flag_is_the_reference_and_refused():
    """Planted in-group term spreads of 0xFFFF (encodable) and 0x10000
    and 2^17 (not): the port's per-group flag and base equal JAX
    `_ring_base_ov` on the same state; kfinish refuses the flag with
    `_check_ring_overflow`'s words, right after kinit and, the flag
    being sticky, after a launch."""
    cfg = port(JFAULT, pack_ring=True)
    st = state.init(cfg, device="cpu")
    lt = st.nodes.log_term.clone()
    lt[0, 0, 0] = 1 << 17
    lt[1, 2, 5] = 0xFFFF
    lt[2, 1, 7] = 0x10000
    lt[3, :, :] = 70_000          # a wide base, no spread
    lt[3, 0, 1] = 70_000 + 0xFFFF
    st = st._replace(nodes=st.nodes._replace(log_term=lt))
    (wire, acc), g = kernel.kinit(cfg, st)
    jbase, jov = pkernel._ring_base_ov(
        cfg, jnp.asarray(lt.permute(1, 2, 0).numpy()))
    flags = kernel.ring_flags(cfg, wire)
    assert flags.tolist() == np.asarray(jov).tolist()
    assert flags[:4].tolist() == [1, 0, 1, 0]
    row = kernel._rest_at(cfg)[kernel.RING_BASE][0]
    assert (wire[row] & 0x7FFFFFFF).tolist() == np.asarray(jbase).tolist()
    with pytest.raises(ValueError, match="pack_ring: ring-term delta "
                                         "overflowed the 16-bit half-lane "
                                         "in 2 group"):
        kernel.kfinish(cfg, (wire, acc), g)
    leaves = kernel.kstep(cfg, (wire, acc), 0, 2)
    assert kernel.ring_flags(cfg, leaves[0])[:4].tolist() == [1, 0, 1, 0]
    with pytest.raises(ValueError, match="pack_ring"):
        kernel.kfinish(cfg, leaves, g)


def test_pack_ring_needs_an_even_log_cap():
    with pytest.raises(ValueError, match="log_cap must be even"):
        RaftConfig(log_cap=33, pack_ring=True)
    with pytest.raises(AssertionError):
        JaxConfig(log_cap=33, pack_ring=True)
    assert RaftConfig(log_cap=33, pack_bools=True).log_cap == 33
