"""A sharded resident run whose input is shards returns shards
(`parallel/kmesh.py` `prun_sharded`, `kfinish_sharded(shards_out=True)`):
each State and Flight shard decoded on its own device, the Metrics one
value on the first, the same bits as the gathered path and the
single-device run (`kernel.prun`, which tests/test_torch_mesh.py holds
to the JAX package). And the byte model that budgets it: each card
charged the finish of its own shards, the first also the fleet's
Metrics, at a hand computation's boundary. No JAX program is compiled:
the shards are CPU "devices" and the engines the port's plain tick."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from raft_tpu_torch.analysis import bytemodel
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.parallel import groups, kmesh, mesh
from raft_tpu_torch.sim import kernel, state
from raft_tpu_torch.utils.trees import trees_equal_why

CPU3 = ("cpu",) * 3
FAULT = kmesh.faulted_64_cfg()
DIALS = {"wide": {},
         "packed-clients": dict(pack_bools=True, pack_ring=True,
                                sessions=True, cmds_per_tick=0,
                                client_rate=0.3, client_slots=2)}


def _same(a, b, what):
    ok, why = trees_equal_why(state.to_numpy(a), state.to_numpy(b))
    assert ok, f"{what}: {why}"


@pytest.mark.parametrize("dials", DIALS.values(), ids=list(DIALS))
def test_shards_in_shards_out_equal_the_gathered_run(dials):
    cfg = dataclasses.replace(FAULT, **dials)
    st0 = state.init(cfg, 64, device="cpu")
    fl = recorder.flight_init(64, device="cpu")
    whole = kmesh.prun_sharded(cfg, st0, 8, CPU3, flight=fl, chunk_ticks=4)
    shards = mesh.shard_state(st0, CPU3)
    st_s, m_s, f_s = kmesh.prun_sharded(cfg, shards, 8, CPU3, flight=fl,
                                        chunk_ticks=4)
    assert isinstance(st_s, list) and len(st_s) == len(f_s) == 3
    assert [s.alive_prev.shape[0] for s in st_s] == [
        s1 - s0 for s0, s1 in groups.spans(64, 3)]
    assert all(s.alive_prev.device == torch.device(d)
               for s, d in zip(st_s, CPU3))
    _same(whole[0], groups.cat_states(st_s, "cpu"), "State")
    _same(whole[1], m_s, "Metrics")
    _same(whole[2], groups.cat_flights(f_s, "cpu"), "Flight")
    single = kernel.prun(cfg, st0, 8, flight=fl)
    _same(single[0], groups.cat_states(st_s, "cpu"), "State (one device)")
    _same(single[1], m_s, "Metrics (one device)")


def test_kfinish_sharded_gets_the_same_choice():
    st0 = state.init(FAULT, 64, device="cpu")
    m0 = kernel.prun(FAULT, st0, 4)[1]   # a base to fold in
    shards, g = kmesh.kinit_sharded(FAULT, st0, CPU3)
    shards = kmesh.kstep_sharded(FAULT, shards, 4, 6, CPU3)
    st_w, m_w = kmesh.kfinish_sharded(FAULT, shards, g, m0)
    st_s, m_s = kmesh.kfinish_sharded(FAULT, shards, g, m0, shards_out=True)
    assert len(st_s) == 3 and len(shards) == 3   # the caller's list kept
    _same(st_w, groups.cat_states(st_s, "cpu"), "State")
    _same(m_w, m_s, "Metrics")


def _hand_ceiling(cfg, n, budget, shared):
    """The shards-out boundary from the per-group words: the first card
    holds the larger of its launches and its shards' finishes beside
    the fleet's lanes (twice) and its n + 1 accumulators."""
    rest = kernel.wire_words_per_group(cfg)
    work = kernel.working_words_per_group(cfg)
    acc = kernel.acc_words(cfg)
    lanes = 5 if cfg.clients_u32 else 3
    finish = (4 * rest + kernel.state_bytes_per_group(cfg))  # wide, unpacked
    fleet = 4 * (acc + kernel.acc_words(dataclasses.replace(
        cfg, wire_hist=True)))

    def need(g):
        step = -(-g // n)
        spans = [min(step, g - s0) for s0 in range(0, g, step)]
        mine = spans if shared else spans[:1]
        launch = sum(4 * (2 * work * s + 2 * acc) for s in mine)
        end = sum(finish * s + fleet for s in mine) + 4 * (
            2 * lanes * g + (len(spans) + 1) * acc)
        return max(launch, end)

    lo, hi = 0, n * budget // (8 * work)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if need(mid) <= budget else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shared", [False, True], ids=["cards", "one-card"])
def test_shards_out_ceiling_is_the_hand_computation(n, shared):
    cfg = RaftConfig(seed=42)
    budget = 78 * 10 ** 9
    cards = [torch.device("cuda", i) for i in range(n)]
    grid = [cards[0]] * n if shared else cards
    top = kernel.mesh_ceiling_groups(cfg, grid, hbm=budget, shards_out=True)
    assert top == _hand_ceiling(cfg, n, budget, shared)
    assert kernel.supported(cfg, top, hbm=budget, mesh=grid, shards_out=True)
    assert not kernel.supported(cfg, top + 1, hbm=budget, mesh=grid,
                                shards_out=True)
    gathered = kernel.mesh_ceiling_groups(cfg, grid, hbm=budget)
    if not shared:
        # each card finishes its own shard: the launches bind again
        assert top == n * kernel.hbm_ceiling_groups(cfg, hbm=budget) \
            > gathered
    if n == 4 and not shared:
        assert (gathered, top) == (8_781_805, 33_078_876)


def test_byte_model_audit_prices_shards_out():
    rep = bytemodel.derived_wire_model(RaftConfig(seed=42))
    assert rep["problems"] == []
    row = rep["hbm"]["mesh"][4]
    assert row["shards_out_ceiling_groups"] > row["ceiling_groups"]
    assert row["shards_out_shared_card_groups"] <= row[
        "shards_out_ceiling_groups"]


def test_shards_out_first_device_holds_what_it_makes(monkeypatch):
    """The bytes `mesh_hbm_bytes(shards_out=True)` charges a device for
    the run's end bound what `finish_shards` makes there: each shard's
    wire pair and decode (`kernel.kfinish`, `kflight`) and the fleet's
    Metrics."""
    cfg = FAULT
    made = []
    real = kernel.kfinish

    def fin(*args, **kw):
        out = real(*args, **kw)
        sizes = []
        for tree in out:
            state._map_named(tree, "", lambda _, a: sizes.append(
                a.numel() * a.element_size()))
        made.append(sum(sizes))
        return out
    monkeypatch.setattr(kernel, "kfinish", fin)
    st0 = state.init(cfg, 64, device="cpu")
    kmesh.prun_sharded(cfg, mesh.shard_state(st0, CPU3), 2, CPU3)
    need = kernel.mesh_hbm_bytes(cfg, 64, CPU3, shards_out=True)
    assert len(made) == 3 and sum(made) <= need[torch.device("cpu")]
    assert need[torch.device("cpu")] == max(
        sum(kernel.hbm_bytes(cfg, s1 - s0) for s0, s1 in groups.spans(64, 3)),
        sum(kernel.finish_bytes(cfg, s1 - s0)
            for s0, s1 in groups.spans(64, 3))
        + kernel.fleet_metrics_bytes(cfg, 64, 3))
