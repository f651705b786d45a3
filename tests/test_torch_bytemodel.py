"""The port's derived byte model (`raft_tpu_torch.analysis.bytemodel`):
the wire counted three ways agrees on every audited layout, flight ring
on and off; the headline pins hold (4,716 B working, 3,544 B packed at
rest, 6,252 B with a 64-tick ring); and the resident model equals the
JAX package's `resident_bytes_model` leaf by leaf, except the three u32
digest leaves, which the port holds as int64 and which differ by exactly
the field that names that widening.

The reference side traces `sim.init` abstractly (`jax.eval_shape`): it
compiles no XLA program."""

from __future__ import annotations

import dataclasses

import pytest

from raft_tpu.analysis import bytemodel as jbytemodel
from raft_tpu_torch.analysis import bytemodel
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs.recorder import RING
from raft_tpu_torch.sim import kernel

from jax_programs import release_jax_programs  # noqa: F401

AUDIT = dict(bytemodel.audit_cfgs())


@pytest.mark.parametrize("ring", [RING, 0], ids=["flight", "no-flight"])
@pytest.mark.parametrize("label", list(AUDIT))
def test_wire_three_ways_agree(label, ring):
    m = bytemodel.derived_wire_model(AUDIT[label], ring)
    assert m["problems"] == []
    assert m["wire_words_derived"] == m["kinit_words_per_group"] \
        == kernel.wire_words_per_group(AUDIT[label], ring)
    assert m["working_words_derived"] == m["kinit_working_words_per_group"] \
        == kernel.working_words_per_group(AUDIT[label], ring)


def test_wire_pins():
    head = bytemodel.headline_cfg()
    packed = dataclasses.replace(head, pack_bools=True, pack_ring=True)
    assert bytemodel.derived_wire_model(head)["working_bytes_derived"] \
        == 4_716
    assert bytemodel.derived_wire_model(packed)["wire_bytes_derived"] \
        == 3_544
    assert bytemodel.derived_wire_model(head, 64)["wire_bytes_derived"] \
        == kernel.wire_words_per_group(head, ring=64) * 4 == 6_252
    assert bytemodel.wire_pin_problems() == []


def test_audit_is_clean():
    assert bytemodel.byte_model_problems() == []


def _clear_layout_caches():
    for fn in (kernel._layout, kernel._rest_at, kernel._codec_plan):
        fn.cache_clear()


def test_a_drifted_packing_rule_is_named(monkeypatch):
    """The packed arithmetic is the model's own: a kernel whose packed
    bool mailbox drifts by a word per destination agrees with its own
    kinit, and the model names the drift."""
    cfg = dataclasses.replace(AUDIT["headline-packed"], seed=987_654)
    real = kernel._mb_words
    monkeypatch.setattr(kernel, "_mb_words", lambda c: real(c) + 1)
    _clear_layout_caches()
    try:
        m = bytemodel.derived_wire_model(cfg)
    finally:
        monkeypatch.undo()
        _clear_layout_caches()
    assert m["kinit_words_per_group"] == m["wire_words_pinned"] \
        == m["wire_words_derived"] + cfg.k
    assert any("at rest: derived" in p for p in m["problems"])


def _ref_pairs():
    for label in ("headline", "clients"):
        base = getattr(bytemodel, f"{label}_cfg")()
        for dials in (False, True):
            cfg = bytemodel.all_dials_cfg(base) if dials else base
            jcfg = getattr(jbytemodel, f"{label}_cfg")()
            if dials:
                jcfg = jbytemodel.all_dials_cfg(jcfg)
            yield f"{label}-{'narrow' if dials else 'wide'}", cfg, jcfg


@pytest.mark.parametrize("label,cfg,jcfg", list(_ref_pairs()),
                         ids=[p[0] for p in _ref_pairs()])
def test_resident_model_leaf_by_leaf(label, cfg, jcfg):
    port = bytemodel.resident_bytes_model(cfg)
    ref = jbytemodel.resident_bytes_model(jcfg)
    assert port["problems"] == [] and ref["problems"] == []
    assert [r["name"] for r in port["leaves"]] \
        == [r["name"] for r in ref["leaves"]]
    widening = 0
    for p, r in zip(port["leaves"], ref["leaves"]):
        assert p["shape_per_group"] == r["shape_per_group"], p["name"]
        assert p["narrowed"] == r["narrowed"], p["name"]
        if p["name"] in bytemodel.U32_LEAVES:
            assert (p["dtype_wide"], r["dtype_wide"]) == ("int64", "uint32")
            assert p["dtype_narrow"] == "int64"
            d = p["bytes_wide"] - r["bytes_wide"]
            assert d == p["bytes_narrow"] - r["bytes_narrow"] \
                == p["u32_widening_bytes"] == r["bytes_wide"]
            widening += d
        else:
            for k in ("dtype_wide", "dtype_narrow", "bytes_wide",
                      "bytes_narrow"):
                assert p[k] == r[k], (p["name"], k)
            assert p["u32_widening_bytes"] == 0
    assert widening == port["u32_widening_bytes"] == 140

    def state(m):
        return (m["resident_bytes_wide"] - m["metric_lane_bytes"]
                - m["flight_bytes"])

    assert port["state_bytes_wide"] == state(port) \
        == state(ref) + port["u32_widening_bytes"]
    narrow = {"port": port["resident_bytes_narrow"] - port[
        "metric_lane_bytes"], "ref": ref["resident_bytes_narrow"] - ref[
        "metric_lane_bytes"]}
    assert narrow["port"] == narrow["ref"] + port["u32_widening_bytes"]


def test_resident_model_against_the_kernel_and_lanes():
    """The fourth accounting is `kernel.state_bytes_per_group`; the lane
    convention is the port's (3 lanes, 5 with clients), the flight rows
    priced at four bytes."""
    for cfg, lanes in ((bytemodel.headline_cfg(), 3),
                       (bytemodel.clients_cfg(), 5)):
        for ring in (0, RING):
            m = bytemodel.resident_bytes_model(cfg, ring)
            assert m["problems"] == []
            assert m["metric_lane_bytes"] == 4 * lanes
            assert m["flight_bytes"] == 4 * 6 * ring
            assert m["resident_bytes_narrow"] \
                == kernel.state_bytes_per_group(cfg, ring)
    assert bytemodel.narrow_resident_bytes_per_group(
        bytemodel.all_dials_cfg(bytemodel.headline_cfg())) == 2_626
    assert bytemodel.narrow_model_problems() == []


def test_narrow_spec_drift_is_named(monkeypatch):
    from raft_tpu_torch.sim import state
    real = state.narrow_spec

    def spec(cfg):
        out = dict(real(cfg))
        out["nodes.no_such_leaf"] = out.get("nodes.term")
        return out

    monkeypatch.setattr(state, "narrow_spec", spec)
    cfg = bytemodel.all_dials_cfg(RaftConfig(seed=42))
    probs = bytemodel.resident_bytes_model(cfg)["problems"]
    assert any("no_such_leaf" in p for p in probs)
