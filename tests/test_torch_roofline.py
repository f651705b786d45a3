"""The port's roofline (`raft_tpu_torch.obs.roofline`): the engine classes
by prefix, the headline's byte bound per 200-tick launch at 100,000
groups (0.2816 ms at 3.35 TB/s), the plain class at twice the resident
bytes per tick, the peaks' overrides, `run_ops` against its closed form
on a no-fault run and the same on the plain tick's end state and on the
kernel's plain version's, and the stamp's null attainment without a
measurement. All on the CPU, no JAX."""

from __future__ import annotations

import dataclasses

import pytest

from raft_tpu_torch.analysis import bytemodel
from raft_tpu_torch.config import RaftConfig
from raft_tpu_torch.obs import manifest, roofline
from raft_tpu_torch.sim import kernel, run, state

CFG = RaftConfig(n_groups=8, k=3, seed=21, drop_prob=0.05, crash_prob=0.2,
                 crash_epoch=16, log_cap=8, compact_every=4)
HEAD = RaftConfig(seed=42)


def test_engine_class_is_a_prefix_rule():
    assert roofline.engine_class("cuda") == "kernel"
    assert roofline.engine_class("cuda-fused-chunk") == "kernel"
    assert roofline.engine_class("cuda-streamed") == "kernel"
    assert roofline.engine_class("plain") == "plain"
    assert roofline.engine_class("plain (cuda mismatch!)") == "plain"
    assert roofline.engine_class("torch-tick") == "plain"
    assert roofline.engine_class(None) == "plain"


def test_headline_byte_bound_per_launch():
    r = roofline.roofline(HEAD, 100_000, "cuda", chunk_ticks=200)
    assert r["wire_bytes_per_group"] == 4_716
    assert r["bytes_per_tick"] == 2 * 4_716 * 100_000 / 200
    assert round(r["hbm_s_per_tick"] * 200 * 1e3, 4) == 0.2816
    assert r["bound"] == "bytes" and r["ops_s_per_tick"] is None
    assert r["xla_bytes_accessed_per_tick"] is None
    assert r["rounds_per_tick"] == 100_000 * HEAD.cmds_per_tick
    # The packed codec's bound at the same groups (PERF.md row 1i).
    packed = dataclasses.replace(HEAD, pack_bools=True, pack_ring=True)
    codec = roofline.codec_roofline(packed, 100_000)
    assert round(codec["wire_unpack"]["bound_ms"], 4) == 0.2466
    assert codec["wire_unpack"]["bytes"] == (3_544 + 4_716) * 100_000
    assert codec["wire_pack"]["bytes"] == (3_544 + 4_716 + 4) * 100_000


def test_operations_bind_when_they_are_larger():
    r = roofline.roofline(HEAD, 100_000, "cuda", chunk_ticks=200,
                          ops=1e12)
    assert r["bound"] == "operations"
    assert r["predicted_ticks_per_sec"] == pytest.approx(
        roofline.DEFAULT_INT32_GOPS * 1e9 / 1e12)


@pytest.mark.parametrize("cfg", [HEAD, bytemodel.clients_cfg(),
                                 bytemodel.all_dials_cfg(HEAD)],
                         ids=["headline", "clients", "narrow"])
def test_plain_class_is_twice_the_resident_bytes(cfg):
    for ring in (0, 64):
        r = roofline.roofline(cfg, 10_000, "plain", ring=ring)
        resident = bytemodel.resident_bytes_model(cfg, ring)[
            "resident_bytes_narrow"]
        assert r["resident_bytes_per_group"] == resident \
            == kernel.state_bytes_per_group(cfg, ring)
        assert r["bytes_per_tick"] == 2 * resident * 10_000
        assert r["chunk_ticks"] is None


def test_peak_env_overrides(monkeypatch):
    base = roofline.roofline(HEAD, 10_000, "plain")
    monkeypatch.setenv(roofline.HBM_ENV,
                       str(2 * roofline.DEFAULT_HBM_GBPS))
    fast = roofline.roofline(HEAD, 10_000, "plain")
    assert fast["predicted_ticks_per_sec"] == pytest.approx(
        2 * base["predicted_ticks_per_sec"])
    monkeypatch.setenv(roofline.INT32_ENV, "1000")
    assert roofline.roofline(HEAD, 10_000, "plain", ops=1e9)[
        "predicted_ticks_per_sec"] == pytest.approx(1000.0)
    scfg = dataclasses.replace(HEAD, stream_groups=True, cohort_blocks=98)
    slow_link = roofline.overlap_efficiency(scfg)
    monkeypatch.setenv(roofline.HOST_ENV, "1e9")
    assert roofline.overlap_efficiency(scfg)[
        "overlap_efficiency_predicted"] == pytest.approx(1.0)
    assert slow_link["copy_s_per_window"] > 0


def test_run_ops_closed_form_without_faults():
    """No faults, no clients, no nemesis: the deadline draws, the digest
    folds of the applied entries and one payload hash per committed
    entry are all the hash work."""
    cfg = dataclasses.replace(CFG, drop_prob=0.0, crash_prob=0.0)
    st0 = state.init(cfg, device="cpu")
    st1, m = run.run(cfg, st0, 40)
    draws = int((st1.nodes.rng_draws - st0.nodes.rng_draws).sum())
    applied = int((st1.nodes.applied - st0.nodes.applied).sum())
    committed = run.total_rounds(m)
    assert draws > 0 and applied > 0 and committed > 0
    fold, mix = roofline.FOLD_OPS, roofline.MIX_OPS
    assert roofline.run_ops(cfg, 8, 40, st0, st1, committed) \
        == draws * 5 * fold + applied * (2 * mix + 4) + committed * 5 * fold


def test_run_ops_same_for_plain_tick_and_kernel_plain_version():
    st0 = state.init(CFG, device="cpu")
    st_a, m_a = run.run(CFG, st0, 40)
    leaves, g = kernel.kinit(CFG, st0)
    st_b, m_b = kernel.kfinish(CFG, kernel.kstep_plain(CFG, leaves, 0, 40),
                               g)
    a = roofline.run_ops(CFG, g, 40, st0, st_a, run.total_rounds(m_a))
    b = roofline.run_ops(CFG, g, 40, st0, st_b, run.total_rounds(m_b))
    assert a == b > 0
    # The faults add the crash draws (once per group, node and epoch)
    # and a drop draw on each link the delivery filter reads.
    nofault = dataclasses.replace(CFG, drop_prob=0.0, crash_prob=0.0)
    live = roofline.live_links(CFG, st0.group_id, 40)
    assert 0 < live <= 40 * 8 * CFG.k * (CFG.k - 1)
    fold = roofline.FOLD_OPS
    assert a - roofline.run_ops(nofault, g, 40, st0, st_a,
                                run.total_rounds(m_a)) \
        == CFG.k * 5 * fold * g * 3 + 6 * fold * live


def test_segment_fields_without_a_measurement():
    f = roofline.segment_fields(HEAD, 1_000, "cuda", ticks=200,
                                timed_wall_s=1.0, measured=False)
    assert set(roofline.ROOFLINE_FIELDS) <= set(f)
    assert f["attainment_pct"] is None
    assert f["roofline"]["measured_ticks_per_sec"] is None
    assert f["bound"] == "bytes" and f["predicted_rounds_per_sec"] > 0
    m = roofline.segment_fields(HEAD, 1_000, "cuda", ticks=200,
                                timed_wall_s=1.0, chunk_ticks=200)
    assert m["attainment_pct"] == pytest.approx(
        100.0 * 200 / m["roofline"]["predicted_ticks_per_sec"], rel=1e-6)


def test_stream_and_narrow_stamps():
    scfg = dataclasses.replace(HEAD, pack_bools=True, pack_ring=True,
                               stream_groups=True, cohort_blocks=98)
    f = roofline.stream_segment_fields(scfg, measured=0.9)
    assert set(f) == set(manifest.STREAM_KEYS + manifest.STREAM_MESH_KEYS)
    assert 0 < f["overlap_efficiency_predicted"] <= 1
    assert f["stream_devices"] == 1 and f["stream_blocks_per_device"] == 98
    assert roofline.stream_segment_fields(HEAD)[
        "overlap_efficiency_predicted"] is None
    # over a mesh: the JAX package's per-device model, N equal entries
    two = roofline.overlap_efficiency(scfg, n_devices=2)
    assert two["blocks_per_device"] == 49 and two["n_devices"] == 2
    assert two["overlap_efficiency_per_device_predicted"] == [round(
        two["overlap_efficiency_predicted"], 6)] * 2
    four = roofline.stream_segment_fields(scfg, n_devices=4,
                                          per_device_measured=[0.5] * 4,
                                          slowest_device=3)
    assert four["stream_devices"] == 4 and four[
        "stream_blocks_per_device"] == 25
    assert four["stream_slowest_device"] == 3
    n = roofline.narrow_segment_fields(bytemodel.all_dials_cfg(HEAD))
    assert set(n) == set(manifest.NARROW_KEYS)
    assert n["narrow_resident_bytes_per_group"] == 2_626
