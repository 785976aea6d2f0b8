"""The port's link-budget layer against the JAX package's, on the same
seeded inputs: the numpy layer (`station_windows`, `resolve_contention`,
`transfer_windows`, `link_budget`) bit for bit; the gated transitions
(`upload_step`, `download_step`, `step`, single and batched (R, K), int32
and int16-narrowed); the gated eq.-13 search (`simulate_candidates`,
`score_candidates`, `fedspace_search`); FedSpace's grant inversion; and
federations under a budget through `Federation.from_experiment`, whose
integer counters, staleness histograms and `progress` columns must equal
the reference's, accuracies within 1/NUM_VAL and val losses within 1e-4
(tests/test_torch_engine.py's tolerances). FedBuff under a budget runs in
tests/test_torch_isl.py's world, beside the ISL policies."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.scheduler as RSched
import repro.fl.api as RA
import repro_torch.core.search as TSR
import repro_torch.fl.api as TA
from repro.core import connectivity as RCN
from repro.core import search as RSR
from repro.core import staleness as RS
from repro.core.scheduler import FedSpaceScheduler as RFedSpace
from repro.fl.engine import EngineConfig as REC
from repro_torch.core import connectivity as TCN
from repro_torch.core import staleness as TS
from repro_torch.core.scheduler import FedSpaceScheduler as TFedSpace
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.weights import (forest_from_arrays, params_from_numpy,
                                 params_to_numpy)
from test_hotpath_parity import _fit_hist_forest

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

NUM_VAL = 200


# ---------------------------------------------------------------------------
# the numpy layer, bit for bit


def _spec(pkg, preset, ground):
    return pkg.constellation_preset(preset, ground=ground)


@pytest.mark.parametrize("preset,ground,days", [
    ("flock191", "sparse1", 0.25), ("starlink40", "mid4", 0.5),
    ("starlink40", "dense12", 0.25)])
def test_station_windows_bit_equal(preset, ground, days):
    ref = RCN.station_windows(_spec(RCN, preset, ground), days=days)
    got = TCN.station_windows(_spec(TCN, preset, ground), days=days)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        (got > 0).any(-1),
        TCN.connectivity_sets(_spec(TCN, preset, ground), days=days))


@pytest.mark.parametrize("capacity", [0, 1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_resolve_contention_bit_equal(seed, capacity):
    """Random contact counts with many ties (0-3 substeps), so the
    lexsort's tie-breaks are exercised."""
    r = np.random.default_rng(seed)
    counts = r.integers(0, 4, (20, int(r.integers(3, 30)),
                               int(r.integers(1, 5)))).astype(np.int32)
    got = TCN.resolve_contention(counts, capacity)
    np.testing.assert_array_equal(got, RCN.resolve_contention(counts,
                                                              capacity))
    assert got.dtype == np.int32
    if capacity > 0:
        for row in got:
            _, n = np.unique(row[row >= 0], return_counts=True)
            assert (n <= capacity).all()


def test_transfer_windows_equal():
    for rate in (0.0, 1.0, 20.0, 100.0, 333.3):
        for size in (0.0, 1.0, 300.0, 600.0, 1234.5):
            for sub in (60.0, 900.0):
                assert TCN.transfer_windows(rate, size, sub) == \
                    RCN.transfer_windows(rate, size, sub)
    assert TCN.transfer_windows(20.0, 600.0) == 4


@pytest.mark.parametrize("preset,ground,kw", [
    ("flock191", "sparse1", dict(gs_capacity=2)),
    ("starlink40", "sparse1", dict(uplink_mbps=20.0, downlink_mbps=100.0,
                                   model_mb=600.0, gs_capacity=1)),
    ("starlink40", "mid4", dict(uplink_mbps=20.0, model_mb=300.0,
                                uplink_mb=150.0)),
    ("starlink40", "dense12", {})])
def test_link_budget_bit_equal(preset, ground, kw):
    ref = RCN.link_budget(_spec(RCN, preset, ground), days=0.5, **kw)
    got = TCN.link_budget(_spec(TCN, preset, ground), days=0.5, **kw)
    for f in ("visible", "served", "assign", "grants"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (got.need_up, got.need_dn) == (ref.need_up, ref.need_dn)
    assert got.num_windows == ref.num_windows
    assert got.blocked_fraction() == ref.blocked_fraction()
    if not kw:      # unlimited and instantaneous: the geometry itself
        np.testing.assert_array_equal(
            got.served, TCN.connectivity_sets(_spec(TCN, preset, ground),
                                              days=0.5))
        assert got.blocked_fraction() == 0.0


# ---------------------------------------------------------------------------
# gated transitions


def _random_state(r, shape, ig, dtype=np.int32, progress=True):
    cols = [r.integers(-1, ig + 1, shape).astype(dtype) for _ in range(3)]
    if progress:
        cols.append(r.integers(0, 5, shape).astype(np.int32))
    return cols


def _gate_pair(grant, need_up, need_dn):
    return (RS.LinkGate(jnp.asarray(grant), jnp.int32(need_up),
                        jnp.int32(need_dn)),
            TS.LinkGate(torch.as_tensor(grant), need_up, need_dn))


def _same(ref, got, what=""):
    a, b = np.asarray(ref), got.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=what)


def _same_state(ref, got):
    for f in ("version", "pending", "buffered", "progress", "relay"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same(a, b, f)


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("seed", range(8))
def test_gated_transitions_match_reference(seed, dtype):
    """One instance (K,): upload, aggregate, download and the composed
    step under a random gate; the version columns keep their dtype and
    `progress` stays int32."""
    r = np.random.default_rng(seed)
    K, ig = 13, int(r.integers(0, 6))     # one shape: one compile
    cols = _random_state(r, K, ig, dtype)
    conn = r.random(K) < 0.6
    grant = r.integers(0, 4, K).astype(np.int32)
    need_up, need_dn = int(r.integers(0, 5)), int(r.integers(0, 4))
    rg, tg = _gate_pair(grant, need_up, need_dn)
    rst = RS.SatState(*(jnp.asarray(c) for c in cols))
    tst = TS.SatState(*(torch.as_tensor(c) for c in cols))
    rig, tig = jnp.asarray(ig, dtype), torch.tensor(ig, dtype=tst.version.dtype)
    rc, tc = jnp.asarray(conn), torch.as_tensor(conn)
    ru, rinfo = RS.upload_step(rst, rig, rc, rg)
    tu, tinfo = TS.upload_step(tst, tig, tc, tg)
    _same_state(ru, tu)
    for k in rinfo:
        _same(rinfo[k], tinfo[k], k)
    agg = bool(r.random() < 0.5)
    ra, rig2, _ = RS.aggregate_step(ru, rig, jnp.bool_(agg), s_max=8)
    ta, tig2, _ = TS.aggregate_step(tu, tig, agg, s_max=8)
    _same_state(ra, ta)
    rd, rdn = RS.download_step(ra, rig2, rc, rg)
    td, tdn = TS.download_step(ta, tig2, tc, tg)
    _same_state(rd, td)
    _same(rdn["downloads"], tdn["downloads"])
    rs, rig3, rinfo = RS.step(rst, rig, rc, jnp.bool_(agg), s_max=8,
                              link=rg)
    ts, tig3, tinfo = TS.step(tst, tig, tc, agg, s_max=8, link=tg)
    _same_state(rs, ts)
    _same_state(rd, ts)
    assert int(rig3) == int(tig3)
    for k in rinfo:
        _same(rinfo[k], tinfo[k], k)
    assert ts.version.dtype == tst.version.dtype
    assert ts.progress.dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
def test_batched_gated_transitions_match_vmapped_reference(seed):
    """A (R, K) stack of states, each with its own global version (`ig`
    carries the batch dim) under one shared (K,) grant row: the reference
    under `vmap`."""
    r = np.random.default_rng(100 + seed)
    R, K, ig = 5, 11, 4
    cols = _random_state(r, (R, K), ig)
    igs = r.integers(0, ig + 1, R).astype(np.int32)
    conn = r.random(K) < 0.6
    grant = r.integers(0, 3, K).astype(np.int32)
    rg, tg = _gate_pair(grant, 2, 1)
    aggs = r.random(R) < 0.5
    rst = RS.SatState(*(jnp.asarray(c) for c in cols))
    tst = TS.SatState(*(torch.as_tensor(c) for c in cols))

    def one(st, g, a):
        st, up = RS.upload_step(st, g, jnp.asarray(conn), rg)
        st, g2, _ = RS.aggregate_step(st, g, a, s_max=8, collect="none")
        st, dn = RS.download_step(st, g2, jnp.asarray(conn), rg)
        return st, g2, up, dn["downloads"]
    rfin, rig, rup, rdn = jax.vmap(one)(rst, jnp.asarray(igs),
                                        jnp.asarray(aggs))
    tig = torch.as_tensor(igs)
    tu, tup = TS.upload_step(tst, tig, torch.as_tensor(conn), tg)
    ta, tig2, _ = TS.aggregate_step(tu, tig, torch.as_tensor(aggs),
                                    s_max=8, collect="none")
    tfin, tdn = TS.download_step(ta, tig2, torch.as_tensor(conn), tg)
    _same_state(rfin, tfin)
    _same(rig, tig2)
    for k in rup:
        _same(rup[k], tup[k], k)
    _same(rdn, tdn["downloads"])


def test_multi_window_transfers_as_the_reference_pins_them():
    """tests/test_link_budget.py's hand-checked trace: need_up 2 and
    need_dn 2 at one unit a window."""
    a = [0, 0, 1, 0, 0, 0, 0]
    st, ig, hist = TS.bootstrap_state(1, progress=True, device="cpu"), 0, []
    for ai in a:
        st, ig, _ = TS.step(st, ig, torch.ones(1, dtype=torch.bool),
                            bool(ai), s_max=8,
                            link=TS.LinkGate(torch.ones(1, dtype=torch.int32),
                                             2, 2))
        hist.append((int(st.pending[0]), int(st.buffered[0]),
                     int(st.version[0]), int(ig), int(st.progress[0])))
    assert hist == [(0, -1, 0, 0, 1), (-1, 0, 0, 0, 0), (-1, -1, 0, 1, 1),
                    (1, -1, 1, 1, 0), (1, -1, 1, 1, 1), (-1, 1, 1, 1, 0),
                    (-1, 1, 1, 1, 0)]


def test_initial_states_with_columns_equal():
    for flags in ({}, {"progress": True}, {"relay": True},
                  {"progress": True, "relay": True}):
        _same_state(RS.bootstrap_state(5, **flags),
                    TS.bootstrap_state(5, device="cpu", **flags))
        _same_state(RS.init_state(5, **flags),
                    TS.init_state(5, device="cpu", **flags))


# ---------------------------------------------------------------------------
# the gated search


def _window(seed, dtype=np.int32):
    r = np.random.default_rng(500 + seed)
    K, I0, R = 11, 8, 24
    ig = int(r.integers(0, 6))
    cols = _random_state(r, K, ig, dtype)
    C = r.random((I0, K)) < r.uniform(0.2, 0.9)
    grant = (r.integers(0, 4, (I0, K)) * C).astype(np.int32)
    cands = (r.random((R, I0)) < 0.4).astype(np.int32)
    return C, grant, cands, ig, cols


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("collect", ["marks", "hist"])
@pytest.mark.parametrize("seed", range(3))
def test_gated_simulate_candidates_matches_reference(seed, collect, dtype):
    C, grant, cands, ig, cols = _window(seed, dtype)
    rg, tg = _gate_pair(grant, 3, 1)
    rfin, rig, rinfo = RS.simulate_candidates(
        jnp.asarray(C), jnp.asarray(cands),
        RS.SatState(*(jnp.asarray(c) for c in cols)),
        jnp.asarray(ig, dtype), s_max=8, collect=collect, link=rg)
    tfin, tig, tinfo = TS.simulate_candidates(
        C, cands, TS.SatState(*(torch.as_tensor(c) for c in cols)),
        torch.tensor(ig, dtype=torch.from_numpy(cols[0]).dtype), s_max=8,
        collect=collect, link=tg)
    _same_state(rfin, tfin)
    _same(rig, tig)
    assert set(rinfo) == set(tinfo)
    for k in rinfo:
        _same(rinfo[k], tinfo[k], k)


def _forests():
    rf = _fit_hist_forest(5)
    fa = rf.arrays()
    return rf, forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                  fa.value, fa.depth,
                                  n_features=rf.n_features_)


class _HostOnly:
    """A `.predict`-only regressor: the search's host-histogram path."""

    def __init__(self, rf):
        self.predict = rf.predict


@pytest.mark.parametrize("seed", range(3))
def test_gated_scores_and_schedules_match_reference(seed):
    """Scores of both scoring paths and the chosen schedule, with the
    relay column attached (it passes through the search untouched) and
    the version columns narrowed to int16 inside the search."""
    C, grant, _, ig, cols = _window(seed)
    rf, tf = _forests()
    rst = RS.SatState(*(jnp.asarray(c) for c in cols),
                      relay=jnp.asarray(cols[0] * 0 + 2))
    tst = TS.SatState(*(torch.as_tensor(c) for c in cols),
                      relay=torch.full_like(torch.as_tensor(cols[0]), 2))
    cands = RSR.random_candidates(np.random.default_rng(seed), C.shape[0],
                                  1, 4, 64)
    for rreg, treg in ((rf, tf), (_HostOnly(rf), _HostOnly(rf))):
        ref = RSR.score_candidates(cands, C, rst, ig, rreg, 1.0,
                                   link=RS.LinkGate(grant, 2, 1))
        got = TSR.score_candidates(cands, C, tst, ig, treg, 1.0,
                                   link=TS.LinkGate(grant, 2, 1))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    sr = RSR.fedspace_search(np.random.default_rng(7), C, rst, ig, rf, 1.0,
                             n_min=1, n_max=4, num_candidates=64,
                             link=RS.LinkGate(grant, 2, 1))
    st = TSR.fedspace_search(np.random.default_rng(7), C, tst, ig, tf, 1.0,
                             n_min=1, n_max=4, num_candidates=64,
                             link=TS.LinkGate(grant, 2, 1))
    np.testing.assert_array_equal(st, sr)


def test_narrowed_search_state_keeps_the_columns_int32():
    st = TS.bootstrap_state(6, progress=True, relay=True, device="cpu")
    narrow, ig = TSR._narrow_state(st, 3, 24)
    assert narrow.version.dtype == narrow.pending.dtype == \
        narrow.buffered.dtype == ig.dtype == torch.int16
    assert narrow.progress.dtype == narrow.relay.dtype == torch.int32
    gate = TS.LinkGate(torch.full((4, 6), 2, dtype=torch.int32), 3, 1)
    fin, fig, _ = TS.simulate_candidates(np.ones((4, 6), bool),
                                         np.ones((5, 4), np.int32), narrow,
                                         ig, collect="none", link=gate)
    assert fin.version.dtype == fin.buffered.dtype == fig.dtype == \
        torch.int16
    assert fin.progress.dtype == torch.int32 and fin.progress.shape == (5, 6)


def test_trivial_gate_picks_the_geometry_schedule():
    """The zero-need gate over served = visible changes nothing: the port
    picks the geometry-only search's schedule, as the reference does."""
    r = np.random.default_rng(0)
    K, I0 = 16, 12
    C = r.random((I0, K)) < 0.2
    _, tf = _forests()
    base = TSR.fedspace_search(np.random.default_rng(7), C,
                               TS.bootstrap_state(K, device="cpu"), 0, tf,
                               1.0, num_candidates=256)
    gated = TSR.fedspace_search(
        np.random.default_rng(7), C,
        TS.bootstrap_state(K, progress=True, device="cpu"), 0, tf, 1.0,
        num_candidates=256,
        link=TS.LinkGate(np.ones((I0, K), np.int32) * C, 0, 0))
    np.testing.assert_array_equal(base, gated)


def test_fedspace_search_state_undoes_boundary_upload():
    """The grant inversion (tests/test_link_budget.py's case): re-applying
    the gated upload on the state the search rolls from lands on the
    engine's post-upload state, for in-flight and completed uploads; the
    port's inverted state equals the reference's."""
    conn = np.array([True, True, True, False])
    grants = np.array([[2, 2, 2, 2]], np.int32)
    cols = [np.zeros(4, np.int32), np.zeros(4, np.int32),
            np.full(4, -1, np.int32), np.array([0, 1, 0, 1], np.int32)]
    pre = TS.SatState(*(torch.as_tensor(c) for c in cols))
    gate = TS.LinkGate(torch.as_tensor(grants[0]), 3, 1)
    post, _ = TS.upload_step(pre, 0, torch.as_tensor(conn), gate)
    assert post.progress.tolist() == [2, 0, 2, 1]
    assert post.pending.tolist() == [0, -1, 0, 0]
    undone = TFedSpace._search_state(post, 0, connectivity=conn[None, :],
                                     link=TS.LinkGate(grants, 3, 1))
    redo, _ = TS.upload_step(undone, 0, torch.as_tensor(conn), gate)
    for a, b in zip(redo[:4], post[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    again, _ = TS.upload_step(post, 0, torch.as_tensor(conn), gate)
    assert again.progress.tolist() != post.progress.tolist()
    rpost, _ = RS.upload_step(RS.SatState(*(jnp.asarray(c) for c in cols)),
                              jnp.int32(0), jnp.asarray(conn),
                              RS.LinkGate(jnp.asarray(grants[0]),
                                          jnp.int32(3), jnp.int32(1)))
    rundone = RFedSpace._search_state(rpost, 0, connectivity=conn[None, :],
                                      link=RS.LinkGate(grants, 3, 1))
    _same_state(rundone, undone)


def test_window_link_slices_and_pads_as_the_reference():
    _, tf = _forests()
    grants = np.arange(30, dtype=np.int32).reshape(10, 3)
    for i in (0, 4, 8):
        got = TFedSpace(tf, I0=4)._window_link(TS.LinkGate(grants, 3, 1), i)
        ref = RFedSpace(tf, I0=4)._window_link(RS.LinkGate(grants, 3, 1), i)
        np.testing.assert_array_equal(got.grant, ref.grant)
        assert (got.need_up, got.need_dn) == (3, 1)
    assert TFedSpace(tf, I0=4)._window_link(None, 0) is None


# ---------------------------------------------------------------------------
# federations under a budget


LINK = dict(uplink_mbps=20.0, downlink_mbps=100.0, model_mb=600.0,
            gs_capacity=1)


def _exp(api, ec, scheduler, **kw):
    """12 satellites in 3 polar planes over the 4-station network, 18
    hours, under a binding budget (need_up 4, one satellite a station)."""
    shell = (RCN if api is RA else TCN).Shell(12, 3, 560_000.0, 97.6)
    return api.FLExperiment(
        name="tiny-budget",
        constellation=api.ConstellationConfig(
            num_satellites=12, days=0.75, ground="mid4",
            spec_overrides={"shells": (shell,), "min_elevation_deg": 25.0}),
        dataset=api.DatasetConfig(num_train=600, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 16}),
        scheduler=scheduler,
        train=ec(local_steps=2, client_lr=0.5, eval_every=24,
                 stop_at_target=False),
        link=api.LinkConfig(**LINK), **kw)


def _recording(monkeypatch, module, log):
    inner = module.fedspace_search

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        log.append(np.asarray(out).copy())
        return out
    monkeypatch.setattr(module, "fedspace_search", wrapped)


@pytest.fixture(scope="module")
def worlds():
    """The reference's and the port's worlds, and FedSpace run on each
    from the reference's initial model, with one histogram-only forest (no
    split on T) on both sides; every re-plan's schedule recorded."""
    mp = pytest.MonkeyPatch()
    rf, tf = _forests()
    fedspace = {"I0": 12, "n_min": 2, "n_max": 5, "num_candidates": 64}
    rfed = RA.Federation.from_experiment(_exp(
        RA, REC, RA.SchedulerConfig("fedspace",
                                    params={**fedspace, "regressor": rf})))
    tfed = TA.Federation.from_experiment(_exp(
        TA, TEC, TA.SchedulerConfig("fedspace",
                                    params={**fedspace, "regressor": tf})),
        device="cpu")
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    rlog, tlog = [], []
    try:
        _recording(mp, RSched, rlog)
        _recording(mp, TSR, tlog)
        reng = rfed.engine(init_params=p0)
        rres = reng.run()
        teng = tfed.engine(init_params=params_from_numpy(p0, "cpu"),
                           device="cpu")
        tres = teng.run()
    finally:
        mp.undo()
    return rfed, tfed, ((reng, rres, rlog), (teng, tres, tlog))


def test_federation_resolves_the_budget(worlds):
    rfed, tfed, _ = worlds
    rb, tb = rfed.link_budget, tfed.link_budget
    assert tb is not None and (tb.need_up, tb.need_dn) == (4, 1)
    for f in ("visible", "served", "assign", "grants"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(rb, f))
    assert tb.blocked_fraction() == rb.blocked_fraction() > 0.1
    np.testing.assert_array_equal(tfed.C, rfed.C)
    np.testing.assert_array_equal(tfed.C, tb.visible)
    assert tfed.with_scheduler("async").link_budget is tb
    assert tfed.connectivity_summary() == rfed.connectivity_summary()


@pytest.mark.parametrize("counter", [
    "num_global_updates", "num_aggregated_gradients", "idle_connections",
    "total_connections", "windows_run", "eval_windows"])
def test_fedspace_under_budget_counters_exactly_equal(worlds, counter):
    (_, rres, _), (_, tres, _) = worlds[2]
    assert getattr(tres, counter) == getattr(rres, counter)
    assert tres.num_global_updates > 3


def test_fedspace_under_budget_state_and_schedules_exactly_equal(worlds):
    (reng, rres, rlog), (teng, tres, tlog) = worlds[2]
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    assert teng.ig == reng.ig
    for f in ("version", "pending", "buffered_base", "transfer_progress"):
        np.testing.assert_array_equal(getattr(teng, f), getattr(reng, f),
                                      err_msg=f)
    assert teng.relay_units is None and reng.relay_units is None
    assert len(tlog) == len(rlog) == 6
    for j, (a, b) in enumerate(zip(tlog, rlog)):
        np.testing.assert_array_equal(a, b, err_msg=f"re-plan {j}")
    assert len({a.tobytes() for a in tlog}) > 1     # schedules vary


def test_fedspace_under_budget_floats_within_tolerance(worlds):
    (reng, rres, _), (teng, tres, _) = worlds[2]
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)
    final = params_to_numpy(teng.params)
    for k, ref in reng.params.items():
        np.testing.assert_allclose(final[k], np.asarray(ref), atol=1e-4,
                                   err_msg=k)


def test_unlimited_budget_gives_the_geometry_run(worlds):
    """A budget with no capacity limit and zero needs gates nothing: the
    same counters as the run without one (tests/test_link_budget.py's
    `test_link_budget_unlimited_is_geometry`, end to end)."""
    _, tfed, _ = worlds
    spec = tfed.spec
    free = TCN.link_budget(spec, days=0.75)
    from repro_torch.fl.engine import SimulationEngine
    runs = []
    for budget in (None, free):
        eng = SimulationEngine(free.visible, tfed.adapter,
                               tfed.with_scheduler("fedbuff", M=3).scheduler,
                               tfed.experiment.train, device="cpu",
                               link_budget=budget)
        res = eng.run()
        runs.append((res.num_global_updates, res.idle_connections,
                     res.total_connections, res.staleness_hist.tolist(),
                     eng.version.tolist(), eng.pending.tolist(),
                     [float(x) for x in res.accuracy]))
        assert (eng.transfer_progress is None) == (budget is None)
    assert runs[0] == runs[1]


def test_budget_world_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    exp = _exp(TA, TEC, TA.SchedulerConfig("fedbuff", params={"M": 3}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.Federation.from_experiment(exp)
    fed = TA.Federation.from_experiment(exp, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fed.engine()


def test_compression_with_a_budget_still_raises():
    """Compression over a budget raised until the compression slice; the
    budget now carries the compressed upload (need_up 4 -> 2 at top-k 0.25,
    600 MB x 0.3125), the reference's needs and grants."""
    got = []
    for api, ec in ((RA, REC), (TA, TEC)):
        exp = _exp(api, ec, api.SchedulerConfig("fedbuff", params={"M": 3}))
        exp = dataclasses.replace(exp, link=api.LinkConfig(uplink_topk=0.25,
                                                           **LINK))
        kw = {} if api is RA else {"device": "cpu"}
        b = api.Federation.from_experiment(exp, **kw).link_budget
        got.append((b.need_up, b.need_dn, np.asarray(b.grants)))
    (rup, rdn, rgrant), (tup, tdn, tgrant) = got
    assert (tup, tdn) == (rup, rdn) and tup < 4
    np.testing.assert_array_equal(tgrant, rgrant)
