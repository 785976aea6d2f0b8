"""The port's fault layer (`repro_torch.core.faults`, the alive mask of
`repro_torch.core.isl`, the engine's fault wiring and
`Federation.with_faults`) against the JAX package's, on the same seeded
inputs: configs, traces, masks and scenario helpers bit for bit;
`fault_reset` on narrow and batched states; alive-masked sink elections
and gossip; engines over random scripted worlds under churn (stub
adapters: every integer of the run equal to the reference's, and an
all-alive trace equal to `faults=None`); federations through
`Federation.from_experiment` on a tiny world under churn and launches —
alone, under a link budget, under sink relaying and under gossip — whose
integers equal the reference's, accuracies within 1/NUM_VAL and val
losses and final models within 1e-4 (tests/test_torch_engine.py's
tolerances); the blind/oracle plan view; and the world's caches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.api as RA
import repro_torch.fl.api as TA
import repro.core.scheduler as RSched
import repro_torch.core.search as TSR
from repro.core import connectivity as RCN
from repro.core import faults as RFT
from repro.core import isl as RI
from repro.core import staleness as RS
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as RSE
from repro_torch.core import connectivity as TCN
from repro_torch.core import faults as TFT
from repro_torch.core import isl as TI
from repro_torch.core import staleness as TS
from repro_torch.core.scheduler import Scheduler
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine as TSE
from repro_torch.weights import params_from_numpy, params_to_numpy
from tests.test_protocol_lockstep import ScriptedScheduler as RScripted
from tests.test_protocol_lockstep import _StubAdapter as RStub
from tests.test_torch_link_budget import _forests, _recording

NUM_VAL = 200


# ---------------------------------------------------------------------------
# port-side stubs (the reference's are tests/test_protocol_lockstep.py's)


class StubAdapter:
    """A two-parameter model whose loss has zero gradient: client training
    changes nothing, so a run isolates the protocol."""

    def __init__(self, K, device="cpu"):
        self.clients = list(range(K))
        self.device = torch.device(device)

    def init(self, gen):
        return {"w": torch.zeros(2, device=self.device)}

    def loss(self, params, batch):
        return (params["w"] * 0.0).sum(-1) + batch[0].sum(-1) * 0.0

    def client_batch(self, ci, round_rng, batch_size, num_batches):
        return (torch.zeros((num_batches, 1), device=self.device),)

    def accuracy(self, params):
        return 0.0

    def val_loss(self, params):
        return 0.0


def _scripted_indicator(t, n_buf, args):
    return args[..., t] > 0


class Scripted(Scheduler):
    """Replays a fixed schedule a^i; `device=True` also offers it as a
    device plan (the sweep's path)."""
    name = "scripted"

    def __init__(self, a, device=True):
        self.a = np.asarray(a, np.int32)
        self._device = device

    def decide(self, i, *, n_in_buffer, **_):
        return bool(self.a[i]) and n_in_buffer > 0

    def device_plan(self, i, **_):
        if not self._device:
            return None
        return _scripted_indicator, torch.as_tensor(self.a), None


def budgets(C, grants, need_up, need_dn):
    """The same synthetic LinkBudget for both packages over resolved
    connectivity (tests/test_protocol_lockstep.py's `_budget`)."""
    assign = np.where(C, 0, -1).astype(np.int32)
    return tuple(pkg.LinkBudget(visible=C, served=C, assign=assign,
                                grants=grants, need_up=need_up,
                                need_dn=need_dn) for pkg in (RCN, TCN))


def same_run(reng, rres, teng, tres):
    """Every integer of two finished runs equal."""
    for f in ("version", "pending", "buffered_base", "transfer_progress",
              "relay_units"):
        a, b = getattr(reng, f), getattr(teng, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)
    assert teng.ig == reng.ig
    for f in ("num_global_updates", "num_aggregated_gradients",
              "idle_connections", "total_connections", "windows_run",
              "eval_windows"):
        assert getattr(tres, f) == getattr(rres, f), f
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("kw,field", [
    (dict(deorbit=((-1, 3),)), "deorbit"),
    (dict(deorbit=((2, -1),)), "deorbit"),
    (dict(launch=((-2, 0),)), "launch"),
    (dict(outages=((-1, 0, 4),)), "outages"),
    (dict(outages=((0, 5, 2),)), "outages"),
    (dict(rate_scale_min=-0.1), "rate_scale_min"),
    (dict(rate_scale_min=0.9, rate_scale_max=0.5), "rate_scale_min"),
    (dict(rate_block=0), "rate_block"),
])
def test_fault_config_validation_names_the_reference_field(kw, field):
    with pytest.raises(ValueError) as ref:
        RFT.FaultConfig(**kw)
    with pytest.raises(ValueError, match=f"FaultConfig.{field}") as got:
        TFT.FaultConfig(**kw)
    assert str(got.value) == str(ref.value)


def test_trivial_configs_agree():
    for kw in ({}, dict(deorbit=((0, 1),)), dict(rate_scale_min=0.5),
               dict(oracle=True), dict(outages=((0, 0, 0),)),
               dict(seed=3, rate_block=2)):
        assert TFT.FaultConfig(**kw).trivial == RFT.FaultConfig(**kw).trivial
    assert TA.FaultConfig is TFT.FaultConfig


# ---------------------------------------------------------------------------
# traces, masks and scenario helpers: bit for bit


def _events(r, K, W, n):
    return tuple((int(k), int(w)) for k, w in
                 zip(r.integers(0, K, n), r.integers(0, W + 2, n)))


def _config_kw(r, K, W, G):
    """A random config: deorbits, launches (recoveries and late
    additions), station outages and, every other seed, weather."""
    kw = dict(deorbit=_events(r, K, W, int(r.integers(0, 5))),
              launch=_events(r, K, W, int(r.integers(0, 4))),
              oracle=bool(r.integers(0, 2)))
    if G:
        kw["outages"] = tuple(
            (int(g), int(s), int(s + r.integers(0, W)))
            for g, s in zip(r.integers(0, G, 2), r.integers(0, W, 2)))
    if r.integers(0, 2):
        lo = float(r.uniform(0.0, 0.8))
        kw.update(rate_scale_min=lo, rate_scale_max=lo + 0.2,
                  rate_block=int(r.integers(1, 9)), seed=int(r.integers(9)))
    return kw


def _same_trace(ref, got):
    for f in ("alive", "station_up", "rate_scale", "reach", "mask",
              "revive"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.oracle == ref.oracle and got.num_windows == ref.num_windows


@pytest.mark.parametrize("seed", range(8))
def test_fault_trace_equals_reference(seed):
    """Traces with and without station information, `reach` from random
    per-station counts, the seeded weather draw, and `extended`."""
    r = np.random.default_rng(seed)
    K, W, G = int(r.integers(2, 12)), int(r.integers(3, 40)), \
        int(r.integers(0, 4))
    kw = _config_kw(r, K, W, G)
    counts = None
    if G and seed % 2:
        counts = (r.random((W + 3, K, G)) < 0.3) * r.integers(1, 5,
                                                               (W + 3, K, G))
    args = dict(K=K, num_stations=G or None, counts=counts)
    ref = RFT.fault_trace(RFT.FaultConfig(**kw), W, **args)
    got = TFT.fault_trace(TFT.FaultConfig(**kw), W, **args)
    _same_trace(ref, got)
    assert (got.reach is not None) == (counts is not None)
    for n in (W - 1, W + 9):
        _same_trace(ref.extended(n), got.extended(n))


def test_trace_semantics_and_errors_match_reference():
    cfg = dict(deorbit=((1, 4),), launch=((1, 8), (2, 3)))
    got = TFT.fault_trace(TFT.FaultConfig(**cfg), 12, K=4)
    assert not got.alive[4:8, 1].any() and got.alive[8:, 1].all()
    assert not got.alive[:3, 2].any() and got.revive.sum() == 2
    for kw, args in ((dict(deorbit=((7, 1),)), dict(K=4)),
                     (dict(outages=((3, 0, 2),)), dict(K=4, num_stations=2)),
                     (dict(outages=((0, 0, 2),)), dict(K=4))):
        with pytest.raises(ValueError) as ref:
            RFT.fault_trace(RFT.FaultConfig(**kw), 5, **args)
        with pytest.raises(ValueError) as port:
            TFT.fault_trace(TFT.FaultConfig(**kw), 5, **args)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="windows < horizon"):
        TFT.fault_trace(TFT.FaultConfig(), 5, K=2,
                        counts=np.zeros((3, 2, 1)))


@pytest.mark.parametrize("seed", range(5))
def test_masks_equal_reference(seed):
    """`mask_connectivity`, `mask_served` (an assigned station down: no
    re-bid; weather-floored grants) and `mask_budget`."""
    r = np.random.default_rng(10 + seed)
    K, W, G = int(r.integers(2, 10)), int(r.integers(3, 30)), \
        int(r.integers(1, 4))
    kw = _config_kw(r, K, W, G)
    rtr = RFT.fault_trace(RFT.FaultConfig(**kw), W, K=K, num_stations=G)
    ttr = TFT.fault_trace(TFT.FaultConfig(**kw), W, K=K, num_stations=G)
    C = r.random((W + 4, K)) < 0.5          # longer than the trace
    np.testing.assert_array_equal(TFT.mask_connectivity(C, ttr),
                                  RFT.mask_connectivity(C, rtr))
    served = r.random((W, K)) < 0.6
    assign = np.where(served, r.integers(0, G, (W, K)), -1).astype(np.int32)
    grants = np.where(served, r.integers(1, 9, (W, K)), 0).astype(np.int32)
    for a, b in zip(TFT.mask_served(served, grants, assign, ttr),
                    RFT.mask_served(served, grants, assign, rtr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fields = dict(visible=served | (r.random((W, K)) < 0.2), served=served,
                  assign=assign, grants=grants, need_up=3, need_dn=1)
    got = TFT.mask_budget(TCN.LinkBudget(**fields), ttr)
    ref = RFT.mask_budget(RCN.LinkBudget(**fields), rtr)
    for f in ("visible", "served", "assign", "grants"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.need_up, got.need_dn) == (ref.need_up, ref.need_dn)


def test_scenario_helpers_equal_reference():
    for K, W, frac, seed in ((20, 50, 0.25, 4), (40, 192, 0.2, 0),
                             (40, 192, 0.4, 0), (7, 1, 0.5, 3),
                             (10, 30, 0.0, 1)):
        assert TFT.random_churn(K, W, frac, seed=seed) == \
            RFT.random_churn(K, W, frac, seed=seed)
    assert TFT.station_blackout(12, 64, 128) == \
        RFT.station_blackout(12, 64, 128)


@pytest.mark.parametrize("vdt", [np.int32, np.int16, np.int8])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_fault_reset_equals_reference_and_keeps_dtypes(vdt, batch):
    """Single and batched states, with the search's narrow columns (int16
    or int8 versions beside int32 progress and relay): values equal the
    reference's, every column keeps its dtype, and a second reset changes
    nothing."""
    r = np.random.default_rng(len(batch) + np.dtype(vdt).itemsize)
    shape = batch + (9,)
    cols = [r.integers(-1, 6, shape).astype(vdt) for _ in range(3)] + \
        [r.integers(0, 5, shape).astype(np.int32) for _ in range(2)]
    revive = r.random(shape) < 0.4
    ref = RFT.fault_reset(RS.SatState(*map(jnp.asarray, cols)),
                          jnp.asarray(revive))
    state = TS.SatState(*map(torch.as_tensor, cols))
    got = TFT.fault_reset(state, torch.as_tensor(revive))
    for a, b, c in zip(ref, got, state):
        assert b.dtype == c.dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    again = TFT.fault_reset(got, torch.as_tensor(revive))
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    plain = TFT.fault_reset(TS.SatState(*state[:3]), torch.as_tensor(revive))
    assert plain.progress is None and plain.relay is None


# ---------------------------------------------------------------------------
# the alive mask in the ISL layer


@pytest.mark.parametrize("name", ["starlink40", "starlink120", "flock191"])
def test_alive_masked_elections_equal_reference(name):
    """Elections and sink plans with random alive masks, including a plane
    whose members are all dead (it falls back to its full membership)."""
    rt = RI.ring_topology(RCN.constellation_preset(name))
    tt = TI.ring_topology(TCN.constellation_preset(name))
    K = tt.plane.shape[0]
    r = np.random.default_rng(K)
    for density in (0.03, 0.2):
        C = r.random((12, K)) < density
        alive = r.random(K) < 0.6
        alive[tt.plane == tt.plane[0]] = False
        sink = TI.elect_sinks(C, tt, alive=alive)
        np.testing.assert_array_equal(sink, RI.elect_sinks(C, rt,
                                                           alive=alive))
        live = tt.plane[alive]
        assert alive[sink[np.isin(tt.plane, live)]].all()
        assert (sink[tt.plane == tt.plane[0]] ==
                TI.elect_sinks(C, tt)[tt.plane == tt.plane[0]]).all()
        for rw in (0, 2):
            got = TI.ISL(topology=tt, relay_windows=rw).sink_plan(
                C, alive=alive)
            ref = RI.ISL(topology=rt, relay_windows=rw).sink_plan(
                C, alive=alive)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [(), (4,)])
def test_alive_masked_gossip_equals_reference(batch):
    """A dead satellite advertises -1 and adopts nothing; batched states
    also take one neighbour row per batch index (the sweep's variants)."""
    K = 10
    r = np.random.default_rng(len(batch))
    shape = batch + (K,)
    cols = [r.integers(-1, 6, shape).astype(np.int32) for _ in range(3)]
    nbrs = [np.stack([r.permutation(K) for _ in range(max(batch + (1,)))])
            for _ in range(4)]
    if not batch:
        nbrs = [a[0] for a in nbrs]
    alive = r.random(shape) < 0.6
    hop = (r.random(batch) < 0.7) if batch else True
    rstate = RS.SatState(*map(jnp.asarray, cols))
    tstate = TS.SatState(*map(torch.as_tensor, cols))
    if batch:
        ref = jax.vmap(lambda s, n0, n1, n2, n3, h, a: RI.gossip_step(
            s, n0, n1, n2, n3, h, alive=a))(
            rstate, *map(jnp.asarray, nbrs), jnp.asarray(hop),
            jnp.asarray(alive))
    else:
        ref = RI.gossip_step(rstate, *map(jnp.asarray, nbrs),
                             jnp.bool_(hop), alive=jnp.asarray(alive))
    got = TI.gossip_step(tstate, *(torch.as_tensor(a.astype(np.int64))
                                   for a in nbrs),
                         torch.as_tensor(hop) if batch else hop,
                         torch.as_tensor(alive))
    for a, b in zip(ref[0][:3], got[0][:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert not (got[1].numpy() & ~alive).any()


# ---------------------------------------------------------------------------
# engines over random scripted worlds (stub adapters)


def _world(r, K, I, density=0.4):
    return r.random((I, K)) < density, \
        (r.random(I) < 0.4).astype(np.int32)


def _churn(r, K, I):
    return dict(deorbit=_events(r, K, I, int(r.integers(1, 4))),
                launch=_events(r, K, I, int(r.integers(0, 3))))


def _pair(C, a, *, faults_kw=None, linked=None, isl=None, sched=None,
          **cfg):
    """The reference's and the port's engine over one scripted world."""
    I, K = C.shape
    rtr = ttr = None
    if faults_kw is not None:
        rtr = RFT.fault_trace(RFT.FaultConfig(**faults_kw), I, K=K)
        ttr = TFT.fault_trace(TFT.FaultConfig(**faults_kw), I, K=K)
    rb = tb = None
    if linked is not None:
        rb, tb = budgets(C, *linked)
    rsched, tsched = sched if sched is not None else \
        (RScripted(a), Scripted(a))
    risl, tisl = isl if isl is not None else (None, None)
    reng = RSE(C, RStub(K), rsched, REC(eval_every=I + 1, **cfg),
               link_budget=rb, faults=rtr, isl=risl)
    teng = TSE(C, StubAdapter(K), tsched, TEC(eval_every=I + 1, **cfg),
               device="cpu", link_budget=tb, faults=ttr, isl=tisl)
    return reng, teng


@pytest.mark.parametrize("seed", range(6))
def test_faulted_engine_equals_reference(seed):
    """Churn with recoveries and late launches, geometry only and (odd
    seeds) under a random link budget with weather: every integer of the
    port's run equals the reference's, and the executed connections are
    the fault-masked ones."""
    r = np.random.default_rng(100 + seed)
    K, I = int(r.integers(2, 9)), int(r.integers(8, 30))
    C, a = _world(r, K, I)
    kw = _churn(r, K, I)
    linked = None
    if seed % 2:
        grants = (r.integers(1, 4, (I, K)) * C).astype(np.int32)
        linked = (grants, int(r.integers(0, 4)), int(r.integers(0, 4)))
        kw.update(rate_scale_min=0.5, rate_scale_max=1.0, rate_block=4)
    reng, teng = _pair(C, a, faults_kw=kw, linked=linked)
    rres, tres = reng.run(), teng.run()
    same_run(reng, rres, teng, tres)
    if linked is None:
        trace = TFT.fault_trace(TFT.FaultConfig(**kw), I, K=K)
        assert tres.total_connections == int((C & trace.mask).sum())


@pytest.mark.parametrize("seed", range(3))
def test_all_alive_trace_equals_no_faults(seed):
    """A trace that kills nothing within the horizon (a deorbit past it)
    gives the bits of `faults=None`, with and without a budget."""
    r = np.random.default_rng(200 + seed)
    K, I = int(r.integers(2, 9)), int(r.integers(8, 30))
    C, a = _world(r, K, I)
    grants = (r.integers(1, 4, (I, K)) * C).astype(np.int32)
    for linked in (None, (grants, 2, 1)):
        tb = None if linked is None else budgets(C, *linked)[1]
        runs = []
        for trace in (None, TFT.fault_trace(
                TFT.FaultConfig(deorbit=((0, I + 1),)), I, K=K)):
            eng = TSE(C, StubAdapter(K), Scripted(a),
                      TEC(eval_every=I + 1), device="cpu", link_budget=tb,
                      faults=trace)
            res = eng.run()
            runs.append((eng.version.tolist(), eng.pending.tolist(),
                         eng.buffered_base.tolist(), eng.ig, res.summary()))
        assert runs[0] == runs[1]


def test_recovered_satellite_downloads_again_before_it_uploads():
    """A satellite that dies and revives comes back "never received": it
    holds version/pending -1 until its next contact downloads the model,
    and its pre-outage update never reaches the buffer."""
    I, K = 8, 2
    C = np.zeros((I, K), bool)
    C[:, 0] = True
    C[0, 1] = True
    a = np.zeros(I, np.int32)
    a[1] = 1
    kw = dict(deorbit=((1, 2),), launch=((1, 5),))
    reng, teng = _pair(C, a, faults_kw=kw)
    rres, tres = reng.run(), teng.run()
    same_run(reng, rres, teng, tres)
    assert teng.version[1] == -1 and teng.pending[1] == -1
    assert teng.version[0] == teng.ig == 1
    # a contact after the revival downloads first: no upload in its window
    C2 = C.copy()
    C2[6, 1] = True
    reng, teng = _pair(C2, a, faults_kw=kw)
    rres, tres = reng.run(), teng.run()
    same_run(reng, rres, teng, tres)
    assert teng.version[1] == teng.pending[1] == 1
    assert tres.num_aggregated_gradients == 2     # sats 0 and 1 at window 1


class _Recording(Scripted):
    """Records the connectivity and link gate `decide` receives."""

    def __init__(self, a):
        super().__init__(a, device=False)
        self.seen = []

    def decide(self, i, *, connectivity, link=None, **kw):
        self.seen.append((connectivity, link))
        return super().decide(i, **kw)


@pytest.mark.parametrize("linked", [False, True])
def test_blind_and_oracle_plan_views(linked):
    """Blind: the scheduler sees the clean world while the run executes the
    masked one; oracle: it sees the masked world."""
    I, K = 8, 3
    C = np.ones((I, K), bool)
    a = np.zeros(I, np.int32)
    tb = None if not linked else budgets(
        C, np.full((I, K), 4, np.int32), 2, 1)[1]
    for oracle in (False, True):
        trace = TFT.fault_trace(TFT.FaultConfig(
            deorbit=((0, 2),), rate_scale_min=0.5, rate_scale_max=0.5,
            oracle=oracle), I, K=K)
        sched = _Recording(a)
        eng = TSE(C, StubAdapter(K), sched, TEC(eval_every=I + 1),
                  device="cpu", link_budget=tb, faults=trace)
        eng.run()
        plan_c, link = sched.seen[3]
        assert not eng.C[3, 0] and eng.C[3, 1]      # executed: masked
        if oracle:
            assert plan_c is eng.C
            assert link is None or link.grant is eng._grants
        else:
            assert plan_c.all() and plan_c is not eng.C
            if linked:
                assert (link.grant == 4).all()      # clean grants
                assert (eng._grants[3, 1:] == 2).all()   # weather-scaled


# ---------------------------------------------------------------------------
# federations on a tiny world under churn and launches

LINK = dict(uplink_mbps=20.0, downlink_mbps=100.0, model_mb=600.0,
            gs_capacity=1)
FAULTS = dict(deorbit=((1, 10), (5, 20), (9, 30)),
              launch=((5, 40), (11, 25)))
WEATHER = dict(outages=((0, 30, 50),), rate_scale_min=0.5,
               rate_scale_max=1.0, rate_block=8, seed=2)
CASES = {"alone": ("fedbuff", {"M": 3}, False),
         "budget": ("fedbuff", {"M": 3}, True),
         "sink": ("intra_plane", {"M": 6}, True),
         "gossip": ("isl_async", {}, True),
         # blind FedSpace: it plans on the clean world and grants while
         # the run executes the faulted ones; a histogram-only forest (no
         # split on T), so every schedule must equal the reference's
         "fedspace": ("fedspace", {"I0": 12, "n_min": 2, "n_max": 5,
                                   "num_candidates": 64}, True)}


def _exp(api, ec, linked, **kw):
    """12 satellites in 3 polar planes of 4 over the 4-station network, 18
    hours (72 windows); one-window ring hops; under the binding budget of
    tests/test_torch_isl.py when `linked`."""
    shell = (RCN if api is RA else TCN).Shell(12, 3, 560_000.0, 97.6)
    return api.FLExperiment(
        name="tiny-faults",
        constellation=api.ConstellationConfig(
            num_satellites=12, days=0.75, ground="mid4",
            spec_overrides={"shells": (shell,), "min_elevation_deg": 25.0}),
        dataset=api.DatasetConfig(num_train=600, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 16}),
        scheduler=api.SchedulerConfig("fedbuff", params={"M": 3}),
        train=ec(local_steps=2, client_lr=0.5, eval_every=24,
                 stop_at_target=False),
        link=api.LinkConfig(**(LINK if linked else {})),
        isl=api.ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24), **kw)


def _faults(api, linked):
    return api.FaultConfig(**FAULTS, **(WEATHER if linked else {}))


@pytest.fixture(scope="module")
def runs():
    """Each case on the reference's and the port's faulted world, from the
    reference's initial model; FedSpace's re-plans recorded."""
    worlds = {}
    for linked in (False, True):
        worlds[linked] = (
            RA.Federation.from_experiment(
                _exp(RA, REC, linked, faults=_faults(RA, linked))),
            TA.Federation.from_experiment(
                _exp(TA, TEC, linked, faults=_faults(TA, linked)),
                device="cpu"))
    rfed = worlds[False][0]
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    rf, tf = _forests()
    out, logs = {}, ([], [])
    mp = pytest.MonkeyPatch()
    try:
        for module, log in zip((RSched, TSR), logs):
            _recording(mp, module, log)
        for case, (name, kw, linked) in CASES.items():
            rfed, tfed = worlds[linked]
            rkw, tkw = (kw, kw) if name != "fedspace" else \
                ({**kw, "regressor": rf}, {**kw, "regressor": tf})
            reng = rfed.with_scheduler(name, **rkw).engine(init_params=p0)
            rres = reng.run()
            teng = tfed.with_scheduler(name, **tkw).engine(
                init_params=params_from_numpy(p0, "cpu"), device="cpu")
            tres = teng.run()
            out[case] = (reng, rres), (teng, tres)
    finally:
        mp.undo()
    return worlds, p0, out, logs


def test_federations_resolve_the_same_traces(runs):
    worlds = runs[0]
    for linked, (rfed, tfed) in worlds.items():
        _same_trace(rfed.faults, tfed.faults)
        assert (tfed.faults.reach is not None) == linked
        np.testing.assert_array_equal(tfed.C, rfed.C)
        if linked:
            reng, teng = rfed.engine(), tfed.engine(device="cpu")
            np.testing.assert_array_equal(teng.C, reng.C)
            np.testing.assert_array_equal(teng._grants, reng._grants)
            np.testing.assert_array_equal(teng._plan_grants,
                                          reng._plan_grants)
            assert (teng._grants < teng._plan_grants).any()   # weather


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_federations_integers_equal_reference(runs, case):
    (reng, rres), (teng, tres) = runs[2][case]
    same_run(reng, rres, teng, tres)
    assert tres.num_global_updates >= 3
    assert (teng.relay_units is not None) == (case == "sink")


@pytest.mark.parametrize("case", list(CASES))
def test_faulted_federations_floats_within_tolerance(runs, case):
    (reng, rres), (teng, tres) = runs[2][case]
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)
    final = params_to_numpy(teng.params)
    for k, ref in reng.params.items():
        np.testing.assert_allclose(final[k], np.asarray(ref), atol=1e-4,
                                   err_msg=k)


def test_faulted_fedspace_schedules_equal_reference(runs):
    """Every re-plan of the blind FedSpace run, searched on the clean plan
    view from the state the faulted run reached, equals the reference's."""
    rlog, tlog = runs[3]
    assert len(tlog) == len(rlog) == 6
    for j, (a, b) in enumerate(zip(tlog, rlog)):
        np.testing.assert_array_equal(a, b, err_msg=f"re-plan {j}")
    assert len({a.tobytes() for a in tlog}) > 1


def test_faults_change_the_run(runs):
    """The faulted runs are not the clean ones: churn removes contacts."""
    worlds, p0, out, _ = runs
    tfed = worlds[False][1].with_faults(None)
    assert tfed.faults is None and tfed.experiment.faults is None
    clean = tfed.engine(init_params=params_from_numpy(p0, "cpu"),
                        device="cpu").run()
    (_, _), (_, faulted) = out["alone"]
    assert faulted.total_connections < clean.total_connections


def test_with_faults_shares_the_world_and_its_caches(runs):
    worlds = runs[0]
    rfed, tfed = worlds[True]
    assert tfed._counts_cache["station_windows"] is not None
    counts = tfed._counts_cache["station_windows"]
    other = tfed.with_faults(TA.FaultConfig(deorbit=((3, 5),)))
    for f in ("C", "adapter", "data", "link_budget", "isl", "spec"):
        assert getattr(other, f) is getattr(tfed, f), f
    assert other._regressor_cache is tfed._regressor_cache
    assert other._counts_cache is tfed._counts_cache
    assert other._counts_cache["station_windows"] is counts
    assert other.device == tfed.device
    ref = rfed.with_faults(RA.FaultConfig(deorbit=((3, 5),)))
    _same_trace(ref.faults, other.faults)
    # the scheduler clone carries the trace along
    assert other.with_scheduler("sync").faults is other.faults
    assert tfed.with_faults(TA.FaultConfig()).faults is None
    assert tfed.with_faults(None).faults is None
    assert other.experiment.describe() == ref.experiment.describe()


def test_trivial_config_resolves_to_no_faults():
    exp = _exp(TA, TEC, False, faults=TA.FaultConfig())
    fed = TA.Federation.from_experiment(exp, device="cpu")
    assert fed.faults is None and fed.engine(device="cpu").faults is None
    assert "station_windows" not in fed._counts_cache


def test_with_faults_resolves_the_counts_once():
    fed = TA.Federation.from_experiment(_exp(TA, TEC, False), device="cpu")
    assert fed._counts_cache == {}
    out = fed.with_faults(TA.FaultConfig(outages=((0, 3, 9),)))
    counts = fed._counts_cache["station_windows"]
    assert out.faults.reach is not None
    again = out.with_faults(TA.FaultConfig(outages=((1, 3, 9),)))
    assert again._counts_cache["station_windows"] is counts
