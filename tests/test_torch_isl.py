"""The port's ISL layer (`repro_torch.core.isl`, the `intra_plane` and
`isl_async` schedulers, the engine's sink-relay and gossip wiring) against
the JAX package's, on the same seeded inputs: ring topologies, sink
elections, sink plans and reachability bit for bit; the relay, sink and
gossip transitions on random states, single and batched (R, K); and
federations through `Federation.from_experiment` on a tiny world under a
binding link budget — `fedbuff`, `intra_plane` and `isl_async` — whose
integer counters, staleness histograms and `progress` / `relay` columns
must equal the reference's, accuracies within 1/NUM_VAL and val losses
within 1e-4 (tests/test_torch_engine.py's tolerances). Plus the parity
gates of the reference's own ISL tests: the identity topology is the
ground-only protocol, and a ground-only scheduler ignores the ISL
runtime."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.api as RA
import repro_torch.fl.api as TA
from repro.core import connectivity as RCN
from repro.core import isl as RI
from repro.core import staleness as RS
from repro.fl.engine import EngineConfig as REC
from repro_torch.core import connectivity as TCN
from repro_torch.core import isl as TI
from repro_torch.core import staleness as TS
from repro_torch.core.scheduler import make_scheduler
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine
from repro_torch.fl.registry import SCHEDULERS
from repro_torch.weights import params_from_numpy, params_to_numpy

NUM_VAL = 200


# ---------------------------------------------------------------------------
# topology, elections, reachability: bit for bit


def _random_spec(pkg, seed):
    """A random 1-3 shell Walker spec of small planes (the reference
    tests' `_multi_shell_spec`, drawn from a seeded generator)."""
    r = np.random.default_rng(seed)
    shells = tuple(
        pkg.Shell(int(p * n), int(p), 500_000.0 + 20_000.0 * s,
                  50.0 + 20.0 * s)
        for s, (p, n) in enumerate(
            zip(r.integers(1, 5, int(r.integers(1, 4))),
                r.integers(1, 6, 3))))
    return pkg.ConstellationSpec(
        num_satellites=sum(sh.num_satellites for sh in shells),
        shells=shells, seed=int(r.integers(0, 11)))


def _specs(name):
    if name.startswith("random"):
        seed = int(name[6:])
        return _random_spec(RCN, seed), _random_spec(TCN, seed)
    return RCN.constellation_preset(name), TCN.constellation_preset(name)


SPECS = ["flock191", "starlink40", "starlink120"] + \
    [f"random{i}" for i in range(6)]


def _same_topology(ref, got):
    for f in ("plane", "pos", "nxt", "prv", "left", "right"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.num_planes == ref.num_planes
    np.testing.assert_array_equal(got.plane_sizes(), ref.plane_sizes())


@pytest.mark.parametrize("name", SPECS)
def test_ring_topology_bit_equal(name):
    rspec, tspec = _specs(name)
    _same_topology(RI.ring_topology(rspec), TI.ring_topology(tspec))
    # rings close within their plane, and never leave it
    topo = TI.ring_topology(tspec)
    assert (topo.plane[topo.nxt] == topo.plane).all()
    assert (topo.prv[topo.nxt] == np.arange(tspec.num_satellites)).all()


def test_identity_topology_equal():
    _same_topology(RI.identity_topology(9), TI.identity_topology(9))
    np.testing.assert_array_equal(
        TI.identity_topology(9).ring_distance(np.arange(9)), np.zeros(9))


@pytest.mark.parametrize("name", SPECS)
def test_elections_plans_and_reach_bit_equal(name):
    """Sinks over random epoch connectivity (sparse, with ties on the
    first contact), the sink plans at three hop latencies, ring
    distances and the reachable count."""
    rspec, tspec = _specs(name)
    rt, tt = RI.ring_topology(rspec), TI.ring_topology(tspec)
    r = np.random.default_rng(len(name))
    K = tspec.num_satellites
    for density in (0.0, 0.03, 0.2):
        C = r.random((12, K)) < density
        sink = TI.elect_sinks(C, tt)
        np.testing.assert_array_equal(sink, RI.elect_sinks(C, rt))
        assert sink.dtype == np.int32
        assert (tt.plane[sink] == tt.plane).all()
        np.testing.assert_array_equal(tt.ring_distance(sink),
                                      rt.ring_distance(sink))
        assert TI.reachable_count(tt, C) == RI.reachable_count(rt, C)
        for rw in (0, 1, 3):
            got = TI.ISL(topology=tt, relay_windows=rw, epoch=12).sink_plan(C)
            ref = RI.ISL(topology=rt, relay_windows=rw, epoch=12).sink_plan(C)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_isl_config_and_build_equal():
    for kw in ({}, {"isl_mbps": 100.0, "model_mb": 600.0},
               {"isl_mbps": 4.0, "model_mb": 600.0, "epoch": 6},
               {"isl_mbps": 1.0, "model_mb": 5000.0, "cross_plane": True}):
        got, ref = TI.ISLConfig(**kw), RI.ISLConfig(**kw)
        assert got.relay_windows == ref.relay_windows
        g = TI.build_isl(TCN.constellation_preset("starlink40"), got)
        f = RI.build_isl(RCN.constellation_preset("starlink40"), ref)
        assert (g.relay_windows, g.epoch, g.cross_plane) == \
            (f.relay_windows, f.epoch, f.cross_plane)
        _same_topology(f.topology, g.topology)
    assert TI.ISLConfig(isl_mbps=4.0, model_mb=600.0).relay_windows == 2
    for bad in ({"isl_mbps": -1.0}, {"model_mb": -1.0}, {"epoch": 0}):
        with pytest.raises(ValueError):
            TI.ISLConfig(**bad)


# ---------------------------------------------------------------------------
# the relay, sink and gossip transitions


def _state(r, shape, ig=5, relay=True):
    cols = [r.integers(-1, ig + 1, shape).astype(np.int32)
            for _ in range(3)]
    rel = r.integers(0, 4, shape).astype(np.int32) if relay else None
    return (RS.SatState(*(jnp.asarray(c) for c in cols),
                        relay=None if rel is None else jnp.asarray(rel)),
            TS.SatState(*(torch.as_tensor(c) for c in cols),
                        relay=None if rel is None else torch.as_tensor(rel)))


def _same(ref, got, what=""):
    a, b = np.asarray(ref), got.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(b, a, err_msg=what)


def _same_state(ref, got):
    for f in TS.SatState._fields:
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same(a, b, f)


K_T = 14      # one shape for the random cases: the reference compiles once


def _topology_arrays(r):
    """A random ring over K_T satellites in planes of 1-5, random grid
    links: (nxt, prv, left, right) int32."""
    perm = r.permutation(K_T)
    nxt, prv = np.arange(K_T), np.arange(K_T)
    i = 0
    while i < K_T:
        n = min(int(r.integers(1, 6)), K_T - i)
        ring = perm[i:i + n]
        nxt[ring], prv[ring] = np.roll(ring, -1), np.roll(ring, 1)
        i += n
    return tuple(a.astype(np.int32) for a in
                 (nxt, prv, r.integers(0, K_T, K_T), r.integers(0, K_T, K_T)))


@pytest.mark.parametrize("seed", range(6))
def test_relay_and_sink_transitions_match_reference(seed):
    r = np.random.default_rng(seed)
    rst, tst = _state(r, K_T)
    need = r.integers(0, 4, K_T).astype(np.int32)
    rs, rarr = RI.relay_step(rst, jnp.asarray(need))
    ts, tarr = TI.relay_step(tst, torch.as_tensor(need))
    _same_state(rs, ts)
    _same(rarr, tarr, "arrived")
    sink = r.integers(0, K_T, K_T).astype(np.int32)
    conn = r.random(K_T) < 0.4
    _same(RI.sink_connectivity(jnp.asarray(conn), jnp.asarray(sink), rarr,
                               rs.pending),
          TI.sink_connectivity(torch.as_tensor(conn),
                               torch.as_tensor(sink.astype(np.int64)), tarr,
                               ts.pending), "sink connectivity")
    dn = r.random(K_T) < 0.5
    _same_state(RI.reset_relay(rs, jnp.asarray(dn)),
                TI.reset_relay(ts, torch.as_tensor(dn)))


@pytest.mark.parametrize("seed", range(6))
def test_gossip_step_matches_reference(seed):
    r = np.random.default_rng(50 + seed)
    rst, tst = _state(r, K_T, relay=False)
    arrays = _topology_arrays(r)
    for hop in (True, False):
        rs, radopt = RI.gossip_step(rst, *(jnp.asarray(a) for a in arrays),
                                    jnp.bool_(hop))
        ts, tadopt = TI.gossip_step(
            tst, *(torch.as_tensor(a.astype(np.int64)) for a in arrays), hop)
        _same_state(rs, ts)
        _same(radopt, tadopt, "adopted")


@pytest.mark.parametrize("seed", range(3))
def test_batched_isl_transitions_match_vmapped_reference(seed):
    """(R, K) stacks of states, one shared topology and sink plan, a
    do_hop per row: the reference under `vmap`."""
    r = np.random.default_rng(90 + seed)
    R = 5
    rst, tst = _state(r, (R, K_T))
    arrays = _topology_arrays(r)
    hops = r.random(R) < 0.5
    need = r.integers(0, 3, K_T).astype(np.int32)
    sink = r.integers(0, K_T, K_T).astype(np.int32)
    conn = r.random(K_T) < 0.5

    def one(st, hop):
        st, adopted = RI.gossip_step(st, *(jnp.asarray(a) for a in arrays),
                                     hop)
        st, arrived = RI.relay_step(st, jnp.asarray(need))
        eff = RI.sink_connectivity(jnp.asarray(conn), jnp.asarray(sink),
                                   arrived, st.pending)
        return st, adopted, arrived, eff
    rs, radopt, rarr, reff = jax.vmap(one)(rst, jnp.asarray(hops))
    ts, tadopt = TI.gossip_step(
        tst, *(torch.as_tensor(a.astype(np.int64)) for a in arrays),
        torch.as_tensor(hops))
    ts, tarr = TI.relay_step(ts, torch.as_tensor(need))
    teff = TI.sink_connectivity(torch.as_tensor(conn),
                                torch.as_tensor(sink.astype(np.int64)),
                                tarr, ts.pending)
    _same_state(rs, ts)
    for a, b, what in ((radopt, tadopt, "adopted"), (rarr, tarr, "arrived"),
                       (reff, teff, "sink connectivity")):
        _same(a, b, what)


def test_faults_and_mesh_raise_naming_their_slices():
    """The mesh still raises. The alive mask raised until the faults
    slice: gossip and the sink plan now take it as the reference does."""
    rst, tst = _state(np.random.default_rng(0), 4)
    idx = torch.arange(4)
    nxt = np.array([1, 2, 3, 0])
    alive = np.array([True, False, True, True])
    ref, radopt = RI.gossip_step(rst, jnp.asarray(nxt), jnp.asarray(nxt),
                                 jnp.arange(4), jnp.arange(4),
                                 jnp.bool_(True), alive=jnp.asarray(alive))
    got, tadopt = TI.gossip_step(tst, torch.as_tensor(nxt),
                                 torch.as_tensor(nxt), idx, idx, True,
                                 alive=torch.as_tensor(alive))
    _same_state(ref, got)
    _same(radopt, tadopt, "adopted")
    with pytest.raises(NotImplementedError, match="mesh slice"):
        TI.gossip_step(tst, idx, idx, idx, idx, True, axis_name="sat")
    with pytest.raises(NotImplementedError, match="mesh slice"):
        TI.sink_connectivity(torch.ones(4, dtype=torch.bool), idx,
                             torch.ones(4, dtype=torch.bool), tst.pending,
                             axis_name="sat")
    C = np.array([[False, True, True, False], [True, True, False, True]])
    for ref, got in zip(
            RI.ISL(topology=RI.identity_topology(4)).sink_plan(
                C, alive=alive),
            TI.ISL(topology=TI.identity_topology(4)).sink_plan(
                C, alive=alive)):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the schedulers


def test_isl_schedulers_registered_with_their_modes():
    assert {"intra_plane", "isl_async"} <= set(SCHEDULERS.names())
    assert make_scheduler("intra_plane").isl_mode == "sink"
    assert make_scheduler("isl_async").isl_mode == "gossip"
    for name, kw in (("fedbuff", {"M": 1}), ("sync", {}), ("async", {}),
                     ("periodic", {})):
        assert make_scheduler(name, **kw).isl_mode is None
    assert make_scheduler("isl_async", M=0).M == 1


def test_intra_plane_threshold_resolution():
    """tests/test_isl.py's case: the reachable count, an explicit M, and
    sync over K without an ISL runtime."""
    topo = TI.ring_topology(TCN.ConstellationSpec(
        num_satellites=8, shells=(TCN.Shell(8, 2, 550_000.0, 53.0),)))
    C = np.zeros((6, 8), bool)
    C[0, np.flatnonzero(topo.plane == 0)[0]] = True
    runtime = TI.ISL(topology=topo, relay_windows=0, epoch=6)
    for M, isl, want in ((None, runtime, 4), (2, runtime, 2),
                         (None, None, 8)):
        s = make_scheduler("intra_plane", M=M)
        s.isl = isl
        s.reset()
        assert s._threshold(C, 8) == want
        assert s.decide(0, n_in_buffer=want, K=8, connectivity=C)
        assert not s.decide(0, n_in_buffer=want - 1, K=8, connectivity=C)


# ---------------------------------------------------------------------------
# federations on a tiny world under a binding budget

LINK = dict(uplink_mbps=20.0, downlink_mbps=100.0, model_mb=600.0,
            gs_capacity=1)
SCHEDS = {"fedbuff": {"M": 3}, "intra_plane": {}, "isl_async": {}}


def _exp(api, ec, **kw):
    """12 satellites in 3 polar planes of 4 over the 4-station network, 18
    hours, one satellite a station and need_up 4; a ring hop takes one
    window (600 MB over 100 Mbit/s)."""
    shell = (RCN if api is RA else TCN).Shell(12, 3, 560_000.0, 97.6)
    return api.FLExperiment(
        name="tiny-isl",
        constellation=api.ConstellationConfig(
            num_satellites=12, days=0.75, ground="mid4",
            spec_overrides={"shells": (shell,), "min_elevation_deg": 25.0}),
        dataset=api.DatasetConfig(num_train=600, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 16}),
        scheduler=api.SchedulerConfig("fedbuff", params=SCHEDS["fedbuff"]),
        train=ec(local_steps=2, client_lr=0.5, eval_every=24,
                 stop_at_target=False),
        link=api.LinkConfig(**LINK),
        isl=api.ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24), **kw)


@pytest.fixture(scope="module")
def runs():
    """Each policy on the reference's and the port's world, from the
    reference's initial model."""
    rfed = RA.Federation.from_experiment(_exp(RA, REC))
    tfed = TA.Federation.from_experiment(_exp(TA, TEC), device="cpu")
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    out = {}
    for name, kw in SCHEDS.items():
        reng = rfed.with_scheduler(name, **kw).engine(init_params=p0)
        rres = reng.run()
        teng = tfed.with_scheduler(name, **kw).engine(
            init_params=params_from_numpy(p0, "cpu"), device="cpu")
        tres = teng.run()
        out[name] = (reng, rres), (teng, tres)
    return rfed, tfed, p0, out


def test_federation_resolves_the_isl_runtime(runs):
    rfed, tfed, _, _ = runs
    assert tfed.isl is not None and tfed.link_budget is not None
    assert (tfed.isl.relay_windows, tfed.isl.epoch, tfed.isl.cross_plane) \
        == (rfed.isl.relay_windows, rfed.isl.epoch, rfed.isl.cross_plane) \
        == (1, 24, False)
    _same_topology(rfed.isl.topology, tfed.isl.topology)
    assert tfed.isl.topology.num_planes == 3
    other = tfed.with_scheduler("isl_async")
    assert other.isl is tfed.isl and other.link_budget is tfed.link_budget
    assert tfed.experiment.describe() == rfed.experiment.describe()
    assert TA.Federation.from_experiment(
        dataclasses.replace(_exp(TA, TEC), isl=None),
        device="cpu").isl is None


@pytest.mark.parametrize("counter", [
    "num_global_updates", "num_aggregated_gradients", "idle_connections",
    "total_connections", "windows_run", "eval_windows"])
@pytest.mark.parametrize("name", list(SCHEDS))
def test_isl_runs_counters_exactly_equal(runs, name, counter):
    (_, rres), (_, tres) = runs[3][name]
    assert getattr(tres, counter) == getattr(rres, counter)
    assert tres.scheme == rres.scheme == name
    assert tres.num_global_updates >= 3      # every policy aggregated


@pytest.mark.parametrize("name", list(SCHEDS))
def test_isl_runs_state_and_histogram_exactly_equal(runs, name):
    (reng, rres), (teng, tres) = runs[3][name]
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    assert teng.ig == reng.ig
    for f in ("version", "pending", "buffered_base", "transfer_progress"):
        np.testing.assert_array_equal(getattr(teng, f), getattr(reng, f),
                                      err_msg=f)
    if name == "intra_plane":
        np.testing.assert_array_equal(teng.relay_units, reng.relay_units)
        assert teng.relay_units.sum() > 0
    else:
        assert teng.relay_units is None and reng.relay_units is None


@pytest.mark.parametrize("name", list(SCHEDS))
def test_isl_runs_floats_within_tolerance(runs, name):
    (reng, rres), (teng, tres) = runs[3][name]
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)
    final = params_to_numpy(teng.params)
    for k, ref in reng.params.items():
        np.testing.assert_allclose(final[k], np.asarray(ref), atol=1e-4,
                                   err_msg=k)


def _trajectory(eng, res):
    return (res.num_global_updates, res.num_aggregated_gradients,
            res.idle_connections, res.total_connections,
            res.staleness_hist.tolist(), eng.version.tolist(),
            eng.pending.tolist(), eng.buffered_base.tolist(),
            [float(a) for a in res.accuracy])


def _engine(fed, p0, scheduler, **kw):
    return SimulationEngine(fed.C, fed.adapter, scheduler,
                            fed.experiment.train, device="cpu",
                            init_params=params_from_numpy(p0, "cpu"), **kw)


def test_identity_topology_is_fedbuff_on_the_ground(runs):
    """Both ISL policies on the all-self-loop topology (every satellite
    its own sink and neighbour) run the ground-only FedBuff trajectory,
    bit for bit, with and without the budget."""
    _, tfed, p0, _ = runs
    ident = TI.ISL(topology=TI.identity_topology(12), relay_windows=0,
                   epoch=8)
    for budget in (None, tfed.link_budget):
        ref_eng = _engine(tfed, p0, make_scheduler("fedbuff", M=3),
                          link_budget=budget)
        ref = _trajectory(ref_eng, ref_eng.run())
        for name in ("intra_plane", "isl_async"):
            eng = _engine(tfed, p0, make_scheduler(name, M=3),
                          link_budget=budget, isl=ident)
            assert _trajectory(eng, eng.run()) == ref, name
            assert (eng.relay_units is not None) == (name == "intra_plane")


def test_ground_only_scheduler_ignores_the_isl_runtime(runs):
    _, tfed, p0, _ = runs
    trajs = []
    for isl in (None, tfed.isl):
        eng = _engine(tfed, p0, make_scheduler("fedbuff", M=3), isl=isl,
                      link_budget=tfed.link_budget)
        trajs.append(_trajectory(eng, eng.run()))
        assert eng.relay_units is None and eng.scheduler.isl is None
    assert trajs[0] == trajs[1]


def test_isl_world_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.Federation.from_experiment(_exp(TA, TEC))


def test_faults_with_isl_still_raise():
    """Raised until the faults slice: an ISL world under a budget now
    resolves the reference's fault trace and sink plans (the alive mask in
    the election)."""
    faults = dict(deorbit=((0, 3), (5, 10)), launch=((5, 40),),
                  outages=((1, 20, 30),))
    rfed = RA.Federation.from_experiment(dataclasses.replace(
        _exp(RA, REC), faults=RA.FaultConfig(**faults)))
    tfed = TA.Federation.from_experiment(dataclasses.replace(
        _exp(TA, TEC), faults=TA.FaultConfig(**faults)), device="cpu")
    assert tfed.isl is not None and tfed.faults.reach is not None
    for f in ("alive", "station_up", "reach", "revive"):
        np.testing.assert_array_equal(getattr(tfed.faults, f),
                                      getattr(rfed.faults, f), err_msg=f)
    alive = tfed.faults.alive[:24].any(axis=0)
    for ref, got in zip(rfed.isl.sink_plan(rfed.C[:24], alive=alive),
                        tfed.isl.sink_plan(tfed.C[:24], alive=alive)):
        np.testing.assert_array_equal(got, ref)
