"""The port's FedBuff federation (`repro_torch.fl.api.Federation`) against
the JAX package's on one small world, started from the reference's own
initial model; plus the quickstart's connectivity, bit for bit.

FedBuff decides on buffer counts alone, so with the target-accuracy stop
switched off every integer counter must match exactly; accuracies, losses
and the final model must match within float tolerance."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.fl.api as RA
import repro_torch.fl.api as TA
from repro.core import connectivity as RCN
from repro.core import faults as RFT
from repro.fl.callbacks import JsonlMetricsCallback as RJsonl
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as RSE
from repro_torch.core import connectivity as TCN
from repro_torch.core import faults as TFT
from repro_torch.core import mesh as TM
from repro_torch.fl.callbacks import JsonlMetricsCallback as TJsonl
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

NUM_VAL = 200


def _exp(api, engine_config, **train):
    return api.FLExperiment(
        name="small",
        constellation=api.ConstellationConfig(num_satellites=16, days=0.5),
        dataset=api.DatasetConfig(num_train=800, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 24}),
        scheduler=api.SchedulerConfig(kind="fedbuff", params={"M": 4}),
        train=engine_config(local_steps=4, client_lr=1.0, eval_every=8,
                            stop_at_target=False, **train))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("metrics")
    rfed = RA.Federation.from_experiment(_exp(RA, REC))
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    reng = rfed.engine(init_params=p0,
                       callbacks=[RJsonl(str(out / "ref.jsonl"))])
    rres = reng.run()
    tfed = TA.Federation.from_experiment(_exp(TA, TEC), device="cpu")
    teng = tfed.engine(init_params=params_from_numpy(p0, "cpu"),
                       callbacks=[TJsonl(str(out / "port.jsonl"))],
                       device="cpu")
    tres = teng.run()
    return (rfed, reng, rres), (tfed, teng, tres), out


@pytest.mark.parametrize("counter", [
    "num_global_updates", "num_aggregated_gradients", "idle_connections",
    "total_connections", "windows_run", "eval_windows"])
def test_counters_exactly_equal(runs, counter):
    (_, _, rres), (_, _, tres), _ = runs
    assert getattr(tres, counter) == getattr(rres, counter)
    if counter == "num_global_updates":
        assert tres.num_global_updates > 3    # the run aggregated


def test_staleness_histogram_and_protocol_state_exactly_equal(runs):
    (_, reng, rres), (_, teng, tres), _ = runs
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    assert teng.ig == reng.ig
    np.testing.assert_array_equal(teng.version, reng.version)
    np.testing.assert_array_equal(teng.pending, reng.pending)
    np.testing.assert_array_equal(teng.buffered_base, reng.buffered_base)


def test_eval_metrics_and_final_model_within_tolerance(runs):
    (_, reng, rres), (_, teng, tres), _ = runs
    # accuracy counts argmax hits on NUM_VAL samples: allow one flip
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    # float32 rounding carried through the aggregations: ~2e-7 observed
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)
    final = params_to_numpy(teng.params)
    for k, ref in reng.params.items():
        # ~1.5e-6 observed after 15 aggregations of 4 steps at lr=1.0
        np.testing.assert_allclose(final[k], np.asarray(ref), atol=1e-4,
                                   err_msg=k)


def test_metrics_stream_has_the_same_events(runs):
    *_, out = runs
    ref = [json.loads(x) for x in open(out / "ref.jsonl")]
    port = [json.loads(x) for x in open(out / "port.jsonl")]
    assert [e["event"] for e in port] == [e["event"] for e in ref]
    assert port[-1]["global_updates"] == ref[-1]["global_updates"]


def test_connectivity_summary_equal(runs):
    (rfed, _, _), (tfed, _, _), _ = runs
    assert tfed.connectivity_summary() == rfed.connectivity_summary()


def test_quickstart_connectivity_bit_equal():
    rspec = RCN.ConstellationSpec(num_satellites=40)
    tspec = TCN.ConstellationSpec(num_satellites=40)
    rC = RCN.connectivity_sets(rspec, days=3.0)
    tC = TCN.connectivity_sets(tspec, days=3.0)
    assert tC.shape == (288, 40)
    np.testing.assert_array_equal(tC, rC)
    rs, ts = RCN.connectivity_stats(rC), TCN.connectivity_stats(tC)
    assert rs.keys() == ts.keys()
    for k in rs:
        np.testing.assert_array_equal(ts[k], rs[k], err_msg=k)


def test_with_scheduler_shares_the_world(runs):
    _, (tfed, _, _), _ = runs
    other = tfed.with_scheduler("sync")
    assert other.C is tfed.C and other.adapter is tfed.adapter
    assert other.scheduler.name == "sync"
    assert other.experiment.scheduler.kind == "sync"


@pytest.mark.parametrize("change,slice_name", [
    # compressed uplinks (over a budget or not), which raised until the
    # compression slice
    (dict(link=TA.LinkConfig(model_mb=300.0, uplink_mbps=20.0,
                             uplink_topk=0.25)), "compression"),
    (dict(link=TA.LinkConfig(gs_capacity=2, uplink_int8=True)),
     "compression"),
    (dict(link=TA.LinkConfig(uplink_topk=0.25)), "compression"),
    (dict(train=TEC(uplink_int8=True)), "compression"),
])
def test_unported_options_raise_naming_their_slice(change, slice_name):
    """Compressed uplinks raised until the slice named `slice_name`; each
    of these configs now builds and runs, through the budget's `need_up`
    and the client update's roundtrip, and gives the reference's
    integers from the reference's initial model."""
    outcomes, p0 = [], None
    for api, ec in ((RA, REC), (TA, TEC)):
        kw = {} if api is RA else {"device": "cpu"}
        # the same config in the package's own classes
        exp = dataclasses.replace(_exp(api, ec), **{
            k: getattr(api, type(v).__name__)(**dataclasses.asdict(v))
            for k, v in change.items()})
        fed = api.Federation.from_experiment(exp, **kw)
        if p0 is None:
            p0 = jax.tree.map(np.asarray, fed.adapter.init(
                jax.random.PRNGKey(0)))
        eng = fed.engine(init_params=p0 if api is RA
                         else params_from_numpy(p0, "cpu"), **kw)
        res = eng.run()
        outcomes.append((
            None if fed.link_budget is None
            else (fed.link_budget.need_up, fed.link_budget.need_dn),
            res.num_global_updates, res.num_aggregated_gradients,
            res.idle_connections, res.total_connections,
            res.staleness_hist.tolist(), eng.ig, eng.version.tolist(),
            eng.pending.tolist(), eng.buffered_base.tolist()))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][1] > 0                     # the run aggregated


@pytest.mark.parametrize("isl,faults", [
    # these two options raised until the faults slice; they now resolve
    # the reference's trace and executed connectivity
    (True, dict(deorbit=((3, 5), (7, 12)), outages=((0, 8, 20),))),
    (False, dict(deorbit=((3, 5),), launch=((3, 30), (9, 4)),
                 rate_scale_min=0.5, rate_scale_max=0.5)),
])
def test_fault_options_resolve_the_reference_world(isl, faults):
    worlds = []
    for api, ec in ((RA, REC), (TA, TEC)):
        exp = dataclasses.replace(
            _exp(api, ec), faults=api.FaultConfig(**faults),
            isl=api.ISLConfig() if isl else None)
        kw = {} if api is RA else {"device": "cpu"}
        fed = api.Federation.from_experiment(exp, **kw)
        worlds.append((fed, fed.engine(**kw)))
    (rfed, reng), (tfed, teng) = worlds
    for f in ("alive", "station_up", "rate_scale", "revive"):
        np.testing.assert_array_equal(getattr(tfed.faults, f),
                                      getattr(rfed.faults, f), err_msg=f)
    assert (tfed.faults.reach is None) == (rfed.faults.reach is None)
    assert (tfed.isl is None) == (not isl)
    np.testing.assert_array_equal(teng.C, reng.C)
    np.testing.assert_array_equal(teng._plan_C, reng._plan_C)
    assert (teng.C < teng._plan_C).any()          # the faults bite
    assert tfed.experiment.describe() == rfed.experiment.describe()


def test_engine_rejects_unported_layers(runs):
    """None is rejected any more. A mesh (which raised until the mesh
    slice) builds a sharded engine, and one on another device type than
    the run's raises (its runs: tests/test_torch_mesh.py); a fault trace
    (which raised until the faults slice) builds the reference's executed
    and planned connectivity."""
    (rfed, _, _), (tfed, _, _), _ = runs

    class CardMesh:
        device_type = "cuda"
    with pytest.raises(ValueError, match="mesh on cuda"):
        SimulationEngine(tfed.C, tfed.adapter, tfed.scheduler,
                         device="cpu", mesh=CardMesh())
    mesh = TM.sim_mesh(device="cpu")
    try:
        eng = tfed.engine(device="cpu", mesh=mesh)
        assert eng.mesh is mesh and eng._Kp == eng.K
    finally:
        dist.destroy_process_group()
    W, K = tfed.C.shape
    cfg = dict(deorbit=((2, 4), (9, 0)), oracle=False)
    reng = RSE(rfed.C, rfed.adapter, rfed.scheduler,
               faults=RFT.fault_trace(RFT.FaultConfig(**cfg), W, K=K))
    teng = SimulationEngine(
        tfed.C, tfed.adapter, tfed.scheduler, device="cpu",
        faults=TFT.fault_trace(TFT.FaultConfig(**cfg), W, K=K))
    np.testing.assert_array_equal(teng.C, reng.C)
    assert teng._plan_C is tfed.C and not teng.C[:, 9].any()


def assert_views_of_one_buffer(engine):
    """Every leaf of `engine.params` is a view of one flat buffer at the
    engine's layout, whose elements between leaves are 0."""
    leaves = tree_leaves(engine.params)
    buf = engine.layout.buffer_of(leaves)
    assert buf is not None and buf.shape == (engine.layout.size,)
    assert all(leaf.untyped_storage().data_ptr()
               == buf.untyped_storage().data_ptr() for leaf in leaves)
    between = torch.ones(buf.shape, dtype=torch.bool)
    for off, shape in zip(engine.layout.offsets, engine.layout.shapes):
        between[off:off + int(np.prod(shape))] = False
    assert not buf[between].any()
    return buf


def test_params_are_views_of_one_buffer(runs):
    """After `prepare()` and after the run's aggregations the engine's
    parameters are views of one buffer (each aggregation's output), and
    the checkpoints it keeps are such trees too."""
    (_, reng, _), (tfed, teng, _), _ = runs
    assert teng.result.num_global_updates > 3
    after = assert_views_of_one_buffer(teng)
    fresh = tfed.engine(init_params=params_from_numpy(
        jax.tree.map(np.asarray, reng.params), "cpu"), device="cpu")
    fresh.prepare()
    before = assert_views_of_one_buffer(fresh)
    assert before.data_ptr() != after.data_ptr()
    for v in teng.store.versions():
        assert teng.layout.buffer_of(tree_leaves(teng.store.get(v))) \
            is not None
