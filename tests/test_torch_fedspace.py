"""A whole FedSpace run of the port (`FedSpaceScheduler` in
`repro_torch.core.scheduler`, through the per-window engine) against the
reference's `SimulationEngine` on the tiny world of
tests/test_hotpath_parity.py, with one histogram-only forest handed to
both (its training features all carry status 1.0, so no split is on T and
a schedule cannot depend on the float val loss) and the reference's
initial model: every integer counter, the staleness histogram and every
re-plan's schedule exact, accuracies within the FedBuff parity test's
tolerance. Plus FedSpace through `Federation.from_experiment` (phase 1 on
the CPU) and the options that are not ported."""
import jax
import numpy as np
import pytest

import repro.core.scheduler as RSched
import repro_torch.core.search as TSR
import repro_torch.core.staleness as TS
import repro_torch.fl.api as TA
from repro.core import connectivity as RCN
from repro.core.scheduler import FedSpaceScheduler as RFedSpace
from repro.data.fmow import FmowSpec as RFmowSpec
from repro.data.fmow import SyntheticFmow as RFmow
from repro.data.partition import iid_partition as r_iid
from repro.data.pipeline import make_clients as r_clients
from repro.fl.adapters import MlpFmowAdapter as RMlp
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as REngine
from repro_torch.core import connectivity as TCN
from repro_torch.core.scheduler import FedSpaceScheduler as TFedSpace
from repro_torch.data.fmow import FmowSpec as TFmowSpec
from repro_torch.data.fmow import SyntheticFmow as TFmow
from repro_torch.data.partition import iid_partition as t_iid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl.adapters import MlpFmowAdapter as TMlp
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine as TEngine
from repro_torch.weights import forest_from_arrays, params_from_numpy
# a reference forest over staleness histograms at status 1.0: no split on T
from test_hotpath_parity import _fit_hist_forest

NUM_VAL = 200
RUN = dict(eval_every=8, max_windows=64, stop_at_target=False)


def _recording(monkeypatch, module, name, log):
    """Wrap `module.name` (a fedspace_search) to append each re-plan's
    schedule to `log`."""
    inner = getattr(module, name)

    def wrapped(*args, **kw):
        out = inner(*args, **kw)
        log.append(np.asarray(out).copy())
        return out
    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    rf = _fit_hist_forest(3)
    fa = rf.arrays()
    port_rf = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                                 fa.value, fa.depth,
                                 n_features=rf.n_features_)
    C = RCN.connectivity_sets(RCN.ConstellationSpec(num_satellites=16),
                              days=1.0)
    rdata = RFmow(RFmowSpec(num_train=800, num_val=NUM_VAL))
    radapter = RMlp(rdata, r_clients(r_iid(800, 16, 0)))
    p0 = jax.tree.map(np.asarray, radapter.init(jax.random.PRNGKey(0)))
    rlog, tlog = [], []
    try:
        # the reference's scheduler calls the name it imported
        _recording(mp, RSched, "fedspace_search", rlog)
        _recording(mp, TSR, "fedspace_search", tlog)
        reng = REngine(C, radapter,
                       RFedSpace(rf, I0=8, num_candidates=64, seed=11),
                       REC(**RUN), init_params=p0)
        rres = reng.run()
        tC = TCN.connectivity_sets(TCN.ConstellationSpec(num_satellites=16),
                                   days=1.0)
        tadapter = TMlp(TFmow(TFmowSpec(num_train=800, num_val=NUM_VAL)),
                        t_clients(t_iid(800, 16, 0)), device="cpu")
        teng = TEngine(tC, tadapter,
                       TFedSpace(port_rf, I0=8, num_candidates=64, seed=11),
                       TEC(**RUN), init_params=params_from_numpy(p0, "cpu"),
                       device="cpu")
        tres = teng.run()
    finally:
        mp.undo()
    return (reng, rres, rlog), (teng, tres, tlog)


@pytest.mark.parametrize("counter", [
    "num_global_updates", "num_aggregated_gradients", "idle_connections",
    "total_connections", "windows_run", "eval_windows"])
def test_fedspace_run_counters_exactly_equal(runs, counter):
    (_, rres, _), (_, tres, _) = runs
    assert getattr(tres, counter) == getattr(rres, counter)
    if counter == "num_global_updates":
        assert tres.num_global_updates > 3      # the run aggregated
    assert tres.scheme == rres.scheme == "fedspace"


def test_fedspace_run_histogram_and_state_exactly_equal(runs):
    (reng, rres, _), (teng, tres, _) = runs
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    assert teng.ig == reng.ig
    np.testing.assert_array_equal(teng.version, reng.version)
    np.testing.assert_array_equal(teng.pending, reng.pending)
    np.testing.assert_array_equal(teng.buffered_base, reng.buffered_base)


def test_every_replan_picks_the_reference_schedule(runs):
    (_, _, rlog), (_, _, tlog) = runs
    assert len(tlog) == len(rlog) == RUN["max_windows"] // 8
    for j, (a, b) in enumerate(zip(tlog, rlog)):
        np.testing.assert_array_equal(a, b, err_msg=f"re-plan {j}")
    assert len({a.tobytes() for a in tlog}) > 1   # schedules vary


def test_fedspace_run_accuracy_within_tolerance(runs):
    (_, rres, _), (_, tres, _) = runs
    # as tests/test_torch_engine.py: one argmax flip on NUM_VAL samples,
    # float32 rounding carried through the aggregations
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, atol=1e-4)


# --------------------------------------------------------------------------
# through Federation.from_experiment

SETUP = {"pretrain_rounds": 3, "clients_per_round": 4, "utility_samples": 16,
         "local_steps": 2, "client_lr": 0.5, "clients_per_sample": 6}


def _fedspace_exp(**params):
    return TA.FLExperiment(
        name="tiny-fedspace",
        constellation=TA.ConstellationConfig(num_satellites=12, days=0.5),
        dataset=TA.DatasetConfig(num_train=600, num_val=100, noise=2.2),
        partition=TA.PartitionConfig(kind="noniid"),
        adapter=TA.AdapterConfig(kind="mlp", params={"hidden": 16}),
        scheduler=TA.SchedulerConfig(
            kind="fedspace", params={"I0": 8, "num_candidates": 32,
                                     **params}, setup=SETUP),
        train=TEC(local_steps=2, client_lr=0.5, eval_every=8))


@pytest.fixture(scope="module")
def fed():
    return TA.Federation.from_experiment(_fedspace_exp(n_min=2, n_max=4),
                                         device="cpu")


def test_federation_runs_phase1_and_fills_the_diagnostics(fed):
    d = fed.scheduler_diag
    assert set(d) == {"r2_in_sample", "n", "y_mean", "y_std"}
    assert d["n"] == SETUP["utility_samples"]
    assert np.isfinite([d["r2_in_sample"], d["y_mean"], d["y_std"]]).all()
    sched = fed.scheduler
    assert isinstance(sched, TFedSpace)
    assert (sched.I0, sched.n_min, sched.n_max, sched.num_candidates,
            sched.s_max, sched.seed) == (8, 2, 4, 32, 8, 0)
    assert sched.regressor.n_features_ == 13
    res = fed.run()
    assert res.scheme == "fedspace" and res.num_global_updates > 0
    assert all(np.isfinite(res.accuracy + res.val_loss))


def test_with_scheduler_reuses_the_cached_regressor(fed):
    other = fed.with_scheduler(TA.SchedulerConfig(
        kind="fedspace", params={"I0": 6, "num_candidates": 16},
        setup=SETUP))
    assert other.scheduler.regressor is fed.scheduler.regressor
    assert other.scheduler_diag is fed.scheduler_diag
    assert other.scheduler.n_min is None       # inferred at each re-plan
    res = other.run()
    assert res.num_global_updates > 0
    # another setup fits another regressor; a baseline has no diagnostics
    assert fed.with_scheduler(TA.SchedulerConfig(
        kind="fedspace", params={"I0": 6, "num_candidates": 16},
        setup={**SETUP, "seed": 3})).scheduler.regressor \
        is not fed.scheduler.regressor
    assert fed.with_scheduler("fedbuff", M=2).scheduler_diag == {}


def test_a_ready_regressor_skips_phase1(fed):
    reg = fed.scheduler.regressor
    exp = _fedspace_exp(regressor=reg)
    ready = TA.Federation.from_experiment(exp, device="cpu")
    assert ready.scheduler.regressor is reg and ready.scheduler_diag == {}


def test_fedspace_without_a_card_raises_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.Federation.from_experiment(_fedspace_exp())


def test_service_and_link_raise_naming_their_slices(fed):
    """The replan service and the link gate raised until their slices: a
    service whose knobs differ from the scheduler's is refused with the
    reference's ValueError, a matching one routes the re-plans."""
    from repro_torch.fl.replan import ReplanService
    reg = fed.scheduler.regressor
    with pytest.raises(ValueError, match="ReplanService knobs must match"):
        TFedSpace(reg, I0=4, num_candidates=8,
                  service=ReplanService(reg, I0=8, num_candidates=8))
    svc = ReplanService(reg, I0=4, num_candidates=8)
    sched = TFedSpace(reg, I0=4, num_candidates=8, service=svc)
    eng = fed.engine(device="cpu")
    eng.prepare()
    # the link-gated search is ported: a gate slices to the planning
    # window, and a state without the progress column rolls as it is
    grants = np.ones(eng.C.shape, np.int32)
    gate = sched._window_link(TS.LinkGate(grants, 2, 1), 0)
    assert gate.grant.shape == (4, eng.K) and gate.need_up == 2
    assert sched._search_state(eng.state, 0, connectivity=eng.C,
                               link=gate) is eng.state
    assert sched.decide(0, n_in_buffer=1, K=eng.K, state=TS.bootstrap_state(
        eng.K, progress=True, device="cpu"), ig=0, connectivity=eng.C,
        status=1.0, link=TS.LinkGate(grants, 2, 1)) in (True, False)
    assert svc.stats["full"] == 1 and svc.pool.shape == (8, 4)
