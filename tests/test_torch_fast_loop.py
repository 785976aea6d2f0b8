"""The port's chunked fast loop (`SimulationEngine._run_chunk` over
`repro_torch.fl.engine._scan_windows`) against the port's per-window host
loop and against the reference's fast loop.

On the CPU the scan runs eagerly (on a card it is a CUDA graph replay, the
`gpu` tests of tests/test_torch_device.py). The two strategies of the port
must give the same bits: every counter, the protocol state, the
accuracies and the parameters. Against the reference the integers must be
exact and the floats within the engine parity tests' tolerances
(tests/test_torch_engine.py), from the reference's initial model with
`stop_at_target=False` (ROADMAP C6). The lockstep properties of
tests/test_protocol_lockstep.py, tests/test_faults.py and tests/test_isl.py
are held between the port's two strategies under link budgets, faults and
ISL sink relaying and gossip; `_scan_windows` runs on meta tensors at every
bucket and under every mode, where any read of the device raises."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.scheduler as RSched
import repro_torch.core.search as TSR
from repro.core import connectivity as RCN
from repro.core.scheduler import FedSpaceScheduler as RFedSpace
from repro.core.scheduler import make_scheduler as r_make
from repro.data.fmow import FmowSpec as RFmowSpec
from repro.data.fmow import SyntheticFmow as RFmow
from repro.data.partition import iid_partition as r_iid
from repro.data.pipeline import make_clients as r_clients
from repro.fl.adapters import MlpFmowAdapter as RMlp
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as RSE
from repro_torch.core import connectivity as TCN
from repro_torch.core import faults as TFT
from repro_torch.core import isl as TI
from repro_torch.core import scheduler as TSC
from repro_torch.core import staleness as TS
from repro_torch.core.scheduler import FedSpaceScheduler as TFedSpace
from repro_torch.core.scheduler import make_scheduler
from repro_torch.data.fmow import FmowSpec as TFmowSpec
from repro_torch.data.fmow import SyntheticFmow as TFmow
from repro_torch.data.partition import iid_partition as t_iid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl import engine as TE
from repro_torch.fl.adapters import MlpFmowAdapter as TMlp
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine as TSE
from repro_torch.tree import tree_leaves
from repro_torch.weights import forest_from_arrays, params_from_numpy
from test_hotpath_parity import _fit_hist_forest
from tests.test_torch_faults import Scripted, StubAdapter, budgets

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

NUM_VAL = 200
# the reference's fast-loop tests (tests/test_hotpath_parity.py:340-405)
SCHEMES = {"async": ("async", {}, dict(eval_every=16, max_windows=64)),
           "fedbuff": ("fedbuff", {"M": 4},
                       dict(eval_every=16, max_windows=64)),
           "periodic": ("periodic", {"period": 3},
                        dict(eval_every=16, max_windows=64)),
           "fedspace": ("fedspace", {"I0": 8, "num_candidates": 64,
                                     "seed": 11},
                        dict(eval_every=8, max_windows=48))}
INTEGERS = ("num_global_updates", "num_aggregated_gradients",
            "idle_connections", "total_connections", "windows_run",
            "eval_windows")


@functools.lru_cache(maxsize=None)
def _worlds():
    """The tiny world of tests/test_hotpath_parity.py in both packages,
    the reference's initial model, and one histogram-only forest (no
    split on the status T) in both packages' classes."""
    rC = RCN.connectivity_sets(RCN.ConstellationSpec(num_satellites=16),
                               days=1.0)
    radapter = RMlp(RFmow(RFmowSpec(num_train=800, num_val=NUM_VAL)),
                    r_clients(r_iid(800, 16, 0)))
    tC = TCN.connectivity_sets(TCN.ConstellationSpec(num_satellites=16),
                               days=1.0)
    tadapter = TMlp(TFmow(TFmowSpec(num_train=800, num_val=NUM_VAL)),
                    t_clients(t_iid(800, 16, 0)), device="cpu")
    p0 = jax.tree.map(np.asarray, radapter.init(jax.random.PRNGKey(0)))
    rf = _fit_hist_forest(3)
    fa = rf.arrays()
    trf = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                             fa.value, fa.depth, n_features=rf.n_features_)
    return (rC, radapter, rf), (tC, tadapter, trf), p0


class _Schedules:
    """Records each re-plan's schedule of `module.fedspace_search`."""

    def __init__(self, module):
        self.module, self.log = module, []

    def __enter__(self):
        inner = self.inner = self.module.fedspace_search

        def wrapped(*args, **kw):
            out = inner(*args, **kw)
            self.log.append(np.asarray(out).copy())
            return out
        self.module.fedspace_search = wrapped
        return self

    def __exit__(self, *exc):
        self.module.fedspace_search = self.inner


def _scheduler(pkg, name, kw, forest):
    if name == "fedspace":
        cls = RFedSpace if pkg == "ref" else TFedSpace
        return cls(forest, **kw)
    return (r_make if pkg == "ref" else make_scheduler)(name, **kw)


@functools.lru_cache(maxsize=None)
def _runs(scheme):
    """The port's fast and host loops and the reference's fast loop over
    one scheme: {"fast"|"host"|"ref": (engine, result, schedules)}."""
    name, kw, cfg = SCHEMES[scheme]
    (rC, radapter, rf), (tC, tadapter, trf), p0 = _worlds()
    cfg = dict(cfg, stop_at_target=False)
    out = {}
    for label, fast in (("fast", True), ("host", False)):
        with _Schedules(TSR) as rec:
            eng = TSE(tC, tadapter, _scheduler("port", name, kw, trf),
                      TEC(fast_loop=fast, **cfg),
                      init_params=params_from_numpy(p0, "cpu"),
                      device="cpu")
            res = eng.run()
        out[label] = (eng, res, rec.log)
    with _Schedules(RSched) as rec:
        reng = RSE(rC, radapter, _scheduler("ref", name, kw, rf),
                   REC(**cfg), init_params=p0)
        rres = reng.run()
    out["ref"] = (reng, rres, rec.log)
    return out


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_fast_loop_matches_host_loop_bit_for_bit(scheme):
    """The port's two strategies: the same summary, accuracies, protocol
    state, schedules and parameters, bit for bit."""
    runs = _runs(scheme)
    (fe, fr, flog), (he, hr, hlog) = runs["fast"], runs["host"]
    assert fe._fast_ok and fe.loop_counts["chunks"] > 0
    assert not he._fast_ok and he.loop_counts["chunks"] == 0
    assert fr.num_global_updates > 2           # the run aggregated
    assert fr.summary() == hr.summary()
    assert fr.accuracy == hr.accuracy and fr.val_loss == hr.val_loss
    for f in ("version", "pending", "buffered_base"):
        np.testing.assert_array_equal(getattr(fe, f), getattr(he, f))
    assert fe.ig == he.ig
    for a, b in zip(tree_leaves(fe.params), tree_leaves(he.params)):
        assert torch.equal(a, b)
    assert len(flog) == len(hlog)
    for a, b in zip(flog, hlog):
        np.testing.assert_array_equal(a, b)
    # one read of the counters a scan; the host loop reads every window
    assert fe.loop_counts["host_reads"] < he.loop_counts["host_reads"]


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_fast_loop_matches_the_reference_fast_loop(scheme):
    """The port's fast loop against the reference's: integers exact,
    floats within the engine parity tests' tolerances."""
    runs = _runs(scheme)
    (te, tr, tlog), (re_, rr, rlog) = runs["fast"], runs["ref"]
    assert re_._fast_ok
    for f in INTEGERS:
        assert getattr(tr, f) == getattr(rr, f), f
    np.testing.assert_array_equal(tr.staleness_hist, rr.staleness_hist)
    assert te.ig == re_.ig
    for f in ("version", "pending", "buffered_base"):
        np.testing.assert_array_equal(getattr(te, f),
                                      np.asarray(getattr(re_, f)))
    assert len(tlog) == len(rlog)
    for a, b in zip(tlog, rlog):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.accuracy, rr.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tr.val_loss, rr.val_loss, atol=1e-4)
    for k, ref in re_.params.items():
        np.testing.assert_allclose(te.params[k].numpy(), np.asarray(ref),
                                   atol=1e-4, err_msg=k)


def test_fast_loop_respects_early_stop_and_target():
    """Chunks end at eval windows, so a target-accuracy stop fires at the
    same window on both strategies, and at the reference's."""
    (rC, radapter, _), (tC, tadapter, _), p0 = _worlds()
    cfg = dict(eval_every=8, max_windows=96, target_acc=0.1)
    out = []
    for fast in (True, False):
        res = TSE(tC, tadapter, make_scheduler("async"),
                  TEC(fast_loop=fast, **cfg),
                  init_params=params_from_numpy(p0, "cpu"),
                  device="cpu").run()
        out.append((res.windows_run, res.time_to_target_days,
                    res.summary()))
    assert out[0] == out[1]
    ref = RSE(rC, radapter, r_make("async"), REC(**cfg),
              init_params=p0).run()
    assert out[0][0] == ref.windows_run < 96
    assert out[0][1] == ref.time_to_target_days


# ---------------------------------------------------------------------------
# strategy selection


class _OverridingEngine(TSE):
    def on_decide(self, i, n_buf):
        return super().on_decide(i, n_buf)


@pytest.mark.parametrize("kind,params", [
    ("sync", {}), ("async", {}), ("fedbuff", {"M": 2}),
    ("periodic", {"period": 3}), ("intra_plane", {}), ("isl_async", {}),
    ("fedspace", {"I0": 8, "n_min": 1, "n_max": 3,
                  "num_candidates": 16})])
def test_default_config_takes_the_fast_loop(kind, params):
    """With the default `EngineConfig` every registered policy runs its
    windows in chunks; `fast_loop=False` and a subclass that overrides a
    step take the host loop, with the same integers."""
    (_, _, _), (tC, _, trf), _ = _worlds()
    spec = TCN.ConstellationSpec(num_satellites=16)
    isl = TI.build_isl(spec, TI.ISLConfig(epoch=8))
    out = []
    for cls, cfg in ((TSE, TEC()), (TSE, TEC(fast_loop=False)),
                     (_OverridingEngine, TEC())):
        sched = TFedSpace(trf, **params) if kind == "fedspace" \
            else make_scheduler(kind, **params)
        eng = cls(tC, StubAdapter(16), sched, cfg, max_windows=32,
                  eval_every=8, device="cpu", isl=isl)
        res = eng.run()
        out.append((eng.loop_counts["chunks"] > 0, res.num_global_updates,
                    res.idle_connections, res.total_connections,
                    res.staleness_hist.tolist(), eng.version.tolist()))
    assert [o[0] for o in out] == [True, False, False]
    assert out[0][1:] == out[1][1:] == out[2][1:]


def test_a_scheduler_without_a_plan_takes_the_host_loop():
    r = np.random.default_rng(0)
    C = r.random((24, 5)) < 0.4
    a = (r.random(24) < 0.4).astype(np.int32)
    runs = []
    for sched in (Scripted(a, device=False), Scripted(a)):
        eng = TSE(C, StubAdapter(5), sched, TEC(eval_every=25),
                  device="cpu")
        res = eng.run()
        assert eng._fast_ok
        runs.append((eng.loop_counts["chunks"], res.summary(),
                     eng.version.tolist(), eng.pending.tolist()))
    assert runs[0][0] == 0 and runs[1][0] > 0
    assert runs[0][1:] == runs[1][1:]


def test_chunk_graphs_refuse_a_device_without_cuda_graphs():
    with pytest.raises(ValueError, match="CUDA graphs"):
        TE.ChunkGraphs("cpu")


def test_fedspace_plan_holds_until_the_next_replan():
    """FedSpace's device plan: a re-plan at each I0 boundary (the same
    rng draws as `decide`'s), the schedule on the state's device, and a
    horizon ending at the next boundary."""
    (_, _, _), (tC, _, trf), _ = _worlds()
    sched = TFedSpace(trf, I0=8, num_candidates=16, seed=2)
    state = TS.bootstrap_state(16, device="cpu")
    with _Schedules(TSR) as rec:
        fn, args, horizon = sched.device_plan(
            0, K=16, state=state, ig=0, connectivity=tC, status=1.0)
        assert horizon == 8 and len(rec.log) == 1
        fn2, args2, horizon2 = sched.device_plan(
            3, K=16, state=state, ig=0, connectivity=tC, status=1.0)
        assert horizon2 == 5 and len(rec.log) == 1     # no re-plan
        sched.device_plan(8, K=16, state=state, ig=0, connectivity=tC,
                          status=1.0)
        assert len(rec.log) == 2
    assert fn is fn2 is TSC._fedspace_indicator
    np.testing.assert_array_equal(args[0].numpy(), rec.log[0])
    assert int(args[1]) == 0 and int(args2[1]) == 0
    # padding windows past the horizon read the last entry, not past it
    t = torch.tensor(40, dtype=torch.int32)
    assert TSC._fedspace_indicator(t, torch.tensor(3), args).shape == ()


# ---------------------------------------------------------------------------
# lockstep of the two strategies (the reference's property tests)


def _strategies(C, sched_of, **kw):
    """The port's fast and host loops over one world; every integer of the
    two runs equal."""
    I, K = C.shape
    out = []
    for fast in (True, False):
        eng = TSE(C, StubAdapter(K), sched_of(), TEC(eval_every=I + 1,
                                                     fast_loop=fast),
                  device="cpu", **kw)
        res = eng.run()
        assert eng._fast_ok == fast
        out.append((eng, res))
    (ef, rf), (eh, rh) = out
    for f in ("version", "pending", "buffered_base", "transfer_progress",
              "relay_units"):
        a, b = getattr(ef, f), getattr(eh, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert ef.ig == eh.ig
    assert rf.summary() == rh.summary()
    return ef, rf


@st.composite
def _linked_scenario(draw):
    K = draw(st.integers(2, 8))
    I = draw(st.integers(4, 40))
    C = np.array(draw(st.lists(st.lists(st.booleans(), min_size=K,
                                        max_size=K), min_size=I,
                               max_size=I)), bool)
    a = np.array(draw(st.lists(st.integers(0, 1), min_size=I, max_size=I)),
                 np.int32)
    grants = np.array(draw(st.lists(st.lists(st.integers(1, 3), min_size=K,
                                             max_size=K), min_size=I,
                                    max_size=I)), np.int32) * C
    return C, a, grants, draw(st.integers(0, 4)), draw(st.integers(0, 4))


@settings(max_examples=12, deadline=None)
@given(_linked_scenario())
def test_fast_host_lockstep_under_link_budgets(scn):
    C, a, grants, need_up, need_dn = scn
    _strategies(C, lambda: Scripted(a),
                link_budget=budgets(C, grants, need_up, need_dn)[1])


@settings(max_examples=12, deadline=None)
@given(_linked_scenario(), st.data())
def test_fast_host_lockstep_under_faults(scn, data):
    """Churn with revivals, with and without a budget under weather: the
    executed connections are the fault-masked ones on both strategies."""
    C, a, grants, need_up, need_dn = scn
    I, K = C.shape

    def events(n):
        return tuple((data.draw(st.integers(0, K - 1)),
                      data.draw(st.integers(0, I - 1))) for _ in range(n))
    cfg = TFT.FaultConfig(deorbit=events(data.draw(st.integers(1, 3))),
                          launch=events(data.draw(st.integers(0, 2))))
    linked = data.draw(st.booleans())
    if linked:
        cfg = dataclasses.replace(cfg, rate_scale_min=0.5,
                                  rate_scale_max=1.0, rate_block=4)
    trace = TFT.fault_trace(cfg, I, K=K)
    kw = {"faults": trace}
    if linked:
        kw["link_budget"] = budgets(C, grants, need_up, need_dn)[1]
    _, res = _strategies(C, lambda: Scripted(a), **kw)
    if not linked:
        assert res.total_connections == int((C & trace.mask).sum())


def _isl_spec(seed):
    return TCN.ConstellationSpec(
        num_satellites=10, shells=(TCN.Shell(6, 2, 550_000.0, 53.0),
                                   TCN.Shell(4, 1, 560_000.0, 97.6)),
        seed=seed)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 5), st.integers(8, 40), st.integers(0, 2),
       st.integers(4, 12), st.booleans(), st.data())
def test_fast_host_lockstep_under_isl(seed, I, relay_windows, epoch,
                                      faulted, data):
    """Sink relaying and gossip (tests/test_isl.py:284-340), with hop
    latencies, election epochs and (some draws) a fault trace."""
    C = np.array(data.draw(st.lists(st.lists(
        st.booleans(), min_size=10, max_size=10), min_size=I, max_size=I)),
        bool)
    isl = TI.ISL(topology=TI.ring_topology(_isl_spec(seed)),
                 relay_windows=relay_windows, epoch=epoch)
    kw = {"isl": isl}
    if faulted:
        kw["faults"] = TFT.fault_trace(TFT.FaultConfig(
            deorbit=((1, I // 3),), launch=((1, I // 2),)), I, K=10)
    for name, skw in (("intra_plane", {"M": 3}), ("isl_async", {})):
        eng, _ = _strategies(C, lambda: make_scheduler(name, **skw), **kw)
        assert (eng.relay_units is not None) == (name == "intra_plane")


@pytest.mark.parametrize("mode", [None, "sink", "gossip"])
def test_padding_windows_change_nothing(mode):
    """A card buckets a chunk of H windows to the next power of two; the
    padding windows (offset >= n_valid) must leave the state and the first
    H counter rows as the exact-length scan has them, which the CPU's
    eager scans run. Under a budget and a fault trace, from random
    states."""
    r = np.random.default_rng(5)
    K, W = 7, 60
    pad = TE._MAX_CHUNK

    def rows(p, dtype=bool):
        x = np.zeros((W + pad, K), dtype)
        x[:W] = r.random((W, K)) < p
        return torch.as_tensor(x)
    C = rows(0.4)
    link = (rows(0.6, np.int32) * 3, 2, 1)
    faults = (rows(0.05), rows(0.9))
    isl = {"sink": (torch.as_tensor(r.integers(0, K, K)),
                    torch.as_tensor(r.integers(0, 3, K), dtype=torch.int32)),
           "gossip": tuple(torch.as_tensor(r.integers(0, K, K))
                           for _ in range(4))
           + (torch.tensor(2, dtype=torch.int32),), None: None}[mode]

    def i32(x):
        return torch.tensor(int(x), dtype=torch.int32)
    for H in (1, 3, 5, 12, 33):
        st = TS.SatState(*(torch.as_tensor(r.integers(lo, 5, K),
                                           dtype=torch.int32)
                           for lo in (-1, -1, -1, 0)),
                         torch.as_tensor(r.integers(0, 3, K),
                                         dtype=torch.int32)
                         if mode == "sink" else None)
        i0 = int(r.integers(0, W - H + 1))
        outs = [TE._scan_windows(
            st, i32(2), C, i32(i0), i32(H), i32(3), link, isl, faults,
            indicator=TSC._fedbuff_indicator, horizon=h, isl_mode=mode)
            for h in (H, 1 << (H - 1).bit_length())]
        (s0, c0), (s1, c1) = outs
        assert torch.equal(c0, c1[:H])
        for x, y in zip(s0, s1):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the scan body reads nothing from the device


def _meta_inputs(K, W, *, linked, faulted, mode, relay):
    meta = torch.device("meta")

    def col():
        return torch.empty((K,), dtype=torch.int32, device=meta)
    state = TS.SatState(col(), col(), col(), col() if linked else None,
                        col() if relay else None)

    def i32():
        return torch.empty((), dtype=torch.int32, device=meta)
    C = torch.empty((W, K), dtype=torch.bool, device=meta)
    link = None if not linked else (
        torch.empty((W, K), dtype=torch.int32, device=meta), 2, 1)
    faults = None if not faulted else tuple(
        torch.empty((W, K), dtype=torch.bool, device=meta)
        for _ in range(2))
    idx = torch.empty((K,), dtype=torch.int64, device=meta)
    isl = {"sink": (idx, col()), "gossip": (idx, idx, idx, idx, i32()),
           None: None}[mode]
    return state, i32(), C, i32(), i32(), link, isl, faults


MODES = [(None, False, False), (None, True, True), ("sink", True, False),
         ("sink", False, True), ("gossip", True, True), ("gossip", False,
                                                         False)]


@pytest.mark.parametrize("mode,linked,faulted", MODES)
def test_scan_windows_reads_nothing_from_the_device(mode, linked, faulted):
    """On meta tensors every read of the device (`.item()`, `.tolist()`,
    `nonzero`, a boolean index, a Python `if` on a tensor) raises: the
    scan body runs at every bucket, under each ISL mode, with and without
    a budget and a fault trace, for every plan's indicator; so it is
    capturable whole into a CUDA graph."""
    with pytest.raises(Exception):
        torch.zeros((), device="meta").item()
    K = 7
    meta = torch.device("meta")
    indicators = [
        (TSC._fedbuff_indicator, torch.empty((), dtype=torch.int32,
                                             device=meta)),
        (TSC._periodic_indicator, torch.empty((), dtype=torch.int32,
                                              device=meta)),
        (TSC._fedspace_indicator, (torch.empty((8,), dtype=torch.int32,
                                               device=meta),
                                   torch.empty((), dtype=torch.int32,
                                               device=meta)))]
    for h in [1 << b for b in range(8)]:
        state, ig, C, i0, nv, link, isl, faults = _meta_inputs(
            K, 300, linked=linked, faulted=faulted, mode=mode,
            relay=mode == "sink")
        fn, args = indicators[h.bit_length() % len(indicators)]
        out, counters = TE._scan_windows(
            state, ig, C, i0, nv, args, link, isl, faults, indicator=fn,
            horizon=h, isl_mode=mode)
        assert counters.shape == (h, 4) and counters.dtype == torch.int32
        assert [x is None for x in out] == [x is None for x in state]
        assert all(x.shape == (K,) and x.dtype == torch.int32
                   for x in out if x is not None)
