"""The port's batched sweep (`repro_torch.fl.sweep`) against the port's own
sequential runs and the JAX package's `sweep_engines` on the same worlds
(stub adapters, so only the protocol runs): every outcome's counters,
staleness histogram and final `version`/`pending`/`buffered` columns
equal, in input order, for odd variant counts, mixed schedulers, every
optional column present and absent (grants, fault masks, sink relaying,
gossip) and all six sweepable schedulers; and the variants a sweep cannot
run raise the reference's message."""
import numpy as np
import pytest
import torch

from repro.core import faults as RFT
from repro.core import isl as RI
from repro.core.scheduler import FedSpaceScheduler as RFedSpace
from repro.core.scheduler import make_scheduler as rmake
from repro.core.utility import RandomForestRegressor
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as RSE
from repro.fl.sweep import sweep_engines as rsweep
from repro_torch.core import faults as TFT
from repro_torch.core import isl as TI
from repro_torch.core.scheduler import FedSpaceScheduler as TFedSpace
from repro_torch.core.scheduler import make_scheduler as tmake
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.fl.engine import SimulationEngine as TSE
from repro_torch.fl.sweep import run_sweep, sweep_engines
from tests.test_protocol_lockstep import ScriptedScheduler as RScripted
from tests.test_protocol_lockstep import _StubAdapter as RStub
from tests.test_torch_faults import Scripted, StubAdapter, budgets


class _Variant:
    """One variant, buildable for both packages: a world, a scheduler
    (kind and keywords, or a script) and its optional layers."""

    def __init__(self, C, sched, *, grants=None, faults=None, isl=None,
                 **cfg):
        self.C, self.sched, self.cfg = C, sched, cfg
        self.grants, self.faults, self.isl = grants, faults, isl

    def engines(self):
        I, K = self.C.shape
        kind, kw = self.sched
        out = []
        for pkg in ("ref", "port"):
            ref = pkg == "ref"
            if kind == "scripted":
                sched = RScripted(kw["a"], device=kw.get("device", True)) \
                    if ref else Scripted(kw["a"], kw.get("device", True))
            else:
                sched = (rmake if ref else tmake)(kind, **kw)
            budget = None if self.grants is None else \
                budgets(self.C, *self.grants)[0 if ref else 1]
            trace = None if self.faults is None else \
                (RFT if ref else TFT).fault_trace(
                    (RFT if ref else TFT).FaultConfig(**self.faults), I,
                    K=K)
            isl = None if self.isl is None else self.isl[0 if ref else 1]
            if ref:
                out.append(RSE(self.C, RStub(K), sched,
                               REC(eval_every=I + 1, **self.cfg),
                               link_budget=budget, faults=trace, isl=isl))
            else:
                out.append(TSE(self.C, StubAdapter(K), sched,
                               TEC(eval_every=I + 1, **self.cfg),
                               device="cpu", link_budget=budget,
                               faults=trace, isl=isl))
        return out


def _same_outcome(eng, res, out):
    """A sequential run (either package's) against one SweepOutcome."""
    s = out.result
    np.testing.assert_array_equal(out.version, np.asarray(eng.version))
    np.testing.assert_array_equal(out.pending, np.asarray(eng.pending))
    np.testing.assert_array_equal(out.buffered,
                                  np.asarray(eng.buffered_base))
    assert out.ig == eng.ig == s.num_global_updates
    assert res.staleness_hist.tolist() == s.staleness_hist.tolist()
    for f in ("idle_connections", "total_connections", "num_global_updates",
              "num_aggregated_gradients", "windows_run", "scheme"):
        assert getattr(res, f) == getattr(s, f), f
    assert s.accuracy == [] and s.staleness_hist.dtype == np.int64


def _check(variants):
    """Port sweep == port sequential runs == reference sweep."""
    pairs = [v.engines() for v in variants]
    outs = sweep_engines([p for _, p in pairs])
    refs = rsweep([r for r, _ in pairs])
    for (_, port), out, ref in zip(pairs, outs, refs):
        res = port.run()
        _same_outcome(port, res, out)
        for f in ("version", "pending", "buffered"):
            np.testing.assert_array_equal(getattr(out, f),
                                          np.asarray(getattr(ref, f)))
        assert out.ig == ref.ig
        assert out.result.summary() == ref.result.summary()
    return outs


def _rand_world(K=10, I=48, seed=0):
    return np.random.default_rng(seed).random((I, K)) < 0.3


def _topologies(K, seed):
    """One random ring topology (planes of 1-4, grid links) for both
    packages."""
    r = np.random.default_rng(seed)
    perm = r.permutation(K)
    plane, pos = np.zeros(K, np.int32), np.zeros(K, np.int32)
    nxt, prv = np.arange(K, dtype=np.int32), np.arange(K, dtype=np.int32)
    i = p = 0
    while i < K:
        n = min(int(r.integers(1, 5)), K - i)
        ring = perm[i:i + n]
        plane[ring], pos[ring] = p, np.arange(n)
        nxt[ring], prv[ring] = np.roll(ring, -1), np.roll(ring, 1)
        i, p = i + n, p + 1
    left = r.permutation(K).astype(np.int32)
    right = r.permutation(K).astype(np.int32)
    return tuple(pkg.ISLTopology(plane=plane, pos=pos, nxt=nxt, prv=prv,
                                 left=left, right=right)
                 for pkg in (RI, TI))


def _isls(K, seed, relay_windows=2, epoch=12, cross=False):
    rt, tt = _topologies(K, seed)
    return (RI.ISL(rt, relay_windows=relay_windows, epoch=epoch,
                   cross_plane=cross),
            TI.ISL(tt, relay_windows=relay_windows, epoch=epoch,
                   cross_plane=cross))


@pytest.mark.parametrize("seed", range(5))
def test_scripted_grids_equal_sequential_and_reference(seed):
    """2-4 scripted variants of random shapes: same-shape ones share a
    group, odd ones run alone."""
    r = np.random.default_rng(seed)
    variants = []
    for _ in range(int(r.integers(2, 5))):
        K, I = int(r.integers(2, 7)), int(r.choice([8, 12]))
        C = r.random((I, K)) < 0.5
        a = (r.random(I) < 0.5).astype(np.int32)
        variants.append(_Variant(C, ("scripted", {"a": a})))
    _check(variants)


def test_odd_variant_count_mixed_schedulers():
    """5 variants interleaving scheduler kinds over one world: grouped by
    indicator, stitched back in input order."""
    C = _rand_world()
    scheds = [("fedbuff", {"M": 3}), ("sync", {}), ("fedbuff", {"M": 6}),
              ("periodic", {"period": 4}), ("async", {})]
    outs = _check([_Variant(C, s) for s in scheds])
    assert [o.result.scheme for o in outs] == \
        ["fedbuff", "sync", "fedbuff", "periodic", "async"]


def test_optional_columns_present_and_absent():
    """One batch mixing every optional-column layout — plain geometry, a
    link budget, fault masks (with recoveries and weather), sink relaying
    and gossip, with and without faults — against each variant's
    sequential run and the reference's sweep."""
    K, I = 12, 48
    C = _rand_world(K, I, seed=1)
    grants = (np.random.default_rng(2).integers(1, 4, C.shape)
              .astype(np.int32)) * C
    faults = dict(deorbit=TFT.random_churn(K, I, 0.3, seed=3) + ((2, 5),),
                  launch=((2, 20), (7, 9)))
    weather = dict(faults, rate_scale_min=0.5, rate_scale_max=1.0,
                   rate_block=4)
    isl = _isls(K, 4)
    gossip = _isls(K, 5, relay_windows=3, cross=True)
    variants = [
        _Variant(C, ("fedbuff", {"M": 4})),
        _Variant(C, ("fedbuff", {"M": 4}), grants=(grants, 2, 1)),
        _Variant(C, ("fedbuff", {"M": 4}), faults=faults),
        _Variant(C, ("fedbuff", {"M": 4}), grants=(grants, 2, 1),
                 faults=weather),
        _Variant(C, ("intra_plane", {"M": 4}), isl=isl),
        _Variant(C, ("intra_plane", {"M": 4}), isl=isl,
                 grants=(grants, 2, 1), faults=weather),
        _Variant(C, ("isl_async", {"M": 2}), isl=gossip),
        _Variant(C, ("isl_async", {"M": 2}), isl=gossip, faults=faults),
        _Variant(C, ("isl_async", {"M": 2}), isl=gossip,
                 grants=(grants, 2, 1), faults=weather),
    ]
    outs = _check(variants)
    assert len({(o.result.total_connections, o.result.idle_connections)
                for o in outs}) > 4        # the layouts run differently


@pytest.mark.parametrize("kind,kw", [
    ("sync", {}), ("async", {}), ("fedbuff", {"M": 3}),
    ("periodic", {"period": 3}), ("intra_plane", {}),
    ("isl_async", {"M": 1})])
def test_every_sweepable_scheduler(kind, kw):
    """Each sweepable policy in a group of three variants (clean, churn,
    churn under a budget with weather) in an ISL world, where the ISL
    policies relay or gossip and the others ignore it."""
    K, I = 9, 40
    C = _rand_world(K, I, seed=len(kind))
    grants = (np.random.default_rng(1).integers(1, 4, C.shape)
              .astype(np.int32)) * C
    churn = dict(deorbit=((1, 6), (4, 15)), launch=((4, 25), (8, 10)))
    isl = _isls(K, len(kind), relay_windows=1, epoch=8)
    variants = [_Variant(C, (kind, kw), isl=isl),
                _Variant(C, (kind, kw), isl=isl, faults=churn),
                _Variant(C, (kind, kw), isl=isl, grants=(grants, 1, 1),
                         faults=dict(churn, rate_scale_min=0.5,
                                     rate_scale_max=1.0)),
                _Variant(C, (kind, kw), isl=isl, faults=dict(
                    churn, deorbit=((0, 3),)))]
    _check(variants)


def test_max_windows_and_repeat_cut_the_horizon():
    C = _rand_world(6, 16, seed=7)
    _check([_Variant(C, ("fedbuff", {"M": 2}), max_windows=40,
                     repeat_connectivity=0),
            _Variant(C, ("fedbuff", {"M": 2}), max_windows=10)])


class _Subclassed(TSE):
    def on_uploads(self, i, conn):
        return super().on_uploads(i, conn)


def _message(fn, *args):
    with pytest.raises(ValueError, match="not sweepable") as e:
        fn(*args)
    return str(e.value)


def test_sequential_variants_raise_the_reference_message():
    """FedSpace's re-planning, a scheduler without a device plan,
    subclassed steps and stop-at-target runs."""
    K, I = 4, 16
    C = _rand_world(K, I, seed=4)
    cfg = dict(eval_every=I + 1)
    a = np.ones(I, np.int32)
    reg = RandomForestRegressor(n_trees=2, max_depth=3).fit(
        np.random.default_rng(0).random((30, 11)).astype(np.float32),
        np.random.default_rng(1).random(30).astype(np.float32))
    cases = [
        (RSE(C, RStub(K), RFedSpace(reg, I0=8, num_candidates=8),
             REC(**cfg)),
         TSE(C, StubAdapter(K), TFedSpace(None, I0=8, num_candidates=8),
             TEC(**cfg), device="cpu")),
        (RSE(C, RStub(K), RScripted(a, device=False), REC(**cfg)),
         TSE(C, StubAdapter(K), Scripted(a, device=False), TEC(**cfg),
             device="cpu")),
        (RSE(C, RStub(K), rmake("sync"), REC(target_acc=0.5, **cfg)),
         TSE(C, StubAdapter(K), tmake("sync"), TEC(target_acc=0.5, **cfg),
             device="cpu")),
    ]
    for ref, port in cases:
        assert _message(sweep_engines, [port]) == _message(rsweep, [ref])
    got = _message(sweep_engines, [_Subclassed(
        C, StubAdapter(K), tmake("sync"), TEC(**cfg), device="cpu")])
    assert got == ("scheduler 'sync' is not sweepable: subclassed protocol "
                   "steps — run this variant sequentially via "
                   "SimulationEngine.run()")
    # stop-at-target off: the target only records the day, so it sweeps
    eng = TSE(C, StubAdapter(K), tmake("sync"),
              TEC(target_acc=0.5, stop_at_target=False, **cfg),
              device="cpu")
    assert sweep_engines([eng])[0].result.windows_run == I


def test_one_sweep_runs_on_one_device():
    C = _rand_world(4, 8, seed=5)
    engines = [TSE(C, StubAdapter(4, device=d), tmake("sync"),
                   TEC(eval_every=9), device=d) for d in ("cpu", "meta")]
    with pytest.raises(ValueError, match="devices"):
        sweep_engines(engines)
    assert sweep_engines([]) == []


def test_run_sweep_builds_engines_on_each_worlds_device():
    class _World:
        def __init__(self, sched):
            self.device = torch.device("cpu")
            self.sched = sched

        def engine(self, device=None):
            assert device == self.device
            return TSE(_rand_world(5, 12, seed=6), StubAdapter(5),
                       self.sched, TEC(eval_every=13), device=device)

    worlds = [_World(tmake("fedbuff", M=2)), _World(tmake("async"))]
    res = run_sweep(worlds)
    for w, r in zip(worlds, res):
        seq = w.engine(device=w.device).run()
        assert seq.accuracy and r.accuracy == []   # the sweep trains nothing
        for f in ("global_updates", "aggregated_gradients",
                  "idle_connections", "total_connections", "staleness_hist"):
            assert r.summary()[f] == seq.summary()[f], f
