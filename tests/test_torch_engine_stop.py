"""`request_stop` granularity and callback consistency under a stop in the
middle of a run, for the port's two execution strategies (the port of
tests/test_engine_stop.py).

The fast loop advances whole chunks (up to 128 windows) on the device
before the per-window callbacks run on the host; a stop requested from a
callback must nevertheless freeze the run exactly one window later — the
engine replays the chunk's prefix from the saved state
(`SimulationEngine._run_chunk`). The streaming callbacks (JSONL metrics,
the checkpoint store) must be left consistent by an early stop."""
import json

import numpy as np
import pytest
import torch

from repro.core import faults as RFT
from repro.fl.engine import EngineConfig as REC
from repro.fl.engine import SimulationEngine as RSE
from repro_torch.core import faults as TFT
from repro_torch.fl.callbacks import Callback, JsonlMetricsCallback
from repro_torch.fl.engine import EngineConfig, SimulationEngine
from repro_torch.tree import tree_leaves
from tests.test_protocol_lockstep import ScriptedScheduler as RScripted
from tests.test_protocol_lockstep import _StubAdapter as RStub
from tests.test_torch_faults import Scripted, StubAdapter, budgets

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

STOPS = (0, 17, 37, 63)          # mid-chunk and boundary cases


class _StopAt(Callback):
    def __init__(self, window):
        self.window = window

    def on_window_end(self, engine, i):
        if i == self.window:
            engine.request_stop()


def _rng_world(I=96, K=6, seed=0):
    rng = np.random.default_rng(seed)
    C = rng.random((I, K)) < 0.3
    a = (rng.random(I) < 0.15).astype(np.int32)
    return C, a


def _engine(C, a, *, fast, callbacks=(), max_windows=None, **kw):
    I, K = C.shape
    return SimulationEngine(
        C, StubAdapter(K), Scripted(a, device=fast),
        EngineConfig(eval_every=1000, fast_loop=fast,
                     max_windows=max_windows), callbacks=list(callbacks),
        device="cpu", **kw)


def _same_state(eng, ref):
    for f in ("version", "pending", "buffered_base", "transfer_progress"):
        a, b = getattr(eng, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert eng.ig == ref.ig


@pytest.mark.parametrize("stop_w", STOPS)
def test_stop_latency_is_one_window_both_strategies(stop_w):
    """A stop requested at window X mid-chunk leaves the engine in exactly
    the state of a run over X+1 windows — not advanced to the chunk's
    end."""
    C, a = _rng_world()
    ref = _engine(C, a, fast=True, max_windows=stop_w + 1)
    ref.run()
    for fast in (True, False):
        eng = _engine(C, a, fast=fast, callbacks=[_StopAt(stop_w)])
        res = eng.run()
        assert res.windows_run == stop_w + 1, (fast, stop_w)
        _same_state(eng, ref)
        assert res.total_connections == int(C[:stop_w + 1].sum())
        assert (eng.loop_counts["chunks"] > 0) == fast


@pytest.mark.parametrize("stop_w", STOPS)
def test_stop_latency_with_faults_and_budget(stop_w):
    """The prefix replay composes with the fault masks and the link gate
    (the rescan reads the same padded device matrices)."""
    C, a = _rng_world(seed=3)
    I, K = C.shape
    grants = (np.random.default_rng(1).integers(1, 4, C.shape)
              * C).astype(np.int32)
    budget = budgets(C, grants, 2, 1)[1]
    trace = TFT.fault_trace(TFT.FaultConfig(deorbit=((1, 9),),
                                            launch=((1, 30),)), I, K=K)
    ref = _engine(C, a, fast=True, max_windows=stop_w + 1,
                  link_budget=budget, faults=trace)
    ref.run()
    for fast in (True, False):
        eng = _engine(C, a, fast=fast, callbacks=[_StopAt(stop_w)],
                      link_budget=budget, faults=trace)
        res = eng.run()
        assert res.windows_run == stop_w + 1
        _same_state(eng, ref)


def test_stopped_run_matches_the_reference_stop():
    """The port's stop mid-chunk lands on the reference's stopped state
    (its fast loop, same world, budget and faults; the stop callback is
    the port's, which the reference's engine calls alike)."""
    C, a = _rng_world(seed=3)
    I, K = C.shape
    grants = (np.random.default_rng(1).integers(1, 4, C.shape)
              * C).astype(np.int32)
    rb, tb = budgets(C, grants, 2, 1)
    cfg = dict(deorbit=((1, 9),), launch=((1, 30),))
    reng = RSE(C, RStub(K), RScripted(a), REC(eval_every=1000),
               callbacks=[_StopAt(41)], link_budget=rb,
               faults=RFT.fault_trace(RFT.FaultConfig(**cfg), I, K=K))
    rres = reng.run()
    teng = _engine(C, a, fast=True, callbacks=[_StopAt(41)], link_budget=tb,
                   faults=TFT.fault_trace(TFT.FaultConfig(**cfg), I, K=K))
    tres = teng.run()
    assert tres.windows_run == rres.windows_run == 42
    _same_state(teng, reng)
    assert tres.summary() == rres.summary()


def test_jsonl_stream_consistent_after_early_stop(tmp_path):
    """An early stop leaves the JSONL stream well formed: every line
    parses, one run_begin and one run_end, eval rows unique and in window
    order."""
    C, a = _rng_world()
    for fast in (True, False):
        path = tmp_path / f"metrics_{fast}.jsonl"
        eng = SimulationEngine(
            C, StubAdapter(C.shape[1]), Scripted(a, device=fast),
            EngineConfig(eval_every=8, fast_loop=fast),
            callbacks=[JsonlMetricsCallback(str(path)), _StopAt(43)],
            device="cpu")
        res = eng.run()
        assert res.windows_run == 44
        rows = [json.loads(line)
                for line in path.read_text().splitlines()]
        events = [r["event"] for r in rows]
        assert events[0] == "run_begin" and events[-1] == "run_end"
        assert events.count("run_begin") == events.count("run_end") == 1
        evals = [r["window"] for r in rows if r["event"] == "eval"]
        assert evals == [7, 15, 23, 31, 39]
        assert rows[-1]["global_updates"] == res.num_global_updates


def test_checkpoint_store_retrievable_after_early_stop():
    """The checkpoint store stays consistent across an early stop: the
    current global version is retrievable and equals the engine's params
    under both strategies."""
    C, a = _rng_world(seed=7)
    for fast in (True, False):
        eng = _engine(C, a, fast=fast, callbacks=[_StopAt(50)])
        eng.run()
        assert eng.ig > 0          # the scenario aggregated before the stop
        for got, want in zip(tree_leaves(eng.store.get(eng.ig)),
                             tree_leaves(eng.params)):
            assert torch.equal(got, want)
