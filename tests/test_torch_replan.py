"""The port's incremental replanning service (`repro_torch.fl.replan`) and
the search pieces under it (`scan_candidates`, `step_candidates`), as
tests/test_replan.py holds the reference's, plus parity with the
reference service: the delta answer equals a full rescan of the live pool
bit for bit; every invalidation reason fires; routing FedSpace through a
service changes no bit of the run; and, on the same inputs, the port's
pools, `stats`, modes and schedules equal the reference service's at every
step (the reference's forest carried across,
`repro_torch.weights.forest_from_arrays`). The guard of the delta path's
contract: a row scored alone has the bits it has when scored among many
(`predict_device`'s mean over trees and the masked event sum add in a
fixed order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import staleness as RS
from repro.core.utility import RandomForestRegressor as RRF
from repro.fl.replan import ReplanService as RService
from repro_torch.core import mesh as TM
from repro_torch.core import staleness as TS
from repro_torch.core.search import (random_candidates, scan_candidates,
                                     score_candidates, select_candidate,
                                     step_candidates)
from repro_torch.core.utility import (RandomForestRegressor, featurize,
                                      featurize_t)
from repro_torch.fl.replan import ReplanService
from repro_torch.weights import forest_from_arrays

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

S_MAX = 8


def _xy(seed=0):
    rng = np.random.default_rng(seed)
    hists = rng.integers(0, 20, (150, S_MAX + 1)).astype(np.float32)
    X = featurize(hists, 1.0)
    s = np.arange(S_MAX + 1, dtype=np.float32)
    y = ((hists * (1.0 - 0.1 * s)).sum(1)
         / np.maximum(hists.sum(1), 1.0)).astype(np.float32)
    return X, y


def _forest(seed=0, n_trees=4):
    """tests/test_replan.py's forest, fitted by the port."""
    return RandomForestRegressor(n_trees=n_trees, max_depth=4,
                                 seed=seed).fit(*_xy(seed))


def _world(K=24, T=64, p=0.3, seed=0):
    rng = np.random.default_rng(seed)
    C = rng.random((T, K)) < p
    return C, TS.bootstrap_state(K, device="cpu")


def _advance(state, ig, conn, bit):
    """Realize one window of the true protocol (the engine's view)."""
    st, g, _ = TS.step(state, ig, torch.as_tensor(conn), bool(bit),
                       s_max=S_MAX, collect="none")
    return st, int(g)


# ---------------------------------------------------------------------------
# the contract: delta == full rescan, bit for bit


@pytest.mark.parametrize("explicit_maintain", [True, False])
def test_delta_selection_bit_identical_to_full_rescan(explicit_maintain):
    rf = _forest()
    C, state = _world()
    svc = ReplanService(rf, I0=8, num_candidates=64, s_max=S_MAX, seed=7,
                        min_pool=8)
    ig, status = 0, 3.0
    modes = []
    for i in range(6):
        Cw = C[i:i + 8]
        plan = svc.replan(i, Cw, state, ig, status,
                          rng=np.random.default_rng(100 + i))
        modes.append(svc.last_mode)
        pool = svc.pool
        scores = score_candidates(pool, Cw, state, ig, rf, status,
                                  s_max=S_MAX)
        assert np.array_equal(plan, pool[select_candidate(pool, scores)])
        if explicit_maintain:
            svc.maintain()
        state, ig = _advance(state, ig, C[i], plan[0])
    assert modes[0] == "full" and "delta" in modes
    assert svc.stats["delta"] == modes.count("delta")


def test_scan_candidates_scores_match_score_candidates():
    rf = _forest()
    C, state = _world(K=16, T=16)
    cands = random_candidates(np.random.default_rng(3), 10, 2, 5, 48)
    ref = score_candidates(cands, C[:10], state, 0, rf, 2.0, s_max=S_MAX)
    for chunk in (None, 20):
        got, art = scan_candidates(cands, C[:10], state, 0, rf, 2.0,
                                   s_max=S_MAX, chunk_rows=chunk)
        assert np.array_equal(ref, got)
        win = art["win_util"].numpy()
        assert win.shape == (48, 10) and art["end_ig"].shape == (48,)
        assert art["end_state"].version.shape == (48, 16)
        assert art["state_dtype"] == np.int16
        # per-event utilities land exactly at each candidate's events
        assert np.array_equal(win != 0.0, (win * cands) != 0.0)
    # the frontier is the rollout's final state
    fs, fig, _ = TS.simulate_candidates(C[:10], cands, state, 0,
                                        s_max=S_MAX, collect="none")
    assert torch.equal(art["end_state"].version, fs.version.to(torch.int16))
    assert torch.equal(art["end_ig"], fig.to(torch.int16))


def test_step_candidates_is_the_rollouts_last_window():
    C, state = _world(K=12, T=9)
    cands = random_candidates(np.random.default_rng(4), 9, 2, 5, 30)
    fs8, fig8, _ = TS.simulate_candidates(C[:8], cands[:, :8], state, 0,
                                          s_max=S_MAX)
    fs9, fig9, infos = TS.simulate_candidates(C[:9], cands, state, 0,
                                              s_max=S_MAX, collect="marks")
    marks, st, g = step_candidates(fs8, fig8, torch.as_tensor(C[8]),
                                   torch.as_tensor(cands[:, 8]),
                                   s_max=S_MAX)
    assert torch.equal(marks, infos["marks"][:, 8])
    assert torch.equal(g, fig9)
    for a, b in zip(st[:3], fs9[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [[0], [5, 17], list(range(3, 40, 7))])
def test_rows_scored_alone_equal_rows_scored_in_a_batch(rows):
    """The delta path's guard: predictions and scores of a few rows are the
    bits those rows get among many."""
    rf = _forest(n_trees=24)
    X = torch.as_tensor(_xy(1)[0][:48])
    many = rf.predict_device(X)
    alone = rf.predict_device(X[rows])
    assert torch.equal(alone, many[rows])
    C, state = _world(K=16, T=12, seed=2)
    cands = random_candidates(np.random.default_rng(5), 12, 2, 6, 48)
    full = score_candidates(cands, C, state, 1, rf, 2.5, s_max=S_MAX)
    some = score_candidates(cands[rows], C, state, 1, rf, 2.5, s_max=S_MAX)
    # the same n_cap: pad the subset with the widest row
    wide = int(np.argmax(cands.sum(1)))
    padded = score_candidates(cands[rows + [wide]], C, state, 1, rf, 2.5,
                              s_max=S_MAX)
    assert np.array_equal(padded[:-1], full[rows])
    if cands[rows].sum(1).max() == cands.sum(1).max():
        assert np.array_equal(some, full[rows])


def test_pool_decays_and_winner_survives():
    rf = _forest()
    C, state = _world()
    svc = ReplanService(rf, I0=8, num_candidates=64, s_max=S_MAX, seed=7,
                        min_pool=4)
    ig = 0
    plan = svc.replan(0, C[0:8], state, ig, 1.0,
                      rng=np.random.default_rng(0))
    r0 = svc.pool.shape[0]
    state, ig = _advance(state, ig, C[0], plan[0])
    plan2 = svc.replan(1, C[1:9], state, ig, 1.0)
    assert svc.last_mode == "delta"
    assert svc.pool.shape[0] < r0           # survivors only
    # the previous winner's tail is still in the pool (it IS reality)
    assert any(np.array_equal(row[:7], plan[1:]) for row in svc.pool)
    assert plan2.shape == (8,)


# ---------------------------------------------------------------------------
# invalidation rules


def _primed(min_pool=4, K=24):
    """A service with a warm cache at window 0 plus the advanced state."""
    rf = _forest()
    C, state = _world(K=K)
    svc = ReplanService(rf, I0=8, num_candidates=64, s_max=S_MAX, seed=7,
                        min_pool=min_pool)
    plan = svc.replan(0, C[0:8], state, 0, 1.0,
                      rng=np.random.default_rng(0))
    state, ig = _advance(state, 0, C[0], plan[0])
    return svc, C, state, ig, plan


def test_invalidation_reasons_fire():
    svc, C, state, ig, plan = _primed()
    svc.replan(4, C[4:12], state, ig, 1.0, rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "window")
    state2, ig2 = _advance(state, ig, C[4], svc.pool[0][0])
    svc.replan(5, C[5:13], state2, ig2, 9.0, rng=np.random.default_rng(2))
    assert (svc.last_mode, svc.last_reason) == ("full", "status")


def test_invalidation_horizon_and_connectivity():
    svc, C, state, ig, _ = _primed()
    svc.replan(1, C[1:7], state, ig, 1.0, rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "horizon")
    svc2, C2, state2, ig2, _ = _primed()
    Cw = C2[1:9].copy()
    Cw[2] = ~Cw[2]                          # overlap rows differ
    svc2.replan(1, Cw, state2, ig2, 1.0, rng=np.random.default_rng(1))
    assert (svc2.last_mode, svc2.last_reason) == ("full", "connectivity")


def test_invalidation_drift():
    svc, C, state, ig, plan = _primed()
    wrong_state, wrong_ig = _advance(state, ig, C[0], 1 - int(plan[0]))
    svc.replan(1, C[1:9], wrong_state, wrong_ig, 1.0,
               rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "drift")


def test_invalidation_link_view():
    svc, C, state, ig, _ = _primed()
    K = C.shape[1]
    state = TS.SatState(state.version, state.pending, state.buffered,
                        torch.zeros(K, dtype=torch.int32), None)
    gate = TS.LinkGate(np.ones((8, K), np.int32), 1, 1)
    svc.replan(1, C[1:9], state, ig, 1.0, link=gate,
               rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "link")
    # a gated cache answers a gated delta; a changed grant row invalidates
    state, ig = _advance(state, ig, C[1], svc.pool[0][0])
    st, g, _ = TS.step(svc._cache.pre_state, svc._cache.pre_ig,
                       torch.as_tensor(C[1]), bool(svc._cache.winner_bit),
                       s_max=S_MAX, collect="none",
                       link=TS.LinkGate(torch.ones(K, dtype=torch.int32),
                                        1, 1))
    svc.replan(2, C[2:10], st, int(g), 1.0,
               link=TS.LinkGate(np.ones((8, K), np.int32), 1, 1))
    assert svc.last_mode == "delta"
    grant = np.ones((8, K), np.int32)
    grant[0, 0] = 3
    svc.replan(3, C[3:11], st, int(g), 1.0,
               link=TS.LinkGate(grant, 1, 1), rng=np.random.default_rng(3))
    assert (svc.last_mode, svc.last_reason) == ("full", "link")


def test_invalidation_narrowing():
    svc, C, state, ig, _ = _primed()
    big = 32_760                            # past the int16 guard
    svc.replan(1, C[1:9], state, big, 1.0, rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "narrowing")


def test_external_invalidate_and_pool_floor():
    svc, C, state, ig, _ = _primed(min_pool=64)
    svc.invalidate("reset")
    assert svc.pool is None
    svc.replan(1, C[1:9], state, ig, 1.0, rng=np.random.default_rng(1))
    assert (svc.last_mode, svc.last_reason) == ("full", "cold")
    assert svc.stats["invalidated"]["reset"] == 1
    state, ig = _advance(state, ig, C[1], svc.pool[0][0])
    svc.replan(2, C[2:10], state, ig, 1.0, rng=np.random.default_rng(2))
    assert (svc.last_mode, svc.last_reason) == ("full", "pool")


def test_mesh_raises_naming_its_slice():
    """It raised until the mesh slice. Under a mesh (one rank here;
    tests/test_torch_mesh.py runs 8) every answer is a sharded full
    rescan, the unsharded full answer, and nothing is cached."""
    rf = _forest()
    C = np.random.default_rng(3).random((14, 12)) < 0.3
    state = TS.bootstrap_state(12, device="cpu")
    mesh = TM.sim_mesh(device="cpu")
    try:
        svc = ReplanService(rf, I0=12, num_candidates=128, n_min=2,
                            n_max=6, min_pool=8, mesh=mesh)
        got = [svc.replan(i, C[i:i + 12], state, 0, 1.0,
                          rng=np.random.default_rng(i)) for i in range(2)]
    finally:
        dist.destroy_process_group()
    assert svc.mesh is mesh and svc.pool is None
    assert (svc.last_mode, svc.last_reason) == ("full", "mesh")
    assert svc.stats == {"full": 2, "delta": 0, "invalidated": {}}
    for i, plan in enumerate(got):
        want = ReplanService(rf, I0=12, num_candidates=128, n_min=2,
                             n_max=6, min_pool=8).replan(
            i, C[i:i + 12], state, 0, 1.0, rng=np.random.default_rng(i))
        np.testing.assert_array_equal(plan, want)


def test_transfer_ready_gatekeeps_service():
    class NoDevice:
        def predict(self, X):
            return np.zeros(len(X), np.float32)

    with pytest.raises(ValueError, match="transfer-ready"):
        ReplanService(NoDevice())
    rf = _forest()
    rf.n_features_ = 99                     # fitted at a different s_max
    with pytest.raises(ValueError, match="transfer-ready"):
        ReplanService(rf)


# ---------------------------------------------------------------------------
# the port against the reference service


@pytest.mark.parametrize("K,R,I0,min_pool,p", [(24, 64, 8, 8, 0.3),
                                               (40, 200, 12, 24, 0.15)])
def test_service_steps_equal_the_reference(K, R, I0, min_pool, p):
    """Same forest, same world, same caller rngs: at every step the pools,
    stats, modes, reasons and schedules are the reference service's."""
    rrf = RRF(n_trees=6, max_depth=4, seed=0).fit(*_xy(0))
    fa = rrf.arrays()
    trf = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                             fa.value, fa.depth, n_features=rrf.n_features_)
    C = np.random.default_rng(K).random((I0 + 12, K)) < p
    rsvc = RService(rrf, I0=I0, num_candidates=R, n_min=2, n_max=5,
                    s_max=S_MAX, seed=3, min_pool=min_pool)
    tsvc = ReplanService(trf, I0=I0, num_candidates=R, n_min=2, n_max=5,
                         s_max=S_MAX, seed=3, min_pool=min_pool)
    rstate = jax.tree.map(np.asarray, RS.bootstrap_state(K))
    tstate = TS.bootstrap_state(K, device="cpu")
    ig, status, modes = 0, 2.0, []
    for i in range(12):
        if i == 7:
            status = 2.5                    # the status invalidates
        Cw = C[i:i + I0]
        rplan = rsvc.replan(i, Cw, rstate, ig, status,
                            rng=np.random.default_rng(50 + i))
        tplan = tsvc.replan(i, Cw, tstate, ig, status,
                            rng=np.random.default_rng(50 + i))
        assert np.array_equal(tplan, rplan)
        assert np.array_equal(tsvc.pool, rsvc.pool)
        assert (tsvc.last_mode, tsvc.last_reason) == \
            (rsvc.last_mode, rsvc.last_reason)
        assert tsvc.stats == rsvc.stats
        modes.append(tsvc.last_mode)
        st, g, _ = RS.step(jax.tree.map(jnp.asarray, rstate),
                           jnp.int32(ig), jnp.asarray(C[i]),
                           jnp.asarray(bool(rplan[0])), s_max=S_MAX,
                           collect="none")
        rstate = jax.tree.map(np.asarray, st)
        tstate, tig = _advance(tstate, ig, C[i], tplan[0])
        ig = int(g)
        assert tig == ig
        np.testing.assert_array_equal(tstate.version.numpy(),
                                      rstate.version)
    assert modes.count("delta") >= 4 and modes.count("full") >= 2


# ---------------------------------------------------------------------------
# engine routing: a service-backed FedSpace run is the unrouted run


def test_fedspace_routed_through_service_is_bit_identical():
    import repro_torch.fl.api as TA
    from repro_torch.fl.engine import EngineConfig

    rf = _forest()
    W = 10
    exp = TA.FLExperiment(
        constellation=TA.ConstellationConfig(preset="starlink40",
                                             days=0.125),
        dataset=TA.DatasetConfig(num_train=240, num_val=60),
        partition=TA.PartitionConfig(kind="iid"),
        adapter=TA.AdapterConfig(kind="mlp", params={"hidden": 8}),
        scheduler=TA.SchedulerConfig(kind="fedspace",
                                     params={"regressor": rf, "I0": 5,
                                             "n_min": 1, "n_max": 2,
                                             "num_candidates": 16}),
        train=EngineConfig(max_windows=W, eval_every=W, local_steps=1,
                           batch_size=8))
    fed = TA.Federation.from_experiment(exp, device="cpu")
    plain = fed.run()
    svc = ReplanService(rf, I0=5, num_candidates=16, s_max=S_MAX, seed=0)
    routed_fed = fed.with_scheduler(TA.SchedulerConfig(
        kind="fedspace",
        params={"regressor": rf, "I0": 5, "n_min": 1, "n_max": 2,
                "num_candidates": 16, "service": svc}))
    routed = routed_fed.run()
    assert plain.accuracy == routed.accuracy
    assert plain.val_loss == routed.val_loss
    assert plain.num_global_updates == routed.num_global_updates
    assert np.array_equal(plain.staleness_hist, routed.staleness_hist)
    assert plain.replan_stats is None
    assert routed.replan_stats is not None
    assert routed.replan_stats["full"] + routed.replan_stats["delta"] > 0
    assert routed.summary()["replan_stats"] == routed.replan_stats
    # a re-run resets the scheduler, which invalidates the service's cache
    again = routed_fed.run()
    assert again.accuracy == routed.accuracy
    assert again.replan_stats["invalidated"].get("reset", 0) >= 1


def test_scheduler_service_knob_mismatch_rejected():
    from repro_torch.core.scheduler import make_scheduler
    rf = _forest()
    svc = ReplanService(rf, I0=6, num_candidates=32, s_max=S_MAX)
    with pytest.raises(ValueError, match="service"):
        make_scheduler("fedspace", regressor=rf, I0=8, num_candidates=32,
                       service=svc)


def test_delta_features_are_the_full_pipelines():
    """The delta path featurizes a (m, K) marks batch with `featurize_t`
    and predicts it: the same bits the full scan's (R*n_cap, F) batch
    gives those rows."""
    rf = _forest()
    hist = torch.as_tensor(np.random.default_rng(9).integers(
        0, 12, (40, S_MAX + 1)), dtype=torch.int16)
    X = featurize_t(hist, 1.5)
    assert torch.equal(featurize_t(hist[7:9], 1.5), X[7:9])
    assert torch.equal(rf.predict_device(X[7:9]), rf.predict_device(X)[7:9])
