"""The port's eq.-13 schedule search (`repro_torch.core.search`) against
`repro.core.search`: the numpy candidate pool bit for bit, candidate
scores within the search's 32-ulp tie band with the reference's forest
carried across (`repro_torch.weights.forest_from_arrays`), the identical
selected schedule, the inferred [N_min, N_max], and the `.predict`-only
oracle path (as tests/test_scheduler_search.py and
tests/test_hotpath_parity.py drive the reference)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as RSR
from repro.core import staleness as RS
from repro_torch.core import search as TSR
from repro_torch.core import staleness as TS
from repro_torch.weights import forest_from_arrays
# a reference forest over staleness histograms at status 1.0
from test_hotpath_parity import _fit_hist_forest

# select_candidate's band: candidates within 32 float32 ulps of the best
# score count as tied
BAND = 32 * float(np.finfo(np.float32).eps)


def _carried(rf):
    fa = rf.arrays()
    return forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                              fa.value, fa.depth,
                              n_features=rf.n_features_)


def _states(K, seed):
    """(reference state, port state, ig): a random mid-run state."""
    r = np.random.default_rng(seed)
    ig = int(r.integers(0, 6))
    cols = [r.integers(-1, ig + 1, K).astype(np.int32) for _ in range(3)]
    return (RS.SatState(*(jnp.asarray(c) for c in cols)),
            TS.SatState(*(torch.tensor(c) for c in cols)), ig)


@pytest.mark.parametrize("I0,n_min,n_max,R", [(8, 2, 4, 64), (24, 4, 8, 128),
                                              (5, 0, 9, 7), (16, 3, 3, 33)])
def test_candidate_pool_and_event_positions_bit_equal(I0, n_min, n_max, R):
    ref = RSR.random_candidates(np.random.default_rng(I0), I0, n_min, n_max,
                                R)
    got = TSR.random_candidates(np.random.default_rng(I0), I0, n_min, n_max,
                                R)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(TSR.event_positions(got), RSR.event_positions(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_scores_match_reference_within_the_tie_band(seed):
    rf = _fit_hist_forest(seed)
    port_rf = _carried(rf)
    r = np.random.default_rng(100 + seed)
    K, I0, R = int(r.integers(6, 17)), 8, 128
    C = r.random((I0, K)) < 0.35
    rstate, tstate, ig = _states(K, seed)
    cands = RSR.random_candidates(r, I0, 2, 5, R)
    ref = RSR.score_candidates(cands, C, rstate, ig, rf, 1.0)
    # chunks of 40 rows: chunking bounds memory and changes no score
    for chunk in (None, 40):
        got = TSR.score_candidates(cands, C, tstate, ig, port_rf, 1.0,
                                   chunk_rows=chunk)
        assert got.dtype == np.float32 and got.shape == (R,)
        np.testing.assert_allclose(got, ref, rtol=BAND,
                                   atol=BAND * np.abs(ref).max())


@pytest.mark.parametrize("seed", range(3))
def test_fedspace_search_selects_the_reference_schedule(seed):
    """Mirror of tests/test_hotpath_parity.py::
    test_fedspace_search_selects_identical_schedule: same rng seed, same
    schedule."""
    rf = _fit_hist_forest(seed)
    rng = np.random.default_rng(5 + seed)
    K, I0 = 16, 8
    C = rng.random((I0, K)) < 0.2
    ref = RSR.fedspace_search(np.random.default_rng(7), C,
                              RS.bootstrap_state(K), 0, rf, 1.0,
                              n_min=2, n_max=4, num_candidates=128)
    got = TSR.fedspace_search(np.random.default_rng(7), C,
                              TS.bootstrap_state(K, device="cpu"), 0,
                              _carried(rf), 1.0, n_min=2, n_max=4,
                              num_candidates=128)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_select_candidate_breaks_ties_lexicographically():
    cands = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]], np.int32)
    ref = RSR.select_candidate(cands, np.array([1.0, 1.0, 0.5], np.float32))
    assert TSR.select_candidate(
        cands, np.array([1.0, 1.0, 0.5], np.float32)) == ref == 1
    # one ulp apart is a tie; the lexicographic order decides
    scores = np.array([1.0, np.nextafter(np.float32(1.0), np.float32(0)),
                       0.5], np.float32)
    assert TSR.select_candidate(cands, scores) \
        == RSR.select_candidate(cands, scores) == 1


def test_infer_n_range_matches_reference():
    """Mirror of tests/test_hotpath_parity.py::
    test_infer_n_range_matches_loop_reference, against the reference's
    vectorized function with the forest carried across."""
    rf = _fit_hist_forest(1)
    port_rf = _carried(rf)
    rng = np.random.default_rng(2)
    upws = [0.5, 2.0, 5.0, 11.0] + list(rng.uniform(0.1, 20.0, 20))
    for upw in upws:
        for K in (None, 16):
            assert TSR.infer_n_range(port_rf, upw, 24, 1.0, K=K) \
                == RSR.infer_n_range(rf, upw, 24, 1.0, K=K), (upw, K)


class _FreshGradientOracle:
    """True utility: fresh gradients help, stale ones hurt (the oracle of
    tests/test_scheduler_search.py; `.predict` only)."""

    def predict(self, X):
        hist = X[:, :-2]
        s = np.arange(hist.shape[1])
        return (hist * (1.0 - 0.4 * s)).sum(axis=1)


def test_predict_only_oracle_path_matches_reference():
    """A regressor without `predict_device` takes the full-histogram host
    path: the same histograms as the reference's, the same float64
    products, so the same scores; and the search beats the random
    average, as tests/test_scheduler_search.py::
    test_search_beats_random_average asserts of the reference."""
    rng = np.random.default_rng(2)
    K, I0 = 30, 24
    C = rng.random((I0, K)) < 0.25
    cands = RSR.random_candidates(rng, I0, 4, 8, 128)
    ref = RSR.score_candidates(cands, C, RS.bootstrap_state(K), 0,
                               _FreshGradientOracle(), status=1.0)
    got = TSR.score_candidates(cands, C, TS.bootstrap_state(K, device="cpu"),
                               0, _FreshGradientOracle(), status=1.0)
    np.testing.assert_array_equal(got, ref)
    assert got.max() > np.mean(got) + 1e-6


def test_narrow_state_keeps_int16_until_the_horizon_overflows():
    st = TS.bootstrap_state(4, device="cpu")
    narrow, ig = TSR._narrow_state(st, 3, 24)
    assert all(x.dtype == torch.int16 for x in narrow[:3]) \
        and ig.dtype == torch.int16
    wide, ig = TSR._narrow_state(st, 32_760, 24)
    assert all(x.dtype == torch.int32 for x in wide[:3]) \
        and ig.dtype == torch.int32


def test_scores_equal_across_narrowing():
    """The int16 rollout gives the int32 rollout's marks: scores from a
    state whose versions overflow int16's horizon check equal the narrow
    ones after shifting every version by the same amount."""
    rf = _carried(_fit_hist_forest(0))
    r = np.random.default_rng(9)
    K, I0 = 12, 8
    C = r.random((I0, K)) < 0.4
    _, st, ig = _states(K, 3)
    cands = TSR.random_candidates(r, I0, 2, 4, 64)
    narrow = TSR.score_candidates(cands, C, st, ig, rf, 1.0)
    shift = 40_000
    wide_st = TS.SatState(*(torch.where(x >= 0, x + shift, x)
                            for x in st[:3]))
    wide = TSR.score_candidates(cands, C, wide_st, ig + shift, rf, 1.0)
    np.testing.assert_array_equal(wide, narrow)


def test_link_and_mesh_raise_naming_their_slice():
    st = TS.bootstrap_state(4, device="cpu")
    C = np.ones((4, 4), bool)
    cands = np.ones((2, 4), np.int32)
    with pytest.raises(NotImplementedError, match="A.10"):
        TSR.score_candidates(cands, C, st, 0, _FreshGradientOracle(), 1.0,
                             mesh=object())
    # the link gate is ported: the zero-need gate scores as no gate
    gated = TSR.score_candidates(
        cands, C, TS.bootstrap_state(4, progress=True, device="cpu"), 0,
        _FreshGradientOracle(), 1.0,
        link=TS.LinkGate(np.ones((4, 4), np.int32), 0, 0))
    np.testing.assert_array_equal(
        gated, TSR.score_candidates(cands, C, st, 0, _FreshGradientOracle(),
                                    1.0))
