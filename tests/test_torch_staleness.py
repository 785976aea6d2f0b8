"""The port's Algorithm-1 transitions (`repro_torch.core.staleness`) against
`repro.core.staleness` on random scenarios: every sub-transition and every
composed `step` must give exactly the reference's integer state, global
version, counters and histograms (as tests/test_staleness_protocol.py and
tests/test_protocol_lockstep.py drive the reference)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import staleness as RS
from repro_torch.core import staleness as TS


def _scenario(seed):
    r = np.random.default_rng(seed)
    K = int(r.integers(1, 13))
    I = int(r.integers(4, 25))
    C = r.random((I, K)) < r.uniform(0.1, 0.9)
    a = r.random(I) < r.uniform(0.1, 0.9)
    s_max = int(r.choice([2, 8]))
    kind = seed % 3
    if kind == 0:
        cols, ig = RS.bootstrap_state(K)[:3], 0
    elif kind == 1:
        cols, ig = RS.init_state(K)[:3], 0
    else:   # an arbitrary mid-run state
        ig = int(r.integers(0, 7))
        cols = tuple(r.integers(-1, ig + 1, K).astype(np.int32)
                     for _ in range(3))
    cols = tuple(np.asarray(c, np.int32) for c in cols)
    return C, a, s_max, cols, ig


def _ref_state(cols):
    return RS.SatState(*(jnp.asarray(c) for c in cols))


def _port_state(cols):
    return TS.SatState(*(torch.tensor(np.asarray(c)) for c in cols))


def _same_state(ref, port):
    for name in ("version", "pending", "buffered"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      getattr(port, name).numpy(),
                                      err_msg=name)
        assert getattr(port, name).dtype == torch.int32


def _same_info(ref, port):
    assert set(ref) == set(port)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k]), port[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("seed", range(24))
def test_transitions_match_reference_exactly(seed):
    C, a, s_max, cols, ig = _scenario(seed)
    rs, ts = _ref_state(cols), _port_state(cols)
    rig, tig = jnp.int32(ig), torch.tensor(ig, dtype=torch.int32)
    for i in range(C.shape[0]):
        conn_r, conn_t = jnp.asarray(C[i]), torch.as_tensor(C[i])
        agg = bool(a[i])
        # the composed step, from this window's starting state
        rs1, rig1, rinfo = RS.step(rs, rig, conn_r, jnp.bool_(agg),
                                   s_max=s_max)
        ts1, tig1, tinfo = TS.step(ts, tig, conn_t, agg, s_max=s_max)
        _same_state(rs1, ts1)
        assert int(rig1) == int(tig1)
        _same_info(rinfo, tinfo)
        # the three sub-transitions one by one
        rs, rup = RS.upload_step(rs, rig, conn_r)
        ts, tup = TS.upload_step(ts, tig, conn_t)
        _same_state(rs, ts)
        _same_info(rup, tup)
        _, _, none_info = TS.aggregate_step(ts, tig, agg, s_max=s_max,
                                            collect="none")
        assert none_info == {}
        rs, rig, ragg = RS.aggregate_step(rs, rig, jnp.bool_(agg),
                                          s_max=s_max)
        ts, tig, tagg = TS.aggregate_step(ts, tig, agg, s_max=s_max)
        _same_state(rs, ts)
        assert int(rig) == int(tig)
        _same_info(ragg, tagg)
        rs, rdn = RS.download_step(rs, rig, conn_r)
        ts, tdn = TS.download_step(ts, tig, conn_t)
        _same_state(rs, ts)
        _same_info(rdn, tdn)
        _same_state(rs1, ts)    # the sub-transitions compose to `step`


def test_batched_states_match_reference():
    """Leading axes broadcast as in the reference (a (R, K) stack of
    states advanced by one shared connectivity row)."""
    r = np.random.default_rng(7)
    R, K, ig = 5, 9, 3
    cols = tuple(r.integers(-1, ig + 1, (R, K)).astype(np.int32)
                 for _ in range(3))
    conn = r.random(K) < 0.5
    rs, rig, rinfo = RS.step(_ref_state(cols), jnp.int32(ig),
                             jnp.asarray(conn), jnp.bool_(True), s_max=4)
    ts, tig, tinfo = TS.step(_port_state(cols), ig, torch.as_tensor(conn),
                             True, s_max=4)
    _same_state(rs, ts)
    assert int(rig) == int(tig)
    _same_info(rinfo, tinfo)


def test_initial_states_and_compensation():
    _same_state(RS.init_state(6), TS.init_state(6, device="cpu"))
    _same_state(RS.bootstrap_state(6), TS.bootstrap_state(6, device="cpu"))
    s = np.arange(10)
    ref = np.asarray(RS.staleness_compensation(jnp.asarray(s), 0.5))
    got = TS.staleness_compensation(torch.as_tensor(s), 0.5).numpy()
    # one float32 power: within an ulp or two
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert TS.staleness_compensation(3, 0.5) == RS.staleness_compensation(
        3, 0.5)


def test_unported_collect_modes_raise():
    """Every collect mode of the reference is ported ("hist", "marks",
    "none"); any other raises, naming them, and so does a sharded
    satellite axis, naming its slice (link gates are ported:
    tests/test_torch_link_budget.py)."""
    st = TS.bootstrap_state(3, device="cpu")
    with pytest.raises(ValueError, match="'marks' or 'none'"):
        TS.aggregate_step(st, 0, True, s_max=8, collect="lite")
    conn = torch.ones(3, dtype=torch.bool)
    for call in (lambda: TS.aggregate_step(st, 0, True, s_max=8,
                                           axis_name="k"),
                 lambda: TS.step(st, 0, conn, True, s_max=8, axis_name="k"),
                 lambda: TS.upload_step(st, 0, conn, axis_name="k"),
                 lambda: TS.simulate_candidates(np.ones((2, 3), bool),
                                                np.ones((2, 2)), st, 0,
                                                axis_name="k"),
                 lambda: TS.simulate_window(np.ones((2, 3), bool),
                                            np.ones(2), st, 0,
                                            axis_name="k")):
        with pytest.raises(NotImplementedError, match="A.10"):
            call()


# --------------------------------------------------------------------------
# staleness marks and the window simulators


@pytest.mark.parametrize("seed", range(6))
def test_hist_from_marks_matches_reference(seed):
    r = np.random.default_rng(seed)
    s_max = int(r.choice([2, 8, 130]))
    shape = (int(r.integers(1, 5)), int(r.integers(1, 4)),
             int(r.integers(1, 40)))
    marks = r.integers(-1, s_max + 1, shape).astype(
        np.int8 if s_max <= 126 else np.int32)
    assert TS.marks_dtype(s_max) == (torch.int8 if s_max <= 126
                                     else torch.int32)
    for dt_r, dt_t in ((jnp.int32, torch.int32), (jnp.int16, torch.int16)):
        ref = RS.hist_from_marks(jnp.asarray(marks), s_max=s_max, dtype=dt_r)
        got = TS.hist_from_marks(torch.as_tensor(marks), s_max=s_max,
                                 dtype=dt_t)
        assert got.dtype == dt_t
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _window_scenario(seed, dtype):
    """A random window (C, candidates) and a random mid-run state of
    `dtype`, for both packages."""
    r = np.random.default_rng(1000 + seed)
    K, I0, R = int(r.integers(1, 17)), int(r.integers(1, 13)), \
        int(r.integers(1, 40))
    ig = int(r.integers(0, 9))
    cols = [r.integers(-1, ig + 1, K).astype(dtype) for _ in range(3)]
    C = r.random((I0, K)) < r.uniform(0.1, 0.9)
    cands = (r.random((R, I0)) < r.uniform(0.1, 0.9)).astype(np.int32)
    s_max = int(r.choice([2, 4, 8]))
    return (C, cands, s_max, ig,
            RS.SatState(*(jnp.asarray(c) for c in cols)),
            TS.SatState(*(torch.as_tensor(c) for c in cols)))


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("collect", ["hist", "marks", "none", "lite"])
@pytest.mark.parametrize("seed", range(3))
def test_simulate_candidates_matches_reference(seed, collect, dtype):
    """States, global versions, histograms and marks exact, in the
    state's dtype (an int16-narrowed state stays int16, marks are int8)."""
    C, cands, s_max, ig, rst, tst = _window_scenario(seed, dtype)
    kw = {"lite": True} if collect == "lite" else {"collect": collect}
    rfin, rig, rinfo = RS.simulate_candidates(
        jnp.asarray(C), jnp.asarray(cands), rst, jnp.asarray(ig, dtype),
        s_max=s_max, **kw)
    tfin, tig, tinfo = TS.simulate_candidates(
        C, cands, tst, torch.tensor(ig, dtype=tst.version.dtype),
        s_max=s_max, **kw)
    for name in ("version", "pending", "buffered"):
        a, b = np.asarray(getattr(rfin, name)), getattr(tfin, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(tig.numpy(), np.asarray(rig))
    assert tig.numpy().dtype == np.asarray(rig).dtype
    assert set(tinfo) == set(rinfo)
    for k in rinfo:
        a, b = np.asarray(rinfo[k]), tinfo[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("seed", range(3))
def test_simulate_window_and_marks_match_reference(seed):
    """One schedule rolled without a batch axis, and the marks recovered
    into the in-step histograms."""
    C, cands, s_max, ig, rst, tst = _window_scenario(seed, np.int32)
    a = cands[0]
    rfin, rig, rinfo = RS.simulate_window(jnp.asarray(C), jnp.asarray(a),
                                          rst, jnp.int32(ig), s_max=s_max)
    tfin, tig, tinfo = TS.simulate_window(C, a, tst, ig, s_max=s_max)
    _same_state(rfin, tfin)
    assert int(tig) == int(rig) and tig.dim() == 0
    assert set(tinfo) == set(rinfo)
    for k in rinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(),
                                      np.asarray(rinfo[k]), err_msg=k)
    _, _, minfo = TS.simulate_window(C, a, tst, ig, s_max=s_max,
                                     collect="marks")
    np.testing.assert_array_equal(
        TS.hist_from_marks(minfo["marks"], s_max=s_max).numpy(),
        tinfo["hist"].numpy())
