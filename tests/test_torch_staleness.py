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
    with pytest.raises(ValueError, match="marks"):
        TS.aggregate_step(TS.bootstrap_state(3, device="cpu"), 0, True,
                          s_max=8, collect="marks")
