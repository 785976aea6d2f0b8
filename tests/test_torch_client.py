"""The port's MLP adapter and client training (`repro_torch.fl.adapters`,
`repro_torch.fl.client`) against `repro.fl`: the same batches index for
index, the same loss, and the same E-step SGD updates within float
tolerance, starting from the reference's own initial model."""
import jax
import numpy as np
import pytest
import torch

from repro.data.fmow import FmowSpec as RSpec, SyntheticFmow as RData
from repro.data.partition import noniid_partition as r_noniid
from repro.data.pipeline import make_clients as r_clients
from repro.core.connectivity import ConstellationSpec as RCSpec
from repro.fl.adapters import MlpFmowAdapter as RMlp
from repro.fl.client import make_batched_client_update as r_batched
from repro.fl.client import make_client_update as r_single
from repro_torch.core.connectivity import ConstellationSpec as TCSpec
from repro_torch.data.fmow import FmowSpec as TSpec, SyntheticFmow as TData
from repro_torch.data.partition import noniid_partition as t_noniid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl.adapters import MlpFmowAdapter as TMlp
from repro_torch.fl.client import make_batched_client_update as t_batched
from repro_torch.fl.client import make_client_update as t_single
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

K = 10


@pytest.fixture(scope="module")
def adapters():
    kw = dict(num_train=600, num_val=150, noise=2.2)
    rdata, tdata = RData(RSpec(**kw)), TData(TSpec(**kw))
    rparts = r_noniid(rdata.train_zones, K, RCSpec(num_satellites=K),
                      days=0.5, seed=3)
    tparts = t_noniid(tdata.train_zones, K, TCSpec(num_satellites=K),
                      days=0.5, seed=3)
    ref = RMlp(rdata, r_clients(rparts), hidden=24)
    port = TMlp(tdata, t_clients(tparts), hidden=24, device="cpu")
    p0 = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    return ref, port, p0


def test_batches_are_index_identical(adapters):
    ref, port, _ = adapters
    ids = list(range(K))
    (rX, ry), rrows = ref.client_batch_many(ids, 17, 32, 16)
    (tX, ty), trows = port.client_batch_many(ids, 17, 32, 16)
    assert rrows == trows and len(trows) > 0
    np.testing.assert_array_equal(np.asarray(rX), tX.numpy())
    np.testing.assert_array_equal(np.asarray(ry), ty.numpy())
    for k in ids:
        rb, tb = ref.client_batch(k, 4, 32, 3), port.client_batch(k, 4, 32, 3)
        assert (rb is None) == (tb is None)
        if rb is not None:
            np.testing.assert_array_equal(np.asarray(rb[0]), tb[0].numpy())
            np.testing.assert_array_equal(np.asarray(rb[1]), tb[1].numpy())


def test_loss_and_eval_match(adapters):
    ref, port, p0 = adapters
    tp = params_from_numpy(p0, "cpu")
    X, y = ref.client_batch(2, 9, 32, 1)
    loss_r = float(ref.loss(p0, (X[0], y[0])))
    loss_t = float(port.loss(tp, (torch.tensor(np.asarray(X[0])),
                                  torch.tensor(np.asarray(y[0])))))
    # one forward pass in float32: products summed in another order
    assert loss_t == pytest.approx(loss_r, rel=1e-6)
    assert port.val_loss(tp) == pytest.approx(ref.val_loss(p0), rel=1e-6)
    # accuracy counts argmax hits; a 1e-6 logit difference flips none here
    assert port.accuracy(tp) == pytest.approx(ref.accuracy(p0), abs=1e-7)


def test_batched_client_update_matches(adapters):
    """16 SGD steps at lr=1.0, the quickstart's client settings."""
    ref, port, p0 = adapters
    ids = list(range(K))
    rb, rows = ref.client_batch_many(ids, 23, 32, 16)
    tb, _ = port.client_batch_many(ids, 23, 32, 16)
    ur = jax.tree.map(np.asarray, r_batched(ref, local_steps=16, lr=1.0)(
        p0, rb))
    ut = params_to_numpy(t_batched(port, local_steps=16, lr=1.0)(
        params_from_numpy(p0, "cpu"), tb))
    for k in ur:
        assert ut[k].shape == (len(rows),) + p0[k].shape
        # 16 steps at lr=1.0 carry float32 rounding differences of the
        # two frameworks' products forward; ~1e-6 observed, 2e-5 allowed
        np.testing.assert_allclose(ut[k], ur[k], atol=2e-5, err_msg=k)


def test_single_client_update_matches(adapters):
    ref, port, p0 = adapters
    k = next(k for k in range(K) if len(port.clients[k]))
    ur = r_single(ref, local_steps=4, lr=0.5)(p0, k, 31)
    ut = t_single(port, local_steps=4, lr=0.5)(params_from_numpy(p0, "cpu"),
                                               k, 31)
    for name in ur:
        # 4 steps at lr=0.5: float32 rounding differences only
        np.testing.assert_allclose(ut[name].numpy(), np.asarray(ur[name]),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("compression", [dict(uplink_topk=0.25),
                                         dict(uplink_int8=True)])
def test_compressed_uplink_matches_the_reference(adapters, compression):
    """The batched update with the uplink roundtrip (it raised until the
    compression slice): the port's roundtrip of the reference's raw
    updates is the reference's compressed update bit for bit; the port's
    own compressed update, written in place into `out`, is its raw update
    roundtripped, and within one quantum of the reference's."""
    from repro.fl.compression import roundtrip as r_rt
    from repro.fl.compression import roundtrip_int8 as r_rt8
    from repro_torch.fl.compression import roundtrip as t_rt
    from repro_torch.fl.compression import roundtrip_int8 as t_rt8
    ref, port, p0 = adapters
    ids = list(range(K))
    rb, rows = ref.client_batch_many(ids, 23, 32, 4)
    tb, _ = port.client_batch_many(ids, 23, 32, 4)
    kw = dict(local_steps=4, lr=1.0)
    raw_r = jax.tree.map(np.asarray, r_batched(ref, **kw)(p0, rb))
    comp_r = jax.tree.map(np.asarray, r_batched(ref, **kw, **compression)(
        p0, rb))
    tp = params_from_numpy(p0, "cpu")
    raw_t = t_batched(port, **kw)(tp, tb)
    out = {k: torch.full_like(v, 7.0) for k, v in raw_t.items()}
    got = t_batched(port, **kw, **compression)(tp, tb, out=out)
    assert all(got[k] is out[k] for k in out)      # written in place

    def port_rt(tree):
        if "uplink_topk" in compression:
            return t_rt(tree, compression["uplink_topk"])[0]
        return t_rt8(tree)[0]

    def ref_rt(tree):
        if "uplink_topk" in compression:
            return r_rt(tree, compression["uplink_topk"])[0]
        return r_rt8(tree)[0]
    for m in range(len(rows)):
        one_r = {k: v[m] for k, v in raw_r.items()}
        crossed = port_rt({k: torch.tensor(v) for k, v in one_r.items()})
        mine = port_rt({k: v[m] for k, v in raw_t.items()})
        for k in p0:
            np.testing.assert_array_equal(crossed[k].numpy(),
                                          comp_r[k][m], err_msg=k)
            np.testing.assert_array_equal(got[k][m].numpy(),
                                          mine[k].numpy(), err_msg=k)
            # the raw updates part by ~1e-6 (test above); after
            # quantization that is at most one code apart
            scale = np.abs(one_r[k]).max() / 127.0
            np.testing.assert_allclose(got[k][m].numpy(), comp_r[k][m],
                                       atol=1.01 * scale + 2e-5,
                                       err_msg=k)
    assert np.array_equal(np.asarray(ref_rt({k: v[0] for k, v in
                                             raw_r.items()})["w1"]),
                          comp_r["w1"][0])
