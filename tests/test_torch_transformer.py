"""The port's transformer payload (`repro_torch.fl.adapters.
TransformerFmowAdapter`) against `repro.fl.adapters.TransformerFmowAdapter`:
the initial tree key for key and shape for shape, the forward and loss
with the reference's parameters carried over, a batched client update,
and a small FedBuff federation through both `Federation`s, whose integer
counters must be exactly equal.

The reference runs as its tests run it on the CPU: its ops dispatch sends
RMSNorm and attention to the jnp oracles, and its client update
differentiates those; the port runs its plain versions (the CPU side of
its kernels)."""
import jax
import numpy as np
import pytest
import torch

import repro.fl.api as RA
import repro_torch.fl.adapters as TAd
import repro_torch.fl.api as TA
from repro.core.connectivity import ConstellationSpec as RCSpec
from repro.data.fmow import FmowSpec as RSpec, SyntheticFmow as RData
from repro.data.partition import noniid_partition as r_noniid
from repro.data.pipeline import make_clients as r_clients
from repro.fl.adapters import TransformerFmowAdapter as RTf
from repro.fl.client import make_batched_client_update as r_batched
from repro.fl.engine import EngineConfig as REC
from repro_torch.core.connectivity import ConstellationSpec as TCSpec
from repro_torch.data.fmow import FmowSpec as TSpec, SyntheticFmow as TData
from repro_torch.data.partition import noniid_partition as t_noniid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl.adapters import TransformerFmowAdapter as TTf
from repro_torch.fl.client import make_batched_client_update as t_batched
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

K = 10
SMALL = {"d_model": 16, "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
         "d_ff": 32}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def _flat(tree):
    return {"/".join(p): leaf for p, leaf in _leaves(tree)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module")
def adapters():
    """Both adapters at the default width (d_model 32, 2 layers, 4 heads
    over 2 kv heads, swiglu 64) on one small world, and the reference's
    initial model as numpy."""
    kw = dict(num_train=400, num_val=100, noise=2.2)
    rdata, tdata = RData(RSpec(**kw)), TData(TSpec(**kw))
    rparts = r_noniid(rdata.train_zones, K, RCSpec(num_satellites=K),
                      days=0.5, seed=3)
    tparts = t_noniid(tdata.train_zones, K, TCSpec(num_satellites=K),
                      days=0.5, seed=3)
    ref = RTf(rdata, r_clients(rparts))
    port = TTf(tdata, t_clients(tparts), device="cpu")
    p0 = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    return ref, port, p0


@pytest.mark.parametrize("params", [{}, SMALL], ids=["default", "small"])
def test_init_tree_matches_reference(adapters, params):
    ref, port, _ = adapters
    if params:
        ref = RTf(ref.data, ref.clients, **params)
        port = TTf(port.data, port.clients, device="cpu", **params)
    rtree = ref.init(jax.random.PRNGKey(0))
    ttree = port.init(torch.Generator().manual_seed(0))
    assert _paths(ttree) == {p: tuple(a.shape)
                             for p, a in _leaves(rtree)}
    assert port.seq_len == ref.seq_len and port.cfg.d_model == \
        ref.cfg.d_model
    if not params:      # the payload's published size
        assert len(_paths(ttree)) == 13
        assert sum(int(np.prod(s)) for s in _paths(ttree).values()) == 20766


def test_apply_and_loss_match(adapters):
    ref, port, p0 = adapters
    tp = params_from_numpy(p0, "cpu")
    X, y = ref.eval_batch(64)
    rlogits = np.asarray(ref.apply(p0, X))
    tlogits = port.apply(tp, torch.tensor(np.asarray(X)))
    # one float32 forward through 2 layers: products, norms and softmax
    # summed in another order; ~1e-6 observed
    np.testing.assert_allclose(tlogits.numpy(), rlogits, rtol=1e-5,
                               atol=1e-5)
    assert port.val_loss(tp) == pytest.approx(ref.val_loss(p0), rel=1e-5)
    # accuracy counts argmax hits; a 1e-6 logit difference flips none here
    assert port.accuracy(tp) == pytest.approx(ref.accuracy(p0), abs=1e-7)


def test_apply_with_a_satellite_axis_is_apply_per_satellite(adapters):
    _, port, p0 = adapters
    r = np.random.default_rng(0)
    stacked = {k: v for k, v in params_from_numpy(jax.tree.map(
        lambda a: np.stack([a + 0.01 * m * r.standard_normal(a.shape)
                            .astype(np.float32) for m in range(3)]), p0),
        "cpu").items()}
    X = torch.tensor(r.standard_normal((3, 16, 32)).astype(np.float32))
    got = port.apply(stacked, X)
    for m in range(3):
        one = jax.tree.map(lambda a: a[m], stacked)
        # the same products batched over satellites: float32 ulps
        torch.testing.assert_close(got[m], port.apply(one, X[m]),
                                   rtol=1e-6, atol=1e-6)


def test_forward_goes_through_the_kernel_ops(adapters, monkeypatch):
    """5 RMSNorm and 2 attention calls a forward, all through the port's
    ops (on the card, the kernels)."""
    _, port, p0 = adapters
    calls = {"rmsnorm": 0, "attention": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(TAd, "rmsnorm_op", counted("rmsnorm",
                                                   TAd.rmsnorm_op))
    monkeypatch.setattr(TAd, "flash_attention_bshd",
                        counted("attention", TAd.flash_attention_bshd))
    port.apply(params_from_numpy(p0, "cpu"), port.eval_batch(8)[0])
    assert calls == {"rmsnorm": 5, "attention": 2}


def test_batched_client_update_matches(adapters):
    """4 SGD steps at lr=1.0 (the quickstart's client rate) over 3
    satellites, differentiating through RMSNorm and attention."""
    ref, port, p0 = adapters
    rb, rows = ref.client_batch_many(list(range(K)), 23, 32, 4)
    tb, trows = port.client_batch_many(list(range(K)), 23, 32, 4)
    assert rows == trows and len(rows) >= 3
    rb, tb = (tuple(b[:3] for b in batch) for batch in (rb, tb))
    ur = _flat(jax.tree.map(np.asarray, r_batched(ref, local_steps=4,
                                                  lr=1.0)(p0, rb)))
    ut = _flat(params_to_numpy(t_batched(port, local_steps=4, lr=1.0)(
        params_from_numpy(p0, "cpu"), tb)))
    assert ut.keys() == ur.keys() and len(ut) == 13
    for k in ur:
        assert ut[k].shape == ur[k].shape
        # 4 steps at lr=1.0 carry float32 rounding differences of the two
        # frameworks' products and norms forward; 3e-7 observed
        np.testing.assert_allclose(ut[k], ur[k], atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- federation

NUM_VAL = 80


def _exp(api, engine_config):
    """tests/test_compression.py's payload world without its link budget."""
    return api.FLExperiment(
        constellation=api.ConstellationConfig(num_satellites=10, days=0.25),
        dataset=api.DatasetConfig(num_train=240, num_val=NUM_VAL),
        adapter=api.AdapterConfig(kind="transformer", params=dict(SMALL)),
        scheduler=api.SchedulerConfig(kind="fedbuff", params={"M": 2}),
        train=engine_config(local_steps=2, eval_every=6,
                            stop_at_target=False))


@pytest.fixture(scope="module")
def runs():
    rfed = RA.Federation.from_experiment(_exp(RA, REC))
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    reng = rfed.engine(init_params=p0)
    rres = reng.run()
    tfed = TA.Federation.from_experiment(_exp(TA, TEC), device="cpu")
    teng = tfed.engine(init_params=params_from_numpy(p0, "cpu"),
                       device="cpu")
    tres = teng.run()
    return (reng, rres), (teng, tres)


@pytest.mark.parametrize("counter", [
    "num_global_updates", "num_aggregated_gradients", "idle_connections",
    "total_connections", "windows_run", "eval_windows"])
def test_federation_counters_exactly_equal(runs, counter):
    (_, rres), (_, tres) = runs
    assert getattr(tres, counter) == getattr(rres, counter)
    if counter == "num_global_updates":
        assert tres.num_global_updates > 3    # the run aggregated


def test_federation_histogram_and_protocol_state_exactly_equal(runs):
    (reng, rres), (teng, tres) = runs
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    assert teng.ig == reng.ig
    np.testing.assert_array_equal(teng.pending, reng.pending)
    np.testing.assert_array_equal(teng.buffered_base, reng.buffered_base)


def test_federation_metrics_and_final_model_within_tolerance(runs):
    (reng, rres), (teng, tres) = runs
    # accuracy counts argmax hits on NUM_VAL samples: allow one flip
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    # float32 rounding differences carried through the run's SGD steps
    np.testing.assert_allclose(tres.val_loss, rres.val_loss, rtol=1e-5)
    final_r = _flat(jax.tree.map(np.asarray, reng.params))
    final_t = _flat(params_to_numpy(teng.params))
    assert final_t.keys() == final_r.keys()
    for k in final_r:
        np.testing.assert_allclose(final_t[k], final_r[k], atol=1e-5,
                                   err_msg=k)



def test_federation_params_are_views_of_one_buffer(runs):
    """After the run's aggregations the transformer's 13 leaves are views
    of one flat buffer (the last aggregation's output), each on 16 bytes,
    with zeros between them."""
    (_, _), (teng, tres) = runs
    assert tres.num_global_updates > 3
    leaves = tree_leaves(teng.params)
    buf = teng.layout.buffer_of(leaves)
    assert len(leaves) == 13 and buf is not None
    assert buf.shape == (teng.layout.size,)
    assert all((leaf.data_ptr() - buf.data_ptr()) % 16 == 0
               for leaf in leaves)
    assert teng.layout.size > sum(leaf.numel() for leaf in leaves)
    between = torch.ones(buf.shape, dtype=torch.bool)
    for off, shape in zip(teng.layout.offsets, teng.layout.shapes):
        between[off:off + int(np.prod(shape))] = False
    assert not buf[between].any()
