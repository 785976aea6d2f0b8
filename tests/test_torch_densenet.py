"""The port's DenseNet payload (`repro_torch.models.densenet`,
`DenseNetFmowAdapter`, the client update's `trainable_mask`) against
`repro.models.densenet` and `repro.fl`, at the Part-A widths of
examples/satellite_fl_train.py (growth 8, blocks (2, 2, 2), stem 16,
group norm over 8 groups, 16x16x3 images, 62 classes, the first block
frozen), from the reference's own initial model carried across as numpy:
the same logits, gradients, masks and batches, and the same masked client
updates within float32 tolerance, frozen deltas exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.fmow import FmowSpec as RSpec, SyntheticFmow as RData
from repro.data.partition import iid_partition as r_iid
from repro.data.pipeline import make_clients as r_clients
from repro.fl.adapters import DenseNetFmowAdapter as RDense
from repro.fl.client import make_batched_client_update as r_batched
from repro.fl.client import make_client_update as r_single
from repro.models import densenet as RDN
from repro_torch.data.fmow import FmowSpec as TSpec, SyntheticFmow as TData
from repro_torch.data.partition import iid_partition as t_iid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl.adapters import DenseNetFmowAdapter as TDense
from repro_torch.fl.client import make_batched_client_update as t_batched
from repro_torch.fl.client import make_client_update as t_single
from repro_torch.models import densenet as TDN
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

K = 6
WIDTHS = {"growth": 8, "blocks": (2, 2, 2), "stem": 16, "frozen_blocks": 1}
# float32 through ~12 convolutions and group norms, summed in other orders
APPLY_RTOL = 1e-5
GRAD_TOL = 1e-4
# E SGD steps carry a rounding difference forward; ~7e-7 observed after 4
UPDATE_TOL = 1e-5


@pytest.fixture(scope="module")
def adapters():
    kw = dict(num_train=300, num_val=80, noise=1.0)
    rdata, tdata = RData(RSpec(**kw)), TData(TSpec(**kw))
    ref = RDense(rdata, r_clients(r_iid(300, K, 0)), val_n=64, **WIDTHS)
    port = TDense(tdata, t_clients(t_iid(300, K, 0)), val_n=64,
                  device="cpu", **WIDTHS)
    p0 = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(5)))
    return ref, port, p0


def _perturbed(p0, m, seed):
    """m parameter trees near p0, stacked on a leading satellite axis."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.stack([
        a + 0.05 * r.standard_normal(a.shape).astype(np.float32)
        for _ in range(m)]), p0)


def test_the_port_initialises_the_reference_tree(adapters):
    ref, port, p0 = adapters
    mine = params_to_numpy(port.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(p0)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(p0)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert sum(a.size for a in jax.tree.leaves(mine)) == 12_512


def test_apply_matches_reference(adapters):
    ref, port, p0 = adapters
    X, _ = ref.eval_batch()
    want = np.asarray(ref.apply(p0, X))
    got = port.apply(params_from_numpy(p0, "cpu"),
                     torch.tensor(np.asarray(X))).numpy()
    assert got.shape == want.shape == (64, 62)
    np.testing.assert_allclose(got, want, rtol=APPLY_RTOL,
                               atol=APPLY_RTOL * np.abs(want).max())


def test_satellite_axis_apply_equals_per_satellite_apply(adapters):
    """Satellite m's channels are group m of each grouped convolution:
    the stacked forward gives each satellite its own logits."""
    _, port, p0 = adapters
    stacked = params_from_numpy(_perturbed(p0, 3, 1), "cpu")
    X = port.eval_batch()[0][:40].reshape(4, 10, 16, 16, 3)[:3]
    got = port.apply(stacked, X)
    assert got.shape == (3, 10, 62)
    for m in range(3):
        one = port.apply(tree_map(lambda t: t[m], stacked), X[m])
        torch.testing.assert_close(got[m], one, rtol=1e-6, atol=1e-6)


def test_batched_loss_on_an_expanded_batch(adapters):
    """Phase 1's batched loss: stacked params against one evaluation batch
    expanded to (M, B, H, W, 3) gives each satellite's own loss."""
    ref, port, p0 = adapters
    stacked = _perturbed(p0, 3, 2)
    X, y = port.eval_batch()
    got = port.loss(params_from_numpy(stacked, "cpu"),
                    (X.expand(3, *X.shape), y.expand(3, *y.shape)))
    rX, ry = ref.eval_batch()
    for m in range(3):
        want = float(ref.loss(jax.tree.map(lambda a: a[m], stacked),
                              (rX, ry)))
        assert abs(float(got[m]) - want) <= APPLY_RTOL * abs(want)


def test_loss_gradients_match_jax_grad(adapters):
    ref, port, p0 = adapters
    rb = ref.client_batch(0, 3, 16, 1)
    batch = (rb[0][0], rb[1][0])
    want = jax.jit(jax.grad(ref.loss))(p0, batch)
    tp = params_from_numpy(p0, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss = port.loss(tp, (torch.tensor(np.asarray(batch[0])),
                          torch.tensor(np.asarray(batch[1]))))
    assert abs(float(loss.detach()) - float(ref.loss(p0, batch))) < 1e-5
    got = torch.autograd.grad(loss, leaves)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("frozen", [0, 1, 2, 5])
def test_frozen_mask_equals_reference(adapters, frozen):
    _, _, p0 = adapters
    want = RDN.frozen_mask(p0, frozen)
    got = TDN.frozen_mask(params_from_numpy(p0, "cpu"), frozen)
    assert tree_leaves(got) == jax.tree.leaves(want)
    zeros = tree_leaves(got).count(0.0)
    assert zeros == {0: 0, 1: 10, 2: 19, 5: 25}[frozen]


def test_batches_are_index_and_image_identical(adapters):
    ref, port, _ = adapters
    ids = list(range(K))
    (rX, ry), rrows = ref.client_batch_many(ids, 17, 16, 3)
    (tX, ty), trows = port.client_batch_many(ids, 17, 16, 3)
    assert rrows == trows and len(trows) > 0
    assert tX.shape == (len(trows), 3, 16, 16, 16, 3)
    np.testing.assert_array_equal(tX.numpy(), np.asarray(rX))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(ry))
    for k in ids:
        rb, tb = ref.client_batch(k, 4, 16, 2), port.client_batch(k, 4, 16, 2)
        assert (rb is None) == (tb is None)
        if rb is not None:
            np.testing.assert_array_equal(tb[0].numpy(), np.asarray(rb[0]))
            np.testing.assert_array_equal(tb[1].numpy(), np.asarray(rb[1]))
    rv, tv = ref.eval_batch(), port.eval_batch()
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(rv[0]))
    np.testing.assert_array_equal(tv[1].numpy(), np.asarray(rv[1]))


def test_eval_metrics_match(adapters):
    ref, port, p0 = adapters
    tp = params_from_numpy(p0, "cpu")
    assert abs(port.val_loss(tp) - ref.val_loss(p0)) < 1e-5
    assert abs(port.accuracy(tp) - ref.accuracy(p0)) <= 1.0 / 64 + 1e-6


def _frozen_and_trainable(mask, tree):
    flags = jax.tree.leaves(mask)
    leaves = jax.tree.leaves(tree)
    return ([x for f, x in zip(flags, leaves) if f == 0.0],
            [x for f, x in zip(flags, leaves) if f != 0.0])


def test_masked_batched_update_matches_reference(adapters):
    """The engine's hot path: 4 SGD steps of a satellite stack with the
    frozen-block mask, against the reference's vmapped update."""
    ref, port, p0 = adapters
    mask = ref.trainable_mask(p0)
    (rX, ry), rows = ref.client_batch_many(list(range(K)), 9, 16, 4)
    want = jax.tree.map(np.asarray, r_batched(
        ref, local_steps=4, lr=0.3, trainable_mask=mask)(p0, (rX, ry)))
    tb, trows = port.client_batch_many(list(range(K)), 9, 16, 4)
    assert trows == rows
    tmask = port.trainable_mask(params_from_numpy(p0, "cpu"))
    got = params_to_numpy(t_batched(port, local_steps=4, lr=0.3,
                                    trainable_mask=tmask)(
        params_from_numpy(p0, "cpu"), tb))
    frozen, trainable = _frozen_and_trainable(mask, got)
    assert len(frozen) == 10
    for x in frozen + _frozen_and_trainable(mask, want)[0]:
        assert not x.any()                      # frozen deltas exactly 0
    assert all(np.abs(x).max() > 0 for x in trainable)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_masked_single_update_matches_reference(adapters):
    ref, port, p0 = adapters
    mask = ref.trainable_mask(p0)
    want = r_single(ref, local_steps=2, lr=0.3, trainable_mask=mask)(
        jax.tree.map(jnp.asarray, p0), 2, round_rng=5, batch_size=16)
    tp = params_from_numpy(p0, "cpu")
    got = t_single(port, local_steps=2, lr=0.3,
                   trainable_mask=port.trainable_mask(tp))(
        tp, 2, round_rng=5, batch_size=16)
    for w, g in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=UPDATE_TOL,
                                   atol=UPDATE_TOL)
    for x in _frozen_and_trainable(mask, params_to_numpy(got))[0]:
        assert not x.any()


def test_unmasked_update_trains_the_frozen_blocks(adapters):
    """Without a mask (phase 1's pretrain and samples, as in the
    reference) every leaf moves."""
    _, port, p0 = adapters
    tb, _ = port.client_batch_many(list(range(K)), 9, 16, 2)
    got = t_batched(port, local_steps=2, lr=0.3)(
        params_from_numpy(p0, "cpu"), tb)
    assert all(x.abs().max() > 0 for x in tree_leaves(got))
