"""The port's utility estimation (`repro_torch.core.utility`) against
`repro.core.utility`: featurization, the CART forest (fit, structure of
arrays, host and tensor walks), the MLP regressor carried across, and the
eq.-12 sample generation on the reference's own pretrain trajectory."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import utility as RU
from repro.data.fmow import FmowSpec as RFmowSpec
from repro.data.fmow import SyntheticFmow as RFmow
from repro.data.partition import iid_partition as r_iid
from repro.data.pipeline import make_clients as r_clients
from repro.fl.adapters import MlpFmowAdapter as RMlp
from repro.fl.client import make_batched_client_update as r_batched
from repro.fl.client import make_client_update as r_update
from repro.fl.fedspace_setup import pretrain_trajectory as r_pretrain
from repro_torch.core import utility as TU
from repro_torch.data.fmow import FmowSpec as TFmowSpec
from repro_torch.data.fmow import SyntheticFmow as TFmow
from repro_torch.data.partition import iid_partition as t_iid
from repro_torch.data.pipeline import make_clients as t_clients
from repro_torch.fl.adapters import MlpFmowAdapter as TMlp
from repro_torch.fl.fedspace_setup import phase1_samples
from repro_torch.weights import (forest_from_arrays,
                                 mlp_regressor_from_numpy,
                                 params_from_numpy)

ULP = float(np.finfo(np.float32).eps)


def _xy(seed, n=300, F=13):
    rng = np.random.default_rng(seed)
    X = rng.random((n, F)).astype(np.float32)
    y = (2 * X[:, 0] + np.sin(6 * X[:, 3])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y, rng


@pytest.mark.parametrize("status", [0.0, 0.7, 4.123456789])
def test_featurize_bit_equal(status):
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 30, (64, 9))
    np.testing.assert_array_equal(TU.featurize(hist, status),
                                  RU.featurize(hist, status))
    assert TU.n_features(8) == RU.n_features(8) == 13


@pytest.mark.parametrize("s_max", [2, 8])
def test_featurize_t_within_one_ulp_of_featurize_jnp(s_max):
    rng = np.random.default_rng(s_max)
    hist = rng.integers(0, 30, (256, s_max + 1))
    ref = np.asarray(RU.featurize_jnp(jnp.asarray(hist, jnp.int16), 0.7))
    got = TU.featurize_t(torch.as_tensor(hist, dtype=torch.int16),
                         0.7).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    # the integer-valued features (histogram, total) and T are exact
    h = s_max + 2
    np.testing.assert_array_equal(got[:, :h], ref[:, :h])
    np.testing.assert_array_equal(got[:, -1], ref[:, -1])
    # fresh mass and mean staleness: within 1 ulp (the fma chain is
    # XLA's, so these inputs give its bits)
    np.testing.assert_allclose(got, ref, rtol=ULP, atol=0)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed,depth,trees", [(0, 5, 15), (1, 6, 30),
                                              (2, 2, 5), (3, 8, 10)])
def test_forest_fit_gives_the_reference_arrays(seed, depth, trees):
    X, y, _ = _xy(seed)
    ref = RU.RandomForestRegressor(n_trees=trees, max_depth=depth,
                                   seed=seed).fit(X, y)
    got = TU.RandomForestRegressor(n_trees=trees, max_depth=depth,
                                   seed=seed).fit(X, y)
    ra, ga = ref.arrays(), got.arrays()
    for name in ("feature", "thresh", "left", "right", "value"):
        a, b = getattr(ga, name), getattr(ra, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ga.depth == ra.depth
    assert got.n_features_ == ref.n_features_ == 13
    np.testing.assert_array_equal(got.feature_low_, ref.feature_low_)


@pytest.mark.parametrize("seed,depth,trees", [(0, 5, 1), (1, 6, 30),
                                              (3, 8, 10)])
def test_forest_predictions_match_the_node_walk(seed, depth, trees):
    """Leaf values exact (the tensor walk lands on the node walk's leaf
    in every tree), means within 1 ulp (another order of sums over the
    trees); the numpy walk is the reference's, bit for bit."""
    X, y, rng = _xy(seed)
    ref = RU.RandomForestRegressor(n_trees=trees, max_depth=depth,
                                   seed=seed).fit(X, y)
    fa = ref.arrays()
    port = forest_from_arrays(fa.feature, fa.thresh, fa.left, fa.right,
                              fa.value, fa.depth)
    Xq = rng.random((500, 13)).astype(np.float32)
    walk = ref.predict_reference(Xq)
    np.testing.assert_array_equal(port.predict(Xq), walk)
    np.testing.assert_array_equal(port.predict_reference(Xq), walk)
    leaves = port.leaf_values_device(torch.as_tensor(Xq)).numpy()
    per_tree = np.stack([ref._predict_tree(t, Xq) for t in ref.trees])
    np.testing.assert_array_equal(leaves, per_tree)
    dev = port.predict_device(torch.as_tensor(Xq)).numpy()
    if trees == 1:
        np.testing.assert_array_equal(dev, walk)
    np.testing.assert_allclose(dev, walk, rtol=ULP,
                               atol=ULP * np.abs(walk).max())


def test_transfer_helpers_match_reference():
    X, y, rng = _xy(4)
    ref = RU.RandomForestRegressor(n_trees=8, seed=4).fit(X, y)
    port = TU.RandomForestRegressor(n_trees=8, seed=4).fit(X, y)
    assert TU.transfer_ready(port) and not TU.transfer_ready(port, s_max=4)
    Xq = rng.random((50, 13)).astype(np.float32) * 1.5
    assert TU.transfer_report(port, Xq) == RU.transfer_report(ref, Xq)


def test_mlp_regressor_carried_across_within_1e_5():
    X, y, rng = _xy(5, n=200)
    ref = RU.MLPRegressor(hidden=16, steps=60, seed=5).fit(X, y)
    port = mlp_regressor_from_numpy(jax.tree.map(np.asarray, ref.params),
                                    ref.mu, ref.sd, ref.ymu, ref.ysd)
    Xq = rng.random((100, 13)).astype(np.float32)
    want = np.asarray(ref.predict(Xq))
    np.testing.assert_allclose(port.predict(Xq), want, atol=1e-5)
    np.testing.assert_allclose(
        port.predict_device(torch.as_tensor(Xq)).numpy(), want, atol=1e-5)


def test_port_regressors_fit_a_quadratic():
    """The port's own fits (the forest's numpy CART, the MLP trained in
    PyTorch from a torch.Generator), as tests/test_scheduler_search.py::
    test_regressors_fit_quadratic holds the reference's."""
    rng = np.random.default_rng(1)
    X = rng.random((400, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5) ** 2 * 4 + X[:, 3]
    for reg in (TU.RandomForestRegressor(n_trees=20, max_depth=6, seed=1),
                TU.MLPRegressor(steps=600, seed=1)):
        reg.fit(X, y)
        pred = reg.predict(X)
        r2 = 1 - np.sum((pred - y) ** 2) / np.sum((y - y.mean()) ** 2)
        assert r2 > 0.7, type(reg).__name__
        np.testing.assert_allclose(
            reg.predict_device(torch.as_tensor(X)).numpy(), pred,
            rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# eq.-12 samples on the reference's trajectory

SAMPLES = dict(num_clients=16, n_samples=24, s_max=8, clients_per_sample=8,
               seed=5)
STEPS, LR = 2, 0.3


@pytest.fixture(scope="module")
def world():
    rdata = RFmow(RFmowSpec(num_train=800, num_val=200))
    radapter = RMlp(rdata, r_clients(r_iid(800, 16, 0)))
    tdata = TFmow(TFmowSpec(num_train=800, num_val=200))
    tadapter = TMlp(tdata, t_clients(t_iid(800, 16, 0)), device="cpu")
    traj = r_pretrain(radapter, rounds=4, clients_per_round=6,
                      local_steps=STEPS, client_lr=LR, seed=0)
    rcu = r_update(radapter, local_steps=STEPS, lr=LR)
    val_batch = radapter.eval_batch()
    ref = RU.generate_utility_samples(
        jax.random.PRNGKey(0), traj,
        lambda b, ci, r: rcu(b, ci, round_rng=int(r)),
        lambda p: radapter.val_loss(p),
        batch_fn=lambda ci, r: radapter.client_batch(ci, int(r), 32, STEPS),
        batched_update_fn=r_batched(radapter, local_steps=STEPS, lr=LR),
        batched_loss_fn=jax.jit(jax.vmap(
            lambda p: radapter.loss(p, val_batch))), **SAMPLES)
    ttraj = [params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
             for p in traj]
    return tadapter, ttraj, ref


def _close_samples(got, ref):
    (Xg, yg), (Xr, yr) = got, ref
    assert Xg.shape == Xr.shape and Xg.dtype == Xr.dtype == np.float32
    # histogram columns and total: integers, exact
    np.testing.assert_array_equal(Xg[:, :10], Xr[:, :10])
    # T (and the histogram's floats through it) and the targets: the
    # same float32 sums in other orders; relative to the loss scale
    np.testing.assert_allclose(Xg, Xr, rtol=1e-5)
    np.testing.assert_allclose(yg, yr, rtol=1e-5,
                               atol=1e-5 * np.abs(Xr[:, -1]).max())


def test_vectorized_samples_match_reference(world):
    tadapter, ttraj, ref = world
    got = phase1_samples(tadapter, ttraj, n_samples=24, s_max=8,
                         clients_per_sample=8, local_steps=STEPS,
                         client_lr=LR, seed=5)
    _close_samples(got, ref)
    assert np.abs(got[1]).max() > 0      # the samples moved the loss


def test_loop_path_matches_vectorized_and_reference(world):
    from repro_torch.fl.client import make_client_update
    tadapter, ttraj, ref = world
    cu = make_client_update(tadapter, local_steps=STEPS, lr=LR)
    loop = TU.generate_utility_samples(
        ttraj, lambda b, ci, r: cu(b, ci, round_rng=int(r)),
        lambda p: tadapter.val_loss(p), **SAMPLES)
    _close_samples(loop, ref)
    vec = phase1_samples(tadapter, ttraj, n_samples=24, s_max=8,
                         clients_per_sample=8, local_steps=STEPS,
                         client_lr=LR, seed=5)
    np.testing.assert_array_equal(loop[0][:, :10], vec[0][:, :10])
    np.testing.assert_allclose(loop[1], vec[1], rtol=1e-5,
                               atol=1e-5 * np.abs(vec[0][:, -1]).max())


def test_vectorized_samples_repeat_bit_for_bit(world):
    tadapter, ttraj, _ = world
    kw = dict(n_samples=24, s_max=8, clients_per_sample=8,
              local_steps=STEPS, client_lr=LR, seed=5)
    a, b = phase1_samples(tadapter, ttraj, **kw), \
        phase1_samples(tadapter, ttraj, **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


class _FromInit:
    """The port's adapter with the reference's initial model, so that
    `pretrain_trajectory` starts where the reference's does."""

    def __init__(self, adapter, p0):
        self._adapter, self._p0 = adapter, p0

    def __getattr__(self, name):
        return getattr(self._adapter, name)

    def init(self, generator):
        return params_from_numpy(self._p0, "cpu")


def test_pretrain_trajectory_follows_the_reference(world):
    """Same client picks, same per-client updates, the mean added each
    round: the trajectory of the reference from the same initial model,
    to float32 tolerance."""
    from repro_torch.fl.fedspace_setup import pretrain_trajectory
    tadapter, ttraj, _ = world
    p0 = {k: v.numpy() for k, v in ttraj[0].items()}
    got = pretrain_trajectory(_FromInit(tadapter, p0), rounds=4,
                              clients_per_round=6, local_steps=STEPS,
                              client_lr=LR, seed=0)
    assert len(got) == len(ttraj) == 5
    for r, (g, want) in enumerate(zip(got, ttraj)):
        for k in want:
            # 4 rounds of 6 two-step updates at lr 0.3: ~1e-7 apart
            np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                       atol=1e-5, err_msg=f"{r} {k}")
