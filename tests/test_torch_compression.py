"""The port's uplink compression (`repro_torch.fl.compression`, the client
update's roundtrip, the compression-aware link budget) against
`repro.fl.compression` and `repro.fl.api`, on seeded inputs: kept index
sets, int8 codes, scales, dequantized values and byte counts equal to the
reference's (the quantized values within one quantum where the inputs
themselves part by float rounding), ties at the k-th magnitude kept in
the reference's index order, the analytic bytes ratio, `need_up`, and
compressed FedBuff federations with the reference's integers (accuracies
within 1/NUM_VAL, as tests/test_torch_engine.py holds them; val losses
within COMPRESSED_LOSS_TOL, since a code flip moves a whole quantum).
Compression off — unset or an explicit 0.0 — is the uncompressed run bit
for bit, and the DenseNet's frozen leaves stay exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.fl.api as RA
import repro.fl.compression as RC
import repro_torch.fl.api as TA
import repro_torch.fl.compression as TC
from repro.fl.engine import EngineConfig as REC
from repro_torch.fl.engine import EngineConfig as TEC
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

NUM_VAL = 200
# Compressed federations' val losses: the raw updates part from the
# reference's by float32 rounding (~1e-6), and where an entry lies at a
# rounding boundary of its int8 code the two sides quantize it one code
# apart, a whole quantum (1/127 of the leaf's largest entry). Such flips
# compound over the aggregations: 7.4e-4 observed on losses near 3.7.
COMPRESSED_LOSS_TOL = 2e-3


def _tree(seed):
    """A seeded update tree: a matrix, a vector, a scalar, a list."""
    r = np.random.default_rng(seed)
    return {"w": r.normal(0, 1, (48, 17)).astype(np.float32),
            "b": r.normal(0, 0.1, (31,)).astype(np.float32),
            "s": np.float32(r.normal()),
            "blocks": [r.normal(0, 2, (5, 6)).astype(np.float32),
                       np.zeros((9,), np.float32)]}


def _pair(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.tensor, tree,
                         is_leaf=lambda x: isinstance(x, np.generic)))


@pytest.mark.parametrize("seed,k_frac", [(0, 0.1), (1, 0.25), (2, 0.5),
                                         (3, 1.0), (4, 0.01)])
def test_topk_int8_equals_the_reference(seed, k_frac):
    rt, tt = _pair(_tree(seed))
    rcomp, rbc, rbr = RC.compress_topk_int8(rt, k_frac)
    tcomp, tbc, tbr = TC.compress_topk_int8(tt, k_frac)
    assert (tbc, tbr) == (rbc, rbr)
    rl = jax.tree.leaves(rcomp, is_leaf=lambda x: isinstance(
        x, RC.CompressedLeaf))
    tl = [tcomp["b"], tcomp["blocks"][0], tcomp["blocks"][1], tcomp["s"],
          tcomp["w"]]
    for r, t in zip(rl, tl):
        assert t.shape == r.shape and t.values.dtype == torch.int8
        np.testing.assert_array_equal(t.indices.numpy(), np.asarray(
            r.indices))
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(
            r.values))
        assert t.scale.item() == float(r.scale)
    rdec, tdec = RC.decompress(rcomp), TC.decompress(tcomp)
    (rrt, rratio), (trt, tratio) = RC.roundtrip(rt, k_frac), \
        TC.roundtrip(tt, k_frac)
    assert tratio == rratio
    for got in (tdec, trt):
        for r, t in zip(jax.tree.leaves(rdec), tree_leaves(got)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    for r, t in zip(jax.tree.leaves(rrt), tree_leaves(trt)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", range(3))
def test_dense_int8_equals_the_reference(seed):
    rt, tt = _pair(_tree(seed))
    rcomp, rbc, rbr = RC.compress_int8(rt)
    tcomp, tbc, tbr = TC.compress_int8(tt)
    assert (tbc, tbr) == (rbc, rbr)
    for r, t in zip(jax.tree.leaves(rcomp, is_leaf=lambda x: isinstance(
            x, RC.QuantLeaf)),
            [tcomp["b"], tcomp["blocks"][0], tcomp["blocks"][1],
             tcomp["s"], tcomp["w"]]):
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(
            r.values))
        assert t.scale.item() == float(r.scale)
    (rrt, rratio), (trt, tratio) = RC.roundtrip_int8(rt), \
        TC.roundtrip_int8(tt)
    assert tratio == rratio
    for got in (TC.decompress_int8(tcomp), trt):
        for r, t in zip(jax.tree.leaves(rrt), tree_leaves(got)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))


@pytest.mark.parametrize("n,k_frac,planted", [
    (40, 0.1, (3, 7, 11, 20, 33)),        # 4 kept, 5 tied at the top
    (64, 0.25, tuple(range(0, 64, 3))),   # 16 kept of 22 tied
    (50, 0.2, (49, 0, 25, 1)),            # ties below a larger entry
])
def test_ties_at_the_kth_magnitude_keep_the_reference_index_set(
        n, k_frac, planted):
    x = np.random.default_rng(n).uniform(0.0, 1.0, n).astype(np.float32)
    x[list(planted)] = 1.5 * np.where(np.arange(len(planted)) % 2, -1, 1)
    if n == 50:
        x[10] = 4.0                       # one above the tied block
    r, _ = RC.roundtrip({"w": jnp.asarray(x)}, k_frac)
    t, _ = TC.roundtrip({"w": torch.tensor(x)}, k_frac)
    rows = TC.roundtrip_rows(torch.tensor(np.stack([x, x[::-1].copy()])),
                             k_frac)
    want = np.asarray(r["w"])
    np.testing.assert_array_equal(t["w"].numpy(), want)
    np.testing.assert_array_equal(rows[0].numpy(), want)
    np.testing.assert_array_equal(
        rows[1].numpy(),
        np.asarray(RC.roundtrip({"w": jnp.asarray(x[::-1].copy())},
                                k_frac)[0]["w"]))
    comp, _, _ = TC.compress_topk_int8({"w": torch.tensor(x)}, k_frac)
    rcomp, _, _ = RC.compress_topk_int8({"w": jnp.asarray(x)}, k_frac)
    np.testing.assert_array_equal(comp["w"].indices.numpy(),
                                  np.asarray(rcomp["w"].indices))


@settings(max_examples=15, deadline=None)
@given(st.integers(4, 400), st.floats(0.05, 1.0), st.integers(0, 10_000))
def test_topk_index_set_and_values_within_one_quantum(n, k_frac, seed):
    """Distinct magnitudes: the kept set is exactly the top k by |value|,
    and the dequantized kept values are within one quantum of the inputs
    (C1: the reference's own test holds them to half a quantum plus an
    absolute 1e-6, which fails at magnitudes near 150)."""
    rng = np.random.default_rng(seed)
    mags = rng.permutation(np.arange(1, n + 1)).astype(np.float32)
    vals = mags * rng.choice([-1.0, 1.0], n).astype(np.float32)
    comp, b_c, b_r = TC.compress_topk_int8({"w": torch.tensor(vals)},
                                           float(k_frac))
    leaf = comp["w"]
    k = max(1, int(n * k_frac))
    assert set(leaf.indices.tolist()) == \
        set(np.argsort(np.abs(vals))[-k:].tolist())
    assert (b_c, b_r) == (k * 5, n * 4)
    scale = leaf.scale.item()
    deq = leaf.values.numpy().astype(np.float32) * scale
    assert np.abs(deq - vals[leaf.indices.numpy()]).max() <= scale


@pytest.mark.parametrize("k_frac,int8", [(0.0, False), (None, False),
                                         (0.1, False), (0.25, True),
                                         (1.0, False), (0.0, True)])
def test_uplink_bytes_ratio_equals_the_reference(k_frac, int8):
    assert TC.uplink_bytes_ratio(k_frac, int8=int8) == \
        RC.uplink_bytes_ratio(k_frac, int8=int8)


# ---------------------------------------------------------------------------
# the link budget and the federations


def _payload(api, ec, *, topk=0.0, int8=False, train_topk=None,
             adapter=("transformer", {"d_model": 16, "num_layers": 1,
                                      "num_heads": 2, "num_kv_heads": 1,
                                      "d_ff": 32})):
    """tests/test_compression.py's payload experiment: 10 satellites, 24
    windows under a finite budget (300 MB at 20 Mbit/s, one satellite a
    station)."""
    return api.FLExperiment(
        constellation=api.ConstellationConfig(num_satellites=10, days=0.25),
        dataset=api.DatasetConfig(num_train=240, num_val=80),
        adapter=api.AdapterConfig(kind=adapter[0], params=dict(adapter[1])),
        scheduler=api.SchedulerConfig(kind="fedbuff", params={"M": 2}),
        train=ec(eval_every=12, max_windows=24, local_steps=2,
                 uplink_topk=train_topk),
        link=api.LinkConfig(uplink_topk=topk, uplink_int8=int8,
                            uplink_mbps=20.0, downlink_mbps=100.0,
                            model_mb=300.0, gs_capacity=1))


@pytest.mark.parametrize("kw,need_up", [
    ({}, 2), (dict(topk=0.25), 1), (dict(int8=True), 1),
    # the train field wins over LinkConfig's: ratio 1.25 -> 375 MB
    (dict(topk=0.25, train_topk=1.0), 3)])
def test_need_up_equals_the_reference(kw, need_up):
    r = RA.Federation.from_experiment(_payload(RA, REC, **kw)).link_budget
    t = TA.Federation.from_experiment(_payload(TA, TEC, **kw),
                                      device="cpu").link_budget
    assert (t.need_up, t.need_dn) == (r.need_up, r.need_dn) == (need_up, 1)
    np.testing.assert_array_equal(t.grants, r.grants)


def _small(api, ec, **link):
    """tests/test_torch_engine.py's FedBuff world (16 satellites, half a
    day, hidden 24, M 4) over a budget that compression loosens."""
    return api.FLExperiment(
        name="small-compressed",
        constellation=api.ConstellationConfig(num_satellites=16, days=0.5),
        dataset=api.DatasetConfig(num_train=800, num_val=NUM_VAL, noise=2.2),
        partition=api.PartitionConfig(kind="noniid"),
        adapter=api.AdapterConfig(kind="mlp", params={"hidden": 24}),
        scheduler=api.SchedulerConfig(kind="fedbuff", params={"M": 4}),
        train=ec(local_steps=4, client_lr=1.0, eval_every=8,
                 stop_at_target=False),
        link=api.LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                            model_mb=600.0, gs_capacity=2, **link))


@pytest.mark.parametrize("link", [dict(uplink_topk=0.25),
                                  dict(uplink_int8=True)])
def test_compressed_fedbuff_federation_equals_the_reference(link):
    rfed = RA.Federation.from_experiment(_small(RA, REC, **link))
    p0 = jax.tree.map(np.asarray, rfed.adapter.init(jax.random.PRNGKey(0)))
    reng = rfed.engine(init_params=p0)
    rres = reng.run()
    tfed = TA.Federation.from_experiment(_small(TA, TEC, **link),
                                         device="cpu")
    teng = tfed.engine(init_params=params_from_numpy(p0, "cpu"),
                       device="cpu")
    tres = teng.run()
    assert tfed.link_budget.need_up == rfed.link_budget.need_up
    for f in ("num_global_updates", "num_aggregated_gradients",
              "idle_connections", "total_connections", "windows_run",
              "eval_windows"):
        assert getattr(tres, f) == getattr(rres, f), f
    assert tres.num_global_updates > 3
    np.testing.assert_array_equal(tres.staleness_hist, rres.staleness_hist)
    for col in ("version", "pending", "buffered_base", "transfer_progress"):
        np.testing.assert_array_equal(getattr(teng, col),
                                      np.asarray(getattr(reng, col)),
                                      err_msg=col)
    np.testing.assert_allclose(tres.accuracy, rres.accuracy,
                               atol=1.0 / NUM_VAL + 1e-6)
    np.testing.assert_allclose(tres.val_loss, rres.val_loss,
                               atol=COMPRESSED_LOSS_TOL)


def test_compression_off_is_the_uncompressed_run():
    """`uplink_topk` unset (None), an explicit 0.0 in the train fields, and
    an explicit 0.0 in `LinkConfig` give one trajectory and one final
    model, bit for bit: compression off is the absence of the feature
    (part (a) of the `payloads` section of benchmarks/hotpaths.py)."""
    runs = []
    for kw in ({}, dict(train_topk=0.0), dict(topk=0.0, int8=False)):
        fed = TA.Federation.from_experiment(_payload(TA, TEC, **kw),
                                            device="cpu")
        eng = fed.engine(device="cpu")
        res = eng.run()
        runs.append((res.summary(), res.accuracy, res.val_loss,
                     eng.version.tolist(), eng.pending.tolist(),
                     eng.buffered_base.tolist(), eng.ig,
                     [x.numpy() for x in tree_leaves(eng.params)]))
    for other in runs[1:]:
        assert other[:7] == runs[0][:7]
        for a, b in zip(other[7], runs[0][7]):
            np.testing.assert_array_equal(a, b)
    assert runs[0][0]["global_updates"] > 0


@pytest.mark.parametrize("compression", [dict(uplink_topk=0.25),
                                         dict(uplink_int8=True)])
def test_frozen_densenet_leaves_stay_zero(compression):
    """The DenseNet's frozen leaves (stem and block 0) train to a delta of
    exactly 0, and the roundtrip keeps them 0; an all-zero row (an empty
    shard's) stays 0."""
    from repro_torch.data.fmow import FmowSpec, SyntheticFmow
    from repro_torch.data.partition import iid_partition
    from repro_torch.data.pipeline import make_clients
    from repro_torch.fl.adapters import DenseNetFmowAdapter
    from repro_torch.fl.client import make_batched_client_update
    data = SyntheticFmow(FmowSpec(num_train=120, num_val=40, noise=1.0))
    adapter = DenseNetFmowAdapter(
        data, make_clients(iid_partition(120, 4, 0)), val_n=32,
        device="cpu", growth=8, blocks=(2, 2, 2), stem=16, frozen_blocks=1)
    params = adapter.init(torch.Generator().manual_seed(0))
    mask = adapter.trainable_mask(params)
    batches, used = adapter.client_batch_many([0, 1, 2, 3], 5, 8, 2)
    update = make_batched_client_update(adapter, local_steps=2, lr=0.3,
                                        trainable_mask=mask, **compression)
    got = update(params, batches)
    flags = [float(m) if isinstance(m, float) else float(m.reshape(-1)[0])
             for m in tree_leaves(mask)]
    assert 0.0 in flags and 1.0 in flags
    for f, leaf in zip(flags, tree_leaves(got)):
        if f == 0.0:
            assert not leaf.any()
        else:
            assert leaf.abs().max() > 0
    zero = torch.zeros((2, 300))
    rt = TC.roundtrip_rows(zero, 0.25) if "uplink_topk" in compression \
        else TC.roundtrip_int8_rows(zero)
    assert not rt.any()
