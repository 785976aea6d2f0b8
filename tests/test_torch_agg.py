"""The port's eq.-4 aggregation (`repro_torch.kernels.agg`,
`repro_torch.core.aggregation`) against the JAX package: its plain
version against the reference's tensordot oracle and the Pallas kernel
run through the interpreter, the tree paths against
`repro.kernels.agg.ops`, and the weights against `repro.core.aggregation`.

On the CPU the wrapper runs the plain version; the CUDA kernel itself is
held against it on the card (tests/test_torch_device.py, chip_smoke.py).
Inputs are drawn with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as RAG
from repro.kernels.agg import ops as RO
from repro.kernels.agg.kernel import weighted_aggregate as pallas_aggregate
from repro.kernels.agg.ref import weighted_aggregate_ref
from repro_torch.core import aggregation as TAG
from repro_torch.kernels import launch_counts
from repro_torch.kernels.agg import ops as TO
from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.weights import params_from_numpy, params_to_numpy

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # the tolerances of tests/test_kernels.py: bf16 keeps ~3 significant
    # digits, so one rounding of the output may differ; in float32 the two
    # sides only sum the M products in another order
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(m, n, seed):
    r = np.random.default_rng(seed)
    upd = r.standard_normal((m, n), dtype=np.float32)
    p = r.standard_normal(n, dtype=np.float32)
    w = r.uniform(size=m).astype(np.float32)
    return p, upd, w / w.sum()


@pytest.mark.parametrize("m", [1, 7, 64, 191])
@pytest.mark.parametrize("n", [128, 5000, 40_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_agg_sweep_against_reference(m, n, dtype):
    p, upd, w = _inputs(m, n, seed=m * 100_003 + n)
    jdt, tdt = _DT[dtype]
    # both sides round the same float32 draws to the working dtype (RNE)
    got = weighted_aggregate(torch.from_numpy(p).to(tdt),
                             torch.from_numpy(upd).to(tdt),
                             torch.from_numpy(w))
    assert got.dtype == tdt and got.shape == (n,)
    got = got.float().numpy()
    jp, ju, jw = jnp.asarray(p, jdt), jnp.asarray(upd, jdt), jnp.asarray(w)
    oracle = np.asarray(weighted_aggregate_ref(jp, ju, jw), np.float32)
    pallas = np.asarray(pallas_aggregate(jp, ju, jw, block=4096,
                                         interpret=True), np.float32)
    np.testing.assert_allclose(got, oracle, **_tol(dtype))
    np.testing.assert_allclose(got, pallas, **_tol(dtype))


def test_cpu_tensors_never_count_as_launches():
    before = launch_counts["weighted_aggregate"]
    p, upd, w = _inputs(3, 64, seed=1)
    weighted_aggregate(torch.from_numpy(p), torch.from_numpy(upd),
                       torch.from_numpy(w))
    assert launch_counts["weighted_aggregate"] == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "weights_dtype",
                                 "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p = torch.zeros(8)
    upd = torch.zeros(3, 8)
    w = torch.ones(3) / 3
    if bad == "shape":
        upd = torch.zeros(3, 9)
    elif bad == "dtype":
        upd = upd.double()
    elif bad == "weights_dtype":
        w = w.double()
    else:
        upd = torch.zeros(8, 3).t()
    with pytest.raises((ValueError, TypeError)):
        weighted_aggregate(p, upd, w)


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((5, 16, 8), dtype=np.float32),
            "b": {"c": r.standard_normal((5, 33), dtype=np.float32)}}


def test_tree_paths_against_reference():
    tree = _tree(0)
    w = np.asarray([0.5, 0.2, 0.1, 0.1, 0.1], np.float32)
    ref = RO.weighted_aggregate_tree(tree, jnp.asarray(w))
    got = TO.weighted_aggregate_tree(params_from_numpy(tree, "cpu"),
                                     torch.from_numpy(w))
    got = params_to_numpy(got)
    # float32 sums of 5 products in another order
    np.testing.assert_allclose(got["a"], np.asarray(ref["a"]), atol=1e-6)
    np.testing.assert_allclose(got["b"]["c"], np.asarray(ref["b"]["c"]),
                               atol=1e-6)

    params = {"a": tree["a"][0], "b": {"c": tree["b"]["c"][0]}}
    ref2 = RO.aggregate_params_tree(params, tree, jnp.asarray(w))
    got2 = params_to_numpy(TO.aggregate_params_tree(
        params_from_numpy(params, "cpu"), params_from_numpy(tree, "cpu"),
        torch.from_numpy(w)))
    np.testing.assert_allclose(got2["a"], np.asarray(ref2["a"]), atol=1e-6)
    np.testing.assert_allclose(got2["b"]["c"], np.asarray(ref2["b"]["c"]),
                               atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_aggregation_weights_against_reference(alpha):
    stal = np.asarray([0, 1, 1, 3, 8, 2, 0], np.int64)
    ref = np.asarray(RAG.aggregation_weights(jnp.asarray(stal), alpha))
    got = TAG.aggregation_weights(torch.from_numpy(stal), alpha).numpy()
    # one float32 power and one normalisation: a few ulp apart at most
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_apply_aggregation_against_reference():
    tree = _tree(1)
    params = {"a": tree["a"][0] * 0.5, "b": {"c": tree["b"]["c"][1]}}
    stal = np.asarray([0, 2, 1, 4, 0], np.int64)
    ref = RAG.apply_aggregation(params, tree, jnp.asarray(stal), alpha=0.5,
                                server_lr=0.7)
    got = params_to_numpy(TAG.apply_aggregation(
        params_from_numpy(params, "cpu"), params_from_numpy(tree, "cpu"),
        torch.from_numpy(stal), alpha=0.5, server_lr=0.7))
    # weights a few ulp apart times O(1) updates, summed over 5
    np.testing.assert_allclose(got["a"], np.asarray(ref["a"]), atol=1e-6)
    np.testing.assert_allclose(got["b"]["c"], np.asarray(ref["b"]["c"]),
                               atol=1e-6)
