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
from repro_torch.kernels.agg import kernel as TK
from repro_torch.kernels.agg import ops as TO
from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_numpy, params_to_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

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


# ------------------------------------------------ rows, strides, flat trees

def _buffer(r, n, offset, dtype, seed):
    """An (r, n) update buffer as a column slice, `offset` elements in, of
    a wider (r, ld) one, drawn with numpy; its float32 values; and the
    plain (r, n) array both packages are given."""
    rng = np.random.default_rng(seed)
    ld = -(-(n + offset) // 64) * 64
    wide = rng.standard_normal((r, ld), dtype=np.float32)
    full = torch.from_numpy(wide).to(_DT[dtype][1])
    return full[:, offset:offset + n], wide[:, offset:offset + n]


@pytest.mark.parametrize("case", ["permuted", "subset"])
@pytest.mark.parametrize("n", [62, 4621])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_read_in_place_against_reference(case, n, dtype):
    """`rows` permuted over the buffer, or a subset of a wider (R, N)
    buffer whose rows lie a row stride apart: the port against the
    reference's oracle and its Pallas kernel (interpreter) on the stack
    gathered in the weights' order."""
    m = 9
    r = m if case == "permuted" else m + 5
    updates, plain = _buffer(r, n, offset=3, dtype=dtype, seed=n + r)
    rng = np.random.default_rng(n)
    rows = rng.permutation(r)[:m].astype(np.int32)
    p = rng.standard_normal(n, dtype=np.float32)
    w = rng.uniform(size=m).astype(np.float32)
    w /= w.sum()
    jdt, tdt = _DT[dtype]
    assert updates.stride() == (updates.stride(0), 1)
    assert updates.stride(0) > n
    got = weighted_aggregate(torch.from_numpy(p).to(tdt), updates,
                             torch.from_numpy(w), torch.from_numpy(rows))
    assert got.dtype == tdt and got.shape == (n,)
    got = got.float().numpy()
    stack = jnp.asarray(plain[rows], jdt)
    jp, jw = jnp.asarray(p, jdt), jnp.asarray(w)
    oracle = np.asarray(weighted_aggregate_ref(jp, stack, jw), np.float32)
    pallas = np.asarray(pallas_aggregate(jp, stack, jw, block=4096,
                                         interpret=True), np.float32)
    np.testing.assert_allclose(got, oracle, **_tol(dtype))
    np.testing.assert_allclose(got, pallas, **_tol(dtype))


# the transformer adapter's 13 leaves (d_model 32, 2 layers, swiglu 64, 62
# classes), in tree order
_TRANSFORMER_SHAPES = [
    (32,), (62,), (32, 62), (2, 32), (2, 32, 16), (2, 32, 32),
    (2, 32, 32), (2, 32, 16), (2, 64, 32), (2, 32, 64), (2, 32, 64),
    (2, 32), (4, 32)]


def _thirteen_leaves(seed, m=None):
    r = np.random.default_rng(seed)
    lead = () if m is None else (m,)
    return {f"l{i:02d}": r.standard_normal(lead + s, dtype=np.float32)
            for i, s in enumerate(_TRANSFORMER_SHAPES)}


def test_flat_layout_puts_leaves_on_16_bytes():
    layout = TO.FlatLayout([s for s in _TRANSFORMER_SHAPES], 4)
    assert all(off % 4 == 0 for off in layout.offsets)
    assert layout.offsets[:3] == [0, 32, 96]    # 2 zeros after the 62
    assert layout.size == 20_768                # 20,766 parameters
    leaves = [torch.ones(s) for s in _TRANSFORMER_SHAPES]
    flat = layout.flat(leaves)
    assert flat.shape == (layout.size,) and float(flat.sum()) == 20_766
    views = layout.views(flat)
    assert all(v.data_ptr() == flat.data_ptr() + 4 * off
               for v, off in zip(views, layout.offsets))
    assert layout.buffer_of(views).data_ptr() == flat.data_ptr()
    assert layout.buffer_of(leaves) is None
    with pytest.raises(TypeError, match="one dtype"):
        TO.FlatLayout.of([torch.ones(3), torch.ones(3).double()])


def test_views_of_one_buffer_against_reference(monkeypatch):
    """Params kept as views of one flat buffer and update rows written
    into a wider buffer in another order (as the engine keeps them): the
    flat form with `rows`, and the tree form on the views (read in place,
    no `torch.cat`), against `repro.kernels.agg.ops.aggregate_params_tree`
    on the stack in the weights' order."""
    m = 6
    params = _thirteen_leaves(0)
    stack = _thirteen_leaves(1, m)
    w = np.random.default_rng(2).uniform(size=m).astype(np.float32)
    w /= w.sum()
    ref = RO.aggregate_params_tree(params, stack, jnp.asarray(w))

    leaves, structure = tree_flatten(params_from_numpy(params, "cpu"))
    layout = TO.FlatLayout.of(leaves)
    flat = layout.flat(leaves)
    buf = torch.zeros(m + 2, layout.size + 64)
    order = np.random.default_rng(3).permutation(m + 2)[:m]
    rows = torch.from_numpy(order.astype(np.int32))
    for j, row in enumerate(order):   # satellite j's update into its row
        for v, leaf in zip(layout.views(buf[row, :layout.size]),
                           tree_leaves(stack)):
            v.copy_(torch.from_numpy(leaf[j]))
    got = tree_unflatten(structure, layout.views(TO.aggregate_flat(
        flat, buf[:, :layout.size], torch.from_numpy(w), rows)))

    in_order = buf[:m, :layout.size]
    in_order.copy_(buf[:, :layout.size][rows.long()])
    cats = []
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1))
    got_tree = TO.aggregate_params_tree(
        tree_unflatten(structure, layout.views(flat)),
        tree_unflatten(structure, layout.views(in_order)),
        torch.from_numpy(w))
    assert not cats
    for out in (got, got_tree):
        for k, leaf in params_to_numpy(out).items():
            # float32 sums of 6 products in another order
            np.testing.assert_allclose(leaf, np.asarray(ref[k]), atol=1e-6,
                                       err_msg=k)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrapper down
    its kernel path on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake_cuda(t):
    return torch.Tensor._make_subclass(_CudaLabelled, t)


class _FakeLaunch:
    """A stand-in for `_library()`'s entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("ring_min_n", [None, 1])
def test_one_launch_per_aggregation_of_a_tree(monkeypatch, ring_min_n):
    """On CUDA tensors, an aggregation of the 13-leaf tree is one launch:
    from views of one buffer it passes that buffer, the update rows'
    pointer and row stride and the row indices; the design follows N (the
    register design below `RING_MIN_N`, the ring from it on when the rows
    are 16 bytes apart); a tree of separate leaves is flattened once, and
    `weighted_aggregate_tree` is one launch too."""
    fake = _FakeLaunch()
    monkeypatch.setattr(TK, "_library", lambda: fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 77)
    if ring_min_n is not None:
        monkeypatch.setattr(TK, "RING_MIN_N", ring_min_n)
    m, ld = 5, 20_800
    layout = TO.FlatLayout(_TRANSFORMER_SHAPES, 4)
    flat = _fake_cuda(torch.zeros(layout.size))
    buf = _fake_cuda(torch.zeros(m + 3, ld))
    updates = buf[:m + 3, :layout.size]
    rows = _fake_cuda(torch.tensor([6, 0, 2, 7, 1], dtype=torch.int32))
    w = _fake_cuda(torch.full((m,), 0.2))
    before = launch_counts["weighted_aggregate"]
    TO.aggregate_flat(flat, updates, w, rows)
    (args,) = fake.calls
    design = 0 if ring_min_n is None else 1
    assert args == (flat.data_ptr(), buf.data_ptr(), w.data_ptr(),
                    rows.data_ptr(), args[4], m, layout.size, ld, 0, 0,
                    design, TK.RING_STAGES, TK.RING_TILE_BYTES, 77)
    # rows 4 bytes * 20,801 apart are not on 16 bytes: the register design
    odd = _fake_cuda(torch.zeros(m, ld + 1))[:, :layout.size]
    TO.aggregate_flat(flat, odd, w)
    assert fake.calls[-1][7] == ld + 1 and fake.calls[-1][10] == 0
    assert fake.calls[-1][3] is None or fake.calls[-1][3] == 0

    structure = tree_flatten(_thirteen_leaves(0))[1]
    params = tree_unflatten(structure, layout.views(flat))
    stack = tree_unflatten(structure, layout.views(buf[:m, :layout.size]))
    TO.aggregate_params_tree(params, stack, w)
    assert fake.calls[-1][:2] == (flat.data_ptr(), buf.data_ptr())
    assert fake.calls[-1][7] == ld
    separate = {k: _fake_cuda(v) for k, v in params_from_numpy(
        _thirteen_leaves(0), "cpu").items()}
    separate_stack = {k: _fake_cuda(v) for k, v in params_from_numpy(
        _thirteen_leaves(1, m), "cpu").items()}
    TO.aggregate_params_tree(separate, separate_stack, w)
    TO.weighted_aggregate_tree(separate_stack, w)
    assert len(fake.calls) == 5
    assert fake.calls[-1][6:8] == (layout.size, layout.size)
    assert launch_counts["weighted_aggregate"] == before + 5
