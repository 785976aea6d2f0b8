"""The port's model blocks (`repro_torch.models`, `repro_torch.configs`)
against `repro.models`: RoPE, the MLPs and the q/k/v projection on the
same inputs and parameters, and the initialisers' trees path for path and
shape for shape. Inputs and parameters are made with numpy from a seed and
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RCfg, StageSpec as RStage
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs.base import ModelConfig as TCfg, StageSpec as TStage
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# one float32 forward in either framework: products summed in another
# order, and sin/cos/exp of another library
F32 = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    base = dict(name="t", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, param_dtype="float32")
    base.update(kw)
    # the reference's config also names the stack's kind and vocabulary,
    # which the port's copy leaves to the slices that read them
    return (RCfg(stages=(RStage(("global",), base["num_layers"]),),
                 arch_type="dense", vocab_size=62, **base),
            TCfg(stages=(TStage(("global",), base["num_layers"]),), **base))


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in flat}


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def _np_tree(tree, seed):
    """Random numpy values with the reference tree's shapes."""
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * r.standard_normal(a.shape)).astype(
        np.float32), tree)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_and_stage_init_trees_match(qk_norm):
    rcfg, tcfg = _cfgs(qk_norm=qk_norm)
    gen = torch.Generator().manual_seed(0)
    ra = RA.attention_init(jax.random.PRNGKey(0), rcfg, "global")
    ta = TA.attention_init(gen, tcfg, "global")
    assert _port_paths(ta) == _ref_paths(ra)
    rs = RT.stage_init(jax.random.PRNGKey(1), rcfg, rcfg.stages[0])
    ts = TT.stage_init(gen, tcfg, tcfg.stages[0])
    assert _port_paths(ts) == _ref_paths(rs)
    # the repeat axis leads every stage leaf, as the reference's vmap
    assert all(s[0] == 2 for s in _port_paths(ts).values())
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts))


def test_unported_blocks_raise():
    """A kind the transformer stack does not have (densenet-fl's `cnn`)
    raises, naming the model that has it; the recurrent and cross blocks
    build the reference's trees."""
    rcfg, tcfg = _cfgs()
    gen = torch.Generator()
    with pytest.raises(NotImplementedError, match="models.densenet"):
        TT.block_init(gen, tcfg, "cnn")
    for kind in ("recurrent", "cross"):
        rb = RT.block_init(jax.random.PRNGKey(2), rcfg, kind)
        assert _port_paths(TT.block_init(gen, tcfg, kind)) == _ref_paths(rb)


def test_dense_init_scale_and_dtype():
    w = TL.dense_init(torch.Generator().manual_seed(3), 256, 512,
                      torch.bfloat16)
    assert w.shape == (256, 512) and w.dtype == torch.bfloat16
    # N(0, 1/fan_in) as the reference draws it: 131k draws, std within 2%
    assert abs(w.float().std().item() * 256 ** 0.5 - 1.0) < 0.02


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches(theta):
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 8, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (3, 8))
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.tensor(x), torch.tensor(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    # the adapter's (S,) positions broadcast to the same result
    got1 = TL.apply_rope(torch.tensor(x), torch.arange(8), theta)
    np.testing.assert_array_equal(got1.numpy(), got.numpy())


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches(act):
    rcfg, tcfg = _cfgs(mlp_act=act)
    p = _np_tree(RL.mlp_init(jax.random.PRNGKey(2), rcfg), seed=4)
    assert _port_paths(TL.mlp_init(torch.Generator(), tcfg)) == \
        _ref_paths(p)
    x = np.random.default_rng(5).standard_normal((4, 8, 32)).astype(
        np.float32)
    ref = RL.mlp_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act)
    got = TL.mlp_apply(params_from_numpy(p, "cpu"), torch.tensor(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_matches(qk_norm):
    rcfg, tcfg = _cfgs(qk_norm=qk_norm)
    p = _np_tree(RA.attention_init(jax.random.PRNGKey(3), rcfg, "global"),
                 seed=6)
    x = np.random.default_rng(7).standard_normal((5, 8, 32)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(8), (5, 8))
    ref = RA._project_qkv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg,
                          jnp.asarray(pos))
    got = TA._project_qkv(params_from_numpy(p, "cpu"), torch.tensor(x), tcfg,
                          torch.arange(8))
    for name, g, r in zip("qkv", got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **F32)


def test_plain_rmsnorm_matches():
    r = np.random.default_rng(8)
    x = r.standard_normal((6, 16)).astype(np.float32)
    s = r.standard_normal(16).astype(np.float32)
    ref = RL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = TL.rmsnorm({"scale": torch.tensor(s)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_linear_with_a_satellite_axis_is_one_product_per_satellite():
    r = np.random.default_rng(9)
    x = torch.tensor(r.standard_normal((3, 4, 8, 16)).astype(np.float32))
    w = torch.tensor(r.standard_normal((3, 16, 5)).astype(np.float32))
    got = TL.linear(x, w)
    assert got.shape == (3, 4, 8, 5)
    for m in range(3):
        torch.testing.assert_close(got[m], x[m] @ w[m])


def test_tree_flatten_orders_keys_and_round_trips():
    tree = {"b": {"y": 1, "x": 2}, "a": 3}
    leaves, structure = tree_flatten(tree)
    assert leaves == [3, 2, 1]          # keys sorted at every level
    assert tree_unflatten(structure, leaves) == tree
    assert tree_unflatten(structure, [5, 6, 7]) == {"a": 5,
                                                    "b": {"x": 6, "y": 7}}
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(structure, [1, 2, 3, 4])
