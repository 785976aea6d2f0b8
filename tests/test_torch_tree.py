"""The port's parameter trees (`repro_torch.tree`) against `jax.tree`: lists
and tuples are nodes whose items flatten in index order, dicts flatten in
sorted-key order, and a tree rebuilt from its leaves is the tree it came
from; the reference's DenseNet tree flattens leaf for leaf, key path for
key path, as `jax.tree.leaves` does, so `FlatLayout` lays it out in the
reference's order."""
import jax
import numpy as np
import pytest
import torch

from repro.models.densenet import densenet_init
from repro_torch.kernels.agg.ops import FlatLayout
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.weights import params_from_numpy, params_to_numpy

MIXED = {"z": [1, {"b": 2, "a": (3, 4)}], "a": {"y": [5], "x": 6},
         "m": ((7,), [8, 9])}


def test_mixed_tree_leaves_in_jax_order():
    assert tree_leaves(MIXED) == jax.tree.leaves(MIXED)
    assert tree_leaves(MIXED) == [6, 5, 7, 8, 9, 1, 3, 4, 2]


def test_flatten_unflatten_round_trip_keeps_node_types():
    leaves, structure = tree_flatten(MIXED)
    back = tree_unflatten(structure, [v * 10 for v in leaves])
    assert back == tree_map(lambda v: v * 10, MIXED)
    assert isinstance(back["z"], list) and isinstance(back["z"][1]["a"],
                                                      tuple)
    assert isinstance(back["m"][0], tuple) and isinstance(back["m"][1], list)
    with pytest.raises(ValueError):
        tree_unflatten(structure, leaves + [0])


def test_tree_map_zips_several_trees_over_lists():
    doubled = tree_map(lambda a, b: a + b, MIXED, MIXED)
    assert jax.tree.leaves(doubled) == [2 * v for v in jax.tree.leaves(MIXED)]


@pytest.mark.parametrize("blocks", [(1, 1), (2, 2, 2)])
def test_densenet_tree_flattens_as_jax_does(blocks):
    ref = jax.tree.map(np.asarray, densenet_init(
        jax.random.PRNGKey(0), growth=8, blocks=blocks, stem=16))
    port = params_from_numpy(ref, "cpu")
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    leaves = tree_leaves(port)
    # the stem, 3 a layer (conv, gn scale and bias), 3 a transition, and
    # the head with its gn
    assert len(leaves) == len(paths) == 1 + 3 * sum(blocks) \
        + 3 * (len(blocks) - 1) + 3
    for (path, want), got in zip(paths, leaves):
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=jax.tree_util.keystr(path))
    assert isinstance(port["blocks"], list)
    back = params_to_numpy(port)
    assert jax.tree.structure(back) == jax.tree.structure(ref)


def test_flat_layout_of_the_densenet_tree_has_no_gaps():
    """Part A's widths: 28 leaves, 12,512 parameters, each leaf size a
    multiple of 4, so the flat model is the leaves back to back."""
    ref = jax.tree.map(np.asarray, densenet_init(
        jax.random.PRNGKey(1), growth=8, blocks=(2, 2, 2), stem=16))
    leaves = tree_leaves(params_from_numpy(ref, "cpu"))
    layout = FlatLayout.of(leaves)
    assert len(leaves) == 28 and layout.size == 12_512
    flat = layout.flat(leaves)
    want = np.concatenate([np.ravel(x) for x in jax.tree.leaves(ref)])
    np.testing.assert_array_equal(flat.numpy(), want)
    for view, leaf in zip(layout.views(flat), leaves):
        assert torch.equal(view, leaf)
