"""Carry parameter trees and fitted regressors between numpy and the port.

The port's own initialisation (`MlpFmowAdapter.init` with a
`torch.Generator`) draws other numbers than the reference's `jax.random`
initialisation from the same seed. To run both packages from one initial
model, convert the reference's parameters to numpy arrays, bring them in
with `params_from_numpy`, and pass them as `init_params`. Likewise one
utility regressor û serves both packages (or both devices): a forest
through its structure-of-arrays fields (`forest_from_arrays`, e.g. from a
reference forest's `arrays()`), an MLP regressor through its parameters
and standardization (`mlp_regressor_from_numpy`). The model zoo's
parameters come across both ways with `zoo_params_from_numpy` and
`zoo_params_to_numpy`, AdamW's state (`repro.optim.adamw_init`'s tree)
with `adamw_state_from_numpy` and `adamw_state_to_numpy`, and its decode
states with `decode_state_from_numpy` and `decode_state_to_numpy`."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.utility import (ForestArrays, MLPRegressor,
                                      RandomForestRegressor, _Node)
from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import LRUState
from repro_torch.models.ssm import SSMState
from repro_torch.tree import tree_map

_ZOO_KEYS = {"emb", "stages", "final_norm"}
# an encoder-decoder's encoder, the vision frontend's projection
_ZOO_OPTIONAL_KEYS = {"enc_stage", "enc_norm", "vis_proj"}
# a reference cache node's fields -> the port's node
_STATE_NODES = {node._fields: node for node in (KVCache, SSMState, LRUState)}


def _host_copy(t):
    return t.detach().to("cpu", copy=True).numpy()


def _tensor(a, device):
    """An array-like as a tensor on `device`, its dtype kept: a bfloat16
    array (the reference's, an extension dtype numpy cannot hand over)
    through float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, device) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on `device`
    (dtypes kept, bfloat16 too; data copied)."""
    return tree_map(lambda a: _tensor(a, device), tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host,
    copies (never views of a CPU tensor that a train step later writes in
    place)."""
    return tree_map(_host_copy, params)


def forest_from_arrays(feature, thresh, left, right, value, depth: int, *,
                       n_features: Optional[int] = None
                       ) -> RandomForestRegressor:
    """A port `RandomForestRegressor` that predicts from the given
    structure-of-arrays fields ((n_trees, max_nodes) each, as
    `ForestArrays`): `predict`, `predict_device` and `predict_reference`
    all walk these nodes. `n_features` records the fit's feature width
    for `transfer_ready`."""
    fa = ForestArrays(np.asarray(feature, np.int32),
                      np.asarray(thresh, np.float32),
                      np.asarray(left, np.int32),
                      np.asarray(right, np.int32),
                      np.asarray(value, np.float32), int(depth))
    rf = RandomForestRegressor(n_trees=fa.feature.shape[0],
                               max_depth=fa.depth)
    rf.trees = [[_Node(int(f), float(t), int(lc) if f >= 0 else -1,
                       int(rc) if f >= 0 else -1, float(v))
                 for f, t, lc, rc, v in zip(*cols)]
                for cols in zip(fa.feature, fa.thresh, fa.left, fa.right,
                                fa.value)]
    rf._arrays = fa
    if n_features is not None:
        rf.n_features_ = int(n_features)
    return rf


def mlp_regressor_from_numpy(params, mu, sd, ymu, ysd) -> MLPRegressor:
    """A port `MLPRegressor` with the given parameters (a dict w1, b1, w2,
    b2, w3, b3 of array-likes) and standardization (feature mean `mu` and
    std `sd`, target mean `ymu` and std `ysd`), as a fitted one holds
    them."""
    reg = MLPRegressor(hidden=int(np.shape(params["w1"])[1]))
    reg.params = params_from_numpy(params, "cpu")
    reg.mu, reg.sd = np.asarray(mu, np.float32), np.asarray(sd, np.float32)
    reg.ymu, reg.ysd = np.float32(ymu), np.float32(ysd)
    return reg


def _check_zoo_keys(tree):
    keys = set(tree)
    if not (_ZOO_KEYS <= keys <= _ZOO_KEYS | _ZOO_OPTIONAL_KEYS) or \
            not isinstance(tree["stages"], list):
        raise ValueError(f"a zoo tree has the keys {sorted(_ZOO_KEYS)} "
                         f"(\"stages\" a list) and may have "
                         f"{sorted(_ZOO_OPTIONAL_KEYS)}; got {sorted(keys)}")


def zoo_params_from_numpy(tree, device, *, mesh=None, cfg=None) -> dict:
    """A reference zoo tree (`repro.models.transformer.init_params`, its
    leaves as numpy arrays: {"emb", "stages": a list of stacked trees with
    the leading repeat axis, "final_norm"}, and where the config has them
    "enc_stage", "enc_norm" and "vis_proj") -> the port's tree on
    `device`: the same keys, list, shapes and dtypes. With a live `mesh`
    (and the tree's `cfg`), the rank's pieces of it
    (`sharding.shard_params`), what the steps of a tensor-parallel mesh
    take."""
    _check_zoo_keys(tree)
    if mesh is None:
        return params_from_numpy(tree, device)
    from repro_torch import sharding
    whole = tree_map(lambda a: _tensor(a, "cpu"), tree)
    return tree_map(lambda t: t.to(device),
                    sharding.shard_params(whole, cfg, mesh))


def zoo_params_to_numpy(params) -> dict:
    """The port's zoo tree -> numpy leaves in the reference's tree (the
    inverse of `zoo_params_from_numpy`)."""
    _check_zoo_keys(params)
    return params_to_numpy(params)


def adamw_state_from_numpy(state, device) -> dict:
    """A reference AdamW state ({"step": int32 scalar, "m", "v": trees
    like the params}, leaves as numpy arrays) -> the port's on `device`:
    `step` an int32 0-dim tensor, m and v float32 trees."""
    return {"step": torch.tensor(np.asarray(state["step"], np.int32),
                                 device=device),
            "m": params_from_numpy(state["m"], device),
            "v": params_from_numpy(state["v"], device)}


def adamw_state_to_numpy(state) -> dict:
    """The port's AdamW state -> numpy leaves, `step` an int32 scalar as
    the reference keeps it."""
    return {"step": np.int32(state["step"].item()),
            "m": params_to_numpy(state["m"]),
            "v": params_to_numpy(state["v"])}


def _state_map(fn, node):
    if isinstance(node, dict):
        return {k: _state_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_state_map(fn, v) for v in node]
    fields = getattr(node, "_fields", None)
    if fields is not None:
        return _STATE_NODES[tuple(fields)](*(fn(t) for t in node))
    return fn(node)


def decode_state_from_numpy(state, device) -> dict:
    """A reference decode state ({"caches": per stage {"pos<j>": a
    KVCache, SSMState, LRUState or a cross block's dict {"self":
    KVCache, "cross_k", "cross_v"}}, "index"}, leaves as numpy arrays) ->
    the port's: the same nodes on `device`, `index` a host int."""
    caches = _state_map(lambda a: torch.tensor(np.asarray(a), device=device),
                        state["caches"])
    return {"caches": caches, "index": int(np.asarray(state["index"]))}


def decode_state_to_numpy(state) -> dict:
    """The port's decode state -> numpy leaves (caches as the port's
    KVCache, SSMState, LRUState and dicts of arrays), `index` an int32
    scalar as the reference keeps it."""
    caches = _state_map(_host_copy, state["caches"])
    return {"caches": caches, "index": np.int32(state["index"])}
