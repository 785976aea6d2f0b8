"""Carry parameter trees and fitted regressors between numpy and the port.

The port's own initialisation (`MlpFmowAdapter.init` with a
`torch.Generator`) draws other numbers than the reference's `jax.random`
initialisation from the same seed. To run both packages from one initial
model, convert the reference's parameters to numpy arrays, bring them in
with `params_from_numpy`, and pass them as `init_params`. Likewise one
utility regressor û serves both packages (or both devices): a forest
through its structure-of-arrays fields (`forest_from_arrays`, e.g. from a
reference forest's `arrays()`), an MLP regressor through its parameters
and standardization (`mlp_regressor_from_numpy`)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.utility import (ForestArrays, MLPRegressor,
                                      RandomForestRegressor, _Node)
from repro_torch.tree import tree_map


def params_from_numpy(tree, device) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on `device`
    (dtypes kept, data copied)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


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
