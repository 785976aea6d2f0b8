"""Carry parameter trees between numpy and the port.

The port's own initialisation (`MlpFmowAdapter.init` with a
`torch.Generator`) draws other numbers than the reference's `jax.random`
initialisation from the same seed. To run both packages from one initial
model, convert the reference's parameters to numpy arrays, bring them in
with `params_from_numpy`, and pass them as `init_params`."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on `device`
    (dtypes kept, data copied)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(params) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
