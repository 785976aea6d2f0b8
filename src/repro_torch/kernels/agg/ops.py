"""Public functions of the aggregation kernel: flat and tree forms, one
kernel launch per leaf (as `repro.kernels.agg.ops`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.tree import tree_map


def aggregate_flat(params_flat, updates, weights):
    return weighted_aggregate(params_flat, updates, weights)


def weighted_aggregate_tree(update_stack, weights):
    """update_stack: tree of leaves with leading buffer dim M -> the
    weighted-sum tree (each leaf flattened through the kernel)."""
    def one(u):
        m = u.shape[0]
        flat = u.reshape(m, -1).contiguous()
        zero = torch.zeros(flat.shape[1], dtype=torch.float32,
                           device=flat.device)
        return aggregate_flat(zero, flat, weights).reshape(u.shape[1:])
    return tree_map(one, update_stack)


def aggregate_params_tree(params, update_stack, weights):
    """params + sum_m w_m * updates[m] per leaf, through the kernel."""
    def one(p, u):
        m = u.shape[0]
        out = aggregate_flat(p.reshape(-1).float().contiguous(),
                             u.reshape(m, -1).contiguous(), weights)
        return out.reshape(p.shape).to(p.dtype)
    return tree_map(one, params, update_stack)
