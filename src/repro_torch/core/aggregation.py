"""Staleness-compensated buffered aggregation (paper eq. 4):

    w^{i+1} = w^i + sum_k  c(s_k)/C * g_k,    C = sum_k c(s_k)

Operates on parameter trees of per-satellite update stacks. The weighted
reduction over the update buffer routes through
`repro_torch.kernels.agg.ops.aggregate_params_tree`: one launch of the
CUDA kernel over the flattened tree for tensors on the card, its plain
PyTorch version for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.staleness import staleness_compensation
from repro_torch.kernels.agg.ops import aggregate_params_tree


def aggregation_weights(staleness, alpha: float = 0.5):
    """Normalized c(s_k)/C weights. staleness: (M,) int tensor."""
    c = staleness_compensation(torch.as_tensor(staleness), alpha)
    return c / c.sum().clamp(min=1e-12)


def apply_aggregation(global_params, update_stack, staleness, *,
                      alpha: float = 0.5, server_lr: float = 1.0):
    """global_params: tree; update_stack: tree with leading buffer dim M
    (stacked g_k); staleness: (M,) int tensor on the params' device.

    Returns the updated params."""
    w = aggregation_weights(staleness, alpha) * server_lr
    return aggregate_params_tree(global_params, update_stack, w)
