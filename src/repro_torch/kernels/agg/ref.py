"""Plain PyTorch version of the aggregation kernel: the function the CUDA
kernel computes, written as a gather of the named rows followed by a
float32 tensordot (the reference's
`repro.kernels.agg.ref.weighted_aggregate_ref`)."""
from __future__ import annotations

import torch


def weighted_aggregate_ref(params_flat, updates, weights, rows=None):
    if rows is not None:
        updates = updates.index_select(0, rows)
    acc = torch.tensordot(weights.float(), updates.float(), dims=1)
    return (params_flat.float() + acc).to(params_flat.dtype)
