"""Public RMSNorm of the port (`repro.kernels.rmsnorm.ops.rmsnorm`), with
its gradient.

On a CUDA tensor both directions run in the CUDA kernels, through a
`torch.autograd.Function`; its backward is first order only
(`once_differentiable`), which is all the client update's
`torch.autograd.grad` needs. On a CPU tensor the plain version runs, and
autograd differentiates its torch ops."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps):
        y, rstd = kernel.rmsnorm(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = kernel.rmsnorm_bwd(x, scale, rstd, dy.contiguous())
        return dx, dscale, None


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (*lead, ..., D); scale: (*lead, D), one scale row per leading
    index ((D,) for a shared scale). Scale applied in float32, y in x's
    dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps)
