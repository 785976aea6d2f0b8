"""Plain PyTorch version of the RMSNorm kernel, forward and backward: the
functions `csrc/rmsnorm.cu` computes, in float32.

Shapes follow the kernel: `scale` is (*lead, D) and `x` is (*lead, ...,
D), so that each leading index (one satellite of the batched client
update) has its own scale row; an unbatched call has scale (D,).

The scale is applied in float32 before the one cast to x's dtype, as the
TPU kernel does (`repro/kernels/rmsnorm/kernel.py:24`). The reference's
jnp oracle (`rmsnorm_ref`) casts first and then scales in x's dtype: in
float32 the two are the same function; in bfloat16 they differ by one
rounding of the product (ROADMAP C4)."""
from __future__ import annotations

import torch


def _scale_rows(x, scale):
    """scale (*lead, D) reshaped to broadcast against x (*lead, ..., D)."""
    lead = scale.dim() - 1
    return scale.reshape(*scale.shape[:-1], *[1] * (x.dim() - lead - 1),
                         scale.shape[-1]).float()


def rmsnorm_fwd_ref(x, scale, eps: float = 1e-6):
    """-> (y in x's dtype, rstd (rows,) float32)."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = ((xf * rstd) * _scale_rows(x, scale)).to(x.dtype)
    return y, rstd.reshape(-1)


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """y alone; differentiable through plain torch ops (the CPU path)."""
    return rmsnorm_fwd_ref(x, scale, eps)[0]


def rmsnorm_bwd_ref(x, scale, rstd, dy):
    """-> (dx in x's dtype, dscale in scale's dtype):
    dx = rstd * (gy - xh * mean(gy * xh)) with xh = x * rstd and
    gy = dy * scale; dscale = dy * xh summed over each group's rows."""
    r = rstd.reshape(*x.shape[:-1], 1)
    xh = x.float() * r
    dyf = dy.float()
    gy = dyf * _scale_rows(x, scale)
    dx = r * (gy - xh * torch.mean(gy * xh, dim=-1, keepdim=True))
    dscale = (dyf * xh).reshape(*scale.shape[:-1], -1,
                                scale.shape[-1]).sum(dim=-2)
    return dx.to(x.dtype), dscale.to(scale.dtype)
