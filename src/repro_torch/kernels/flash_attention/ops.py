"""Public flash attention of the port (`repro.kernels.flash_attention.
ops`), with its gradient: `flash_attention` in the kernel's (B, H, S, hd)
layout and `flash_attention_bshd` in the transformer's (B, S, H, hd).

On CUDA tensors both directions run in the CUDA kernels, through a
`torch.autograd.Function`; its backward is first order only
(`once_differentiable`), which is all the client update's
`torch.autograd.grad` needs. On CPU tensors the plain version runs, and
autograd differentiates its torch ops."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = kernel.flash_attention(q, k, v, causal=causal,
                                        window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, T, K, hd) — the transformer's layout,
    transposed to (B, H, S, hd) for the kernel and back."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)
