"""Public flash attention of the port (`repro.kernels.flash_attention.
ops`), with its gradient: `flash_attention` in the kernel's (B, H, S, hd)
layout and `flash_attention_bshd` in the transformer's (B, S, H, hd).

On CUDA tensors both directions run in the CUDA kernels, through a
`torch.autograd.Function`; its backward is first order only
(`once_differentiable`), which is all the client update's
`torch.autograd.grad` needs. In the (B, S, H, hd) layout the kernels read
q, k, v and the cotangent in place where the call takes the short-sequence
kernels (`kernel.short_fits`: the transformer path's calls), and write o
and the gradients in that layout; the hd-256 tensor-core kernels
(`kernel.forward_route`, `kernel.backward_route`) read q, k, v, o and the
cotangent in place too. On CPU tensors the
plain version runs, and autograd differentiates its torch ops."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """Both directions in the kernels; `bshd` picks the layout's entry
    points."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bshd):
        fwd = kernel.flash_attention_bshd if bshd else kernel.flash_attention
        o, lse = fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.bshd = causal, window, bshd
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.bshd:
            # any strides: the wrapper copies only a cotangent whose last
            # dim is strided or whose rows are not on 16 bytes
            bwd = kernel.flash_attention_bshd_bwd
        else:
            bwd, do = kernel.flash_attention_bwd, do.contiguous()
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (B, H, Sq, hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window, False)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, T, K, hd) — the transformer's layout.
    On the CPU the plain version runs on (B, H, S, hd) views; on the card
    the kernels take the tensors as they are."""
    if q.device.type == "cpu":
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
        return o.transpose(1, 2)
    return _FlashAttention.apply(q, k, v, causal, window, True)
