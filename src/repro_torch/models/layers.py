"""Shared layers: RMSNorm, RoPE, MLPs and initialisers (the port of
`repro.models.layers`; embedding and unembedding come with the zoo slice).

Layers are plain functions over parameter trees (dicts of tensors); init
functions return one layer's tree, drawn from a `torch.Generator` on the
host. Dense layers go through `linear`, which also takes a leading
satellite axis on the weights: the batched client update trains a stack
of satellites as one batched product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype, scale: float = None):
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def linear(x, w):
    """x @ w, where w may carry leading batch axes (*lead, d_in, d_out)
    that x (*lead, ..., d_in) shares: the middle axes of x are folded into
    one so that the product is a single batched matmul."""
    lead = w.dim() - 2
    if lead == 0:
        return x @ w
    y = x.reshape(*x.shape[:lead], -1, x.shape[-1]) @ w
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# RMSNorm


def rmsnorm_init(d: int, dtype):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(params, x, eps: float = 1e-6):
    """The plain RMSNorm of the reference's qk-norm (cast, then scale in
    the input's dtype); the transformer's block norms go through the
    kernel (`repro_torch.kernels.rmsnorm.ops`)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(x.dtype) * params["scale"]


# ---------------------------------------------------------------------------
# RoPE


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Computed
    in float32, as the reference does."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, device=x.device)
    ang = positions[..., :, None, None].float() * inv  # (..., S, 1, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)


def mlp_init(generator: torch.Generator, cfg: ModelConfig, d_ff: int = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": dense_init(generator, d, f, dt),
            "w_up": dense_init(generator, d, f, dt),
            "w_down": dense_init(generator, f, d, dt),
        }
    return {
        "w_up": dense_init(generator, d, f, dt),
        "w_down": dense_init(generator, f, d, dt),
    }


def mlp_apply(params, x, act: str):
    """SwiGLU or GELU MLP, the activation taken in float32."""
    if act == "swiglu":
        g = linear(x, params["w_gate"])
        u = linear(x, params["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, params["w_up"]).float(),
                   approximate="tanh").to(x.dtype)
    return linear(h, params["w_down"])
