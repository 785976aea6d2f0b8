"""Shared layers: RMSNorm, RoPE, MLPs, embeddings and initialisers (the
port of `repro.models.layers`).

Layers are plain functions over parameter trees (dicts of tensors); init
functions return one layer's tree, drawn from a `torch.Generator` on the
generator's device (a CUDA generator draws on the card, a CPU one on the
host). Dense layers go through `linear`, which also takes a leading
satellite axis on the weights: the batched client update trains a stack
of satellites as one batched product. Every RMSNorm goes through the
kernel (`repro_torch.kernels.rmsnorm.ops`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class MetaGenerator:
    """Stands in for a `torch.Generator` on the meta device, which has
    none: the init functions given it return the tree's shapes and dtypes
    on the meta device, with no numbers and no memory."""
    device = torch.device("meta")


def normal(generator: torch.Generator, shape, scale: float, dtype):
    """N(0, scale^2) of `shape` in `dtype`, drawn in float32 on the
    generator's device."""
    meta = generator.device.type == "meta"
    w = torch.randn(shape, generator=None if meta else generator,
                    dtype=torch.float32, device=generator.device)
    return w.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype, scale: float = None):
    scale = scale if scale is not None else in_dim ** -0.5
    return normal(generator, (in_dim, out_dim), scale, dtype)


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


def rmsnorm_init(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm over the last dim through the kernel (its plain version on
    the CPU). The kernel applies the scale in float32 before it casts; the
    reference casts first: the same in float32, one rounding apart in
    bfloat16 (ROADMAP C4)."""
    return rms_ops.rmsnorm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device=None):
    """(head_dim//2,) inverse frequencies, computed once per head dim,
    theta and device and kept (made outside inference mode, so training
    can use them too)."""
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        return 1.0 / (theta ** exps)


def rope_tables(positions, head_dim: int, theta: float, device):
    """(sin, cos) of positions (broadcastable to (..., S)), each
    (..., S, 1, head_dim//2) float32: computed once for q and k."""
    inv = rope_frequencies(head_dim, theta, device)
    ang = positions[..., :, None, None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def rotate(x, sin, cos):
    """x: (..., S, H, hd) rotated by `rope_tables`' angles, in float32 as
    the reference does, then cast back."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.device))


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


# ---------------------------------------------------------------------------
# Embedding / LM head


def embedding_init(generator: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    p = {"embed": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt)
    return p


def embed(params, tokens, cfg: ModelConfig):
    """Rows of the table. `F.embedding`, not `table[tokens]`: its gradient
    adds a row's contributions in a fixed order on the CPU and on the
    card, where indexing's (an accumulating `index_put_`) adds them in
    whatever order the CPU's threads take (ROADMAP C21)."""
    return F.embedding(tokens, params["embed"])


def unembed(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]
