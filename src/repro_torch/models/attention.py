"""Attention parameters and the q/k/v projection with RoPE (the port of
`repro.models.attention`'s `attention_init` and `_project_qkv`). The
attention itself runs in the flash-attention kernel
(`repro_torch.kernels.flash_attention.ops`); the reference's chunked
`_attend_*` paths, `_sdpa`, decode and the KV caches come with the zoo
slice.

Layouts:
  activations  x        : (B, S, D)
  q            q        : (B, S, H, hd)
  kv           k, v     : (B, T, K, hd)      K = num_kv_heads
Parameters may carry a leading satellite axis, which x then shares.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def attention_init(generator: torch.Generator, cfg: ModelConfig, kind: str):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dt = L.dtype_of(cfg)
    p = {
        "norm": L.rmsnorm_init(d, dt),
        "wq": L.dense_init(generator, d, H * hd, dt),
        "wk": L.dense_init(generator, d, K * hd, dt),
        "wv": L.dense_init(generator, d, K * hd, dt),
        "wo": L.dense_init(generator, H * hd, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, dt)
        p["k_norm"] = L.rmsnorm_init(hd, dt)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (*lead, B, S, D) -> q (*lead, B, S, H, hd), k and v
    (*lead, B, S, K, hd), RoPE applied to q and k."""
    *batch, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = L.linear(x, params["wq"]).reshape(*batch, S, H, hd)
    k = L.linear(x, params["wk"]).reshape(*batch, S, K, hd)
    v = L.linear(x, params["wv"]).reshape(*batch, S, K, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
