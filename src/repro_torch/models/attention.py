"""Attention blocks: GQA with RoPE, optional qk-norm, global (causal),
local (sliding-window) and encoder (bidirectional) variants,
cross-attention over an encoder's output, and single-token decode against
a KV cache (the port of `repro.models.attention`).

Attention runs in the flash-attention kernel
(`repro_torch.kernels.flash_attention.ops`; its plain version on the
CPU), every norm in the RMSNorm kernel. The kernel tiles the sequence by
itself, so the reference's `q_chunk` (an XLA memory device) is accepted
and does not change the result. A local layer is the kernel's
`causal=True, window=W`: the reference keeps 0 <= q - k < W.

Layouts:
  activations  x        : (B, S, D)
  q            q        : (B, S, H, hd)
  kv           k, v     : (B, T, K, hd)      K = num_kv_heads
  kv cache     (B, T, K, hd), written at slot index % T; local layers
               keep T = min(window, seq_len) slots (a ring buffer).
Parameters may carry a leading satellite axis, which x then shares (the
transformer payload's batched client update).

Under tensor parallelism (`tp`, a `layers.TensorParallel`) a rank runs
its query heads and the kv heads they read: q (B, S, H/n, hd), k and v
(B, T, `tp.kv_heads`, hd), its rows of `wo` summed over the model group;
its KV cache holds those kv heads alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ENC_ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, T, K, hd)
    v: torch.Tensor       # (B, T, K, hd)


def attention_init(generator: torch.Generator, cfg: ModelConfig, kind: str):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dt = L.dtype_of(cfg)
    dev = generator.device
    p = {
        "norm": L.rmsnorm_init(d, dt, dev),
        "wq": L.dense_init(generator, d, H * hd, dt),
        "wk": L.dense_init(generator, d, K * hd, dt),
        "wv": L.dense_init(generator, d, K * hd, dt),
        "wo": L.dense_init(generator, H * hd, d, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, dt, dev)
        p["k_norm"] = L.rmsnorm_init(hd, dt, dev)
    return p


def _project_qkv(params, x, cfg: ModelConfig, positions, tp=None):
    """x: (*lead, B, S, D) -> q (*lead, B, S, H, hd), k and v
    (*lead, B, S, K, hd), qk-norm (in the kernel) and RoPE applied to q
    and k; under `tp` the rank's H/n query heads and `tp.kv_heads` kv
    heads."""
    *batch, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    wk, wv = params["wk"], params["wv"]
    if cfg.qk_norm:
        qn, kn = params["q_norm"], params["k_norm"]
    if tp is not None:
        x, H, K = tp.enter(x), tp.heads, tp.kv_heads
        wk, wv = tp.kv_columns(wk), tp.kv_columns(wv)
        if cfg.qk_norm:
            qn = {"scale": tp.enter(qn["scale"])}
            kn = {"scale": tp.enter(kn["scale"])}
    q = L.linear(x, params["wq"]).reshape(*batch, S, H, hd)
    k = L.linear(x, wk).reshape(*batch, S, K, hd)
    v = L.linear(x, wv).reshape(*batch, S, K, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(qn, q, cfg.norm_eps)
        k = L.rmsnorm(kn, k, cfg.norm_eps)
    sin, cos = L.rope_tables(positions, hd, cfg.rope_theta, x.device)
    return L.rotate(q, sin, cos), L.rotate(k, sin, cos), v


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == LOCAL_ATTN else 0


def _project_q(params, h, cfg: ModelConfig):
    """h: (B, S, D) -> q (B, S, H, hd), q-norm applied where the config
    has qk-norm, no RoPE: cross-attention's query."""
    B, S, _ = h.shape
    q = L.linear(h, params["wq"]).reshape(B, S, cfg.num_heads,
                                          cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q, cfg.norm_eps)
    return q


def attention_apply(params, x, cfg: ModelConfig, kind: str,
                    q_chunk: int = 512, positions=None, kv_override=None,
                    tp=None):
    """Full-sequence (prefill) attention block with pre-norm and residual.
    `positions` (S,) or (B, S) default to 0..S-1. A global or local layer
    is causal, an encoder layer (`enc`) not; all three apply RoPE.
    `kv_override` (k, v, causal): cross-attention over precomputed k and
    v (`cross_kv`), its query without RoPE. `tp`: the rank's heads, the
    output projection summed over the model group."""
    B, S, _ = x.shape
    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    if kv_override is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q, k, v = _project_qkv(params, h, cfg, positions, tp)
        causal, window = kind != ENC_ATTN, _window(cfg, kind)
    else:
        k, v, causal = kv_override
        q, window = _project_q(params, h, cfg), 0
    o = flash_ops.flash_attention_bshd(q, k, v, causal=causal, window=window)
    y = o.reshape(B, S, -1) @ params["wo"]
    return x + (y if tp is None else tp.leave(y))


def cross_kv(params, enc_out, cfg: ModelConfig):
    """Cross-attention's k and v (B, T, K, hd) from the encoder's output
    (B, T, D): no RoPE, k-norm where the config has qk-norm."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ params["wk"]).reshape(B, T, cfg.num_kv_heads, hd)
    v = (enc_out @ params["wv"]).reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = L.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)


def init_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int, dtype,
               device=None, kv_heads: int = None) -> KVCache:
    """Zeros of the cache; `kv_heads` (default all K) is a tensor-parallel
    rank's (`TensorParallel.kv_heads`)."""
    T = min(cfg.window_size, seq_len) if kind == LOCAL_ATTN else seq_len
    shape = (batch, T, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x, cache: KVCache, index: int,
                     cfg: ModelConfig, kind: str, kv_override=None, tp=None):
    """x: (B, 1, D); index: a host int, the number of tokens already in
    the cache. Writes the new k and v into slot index % T of the cache
    (in place) and returns (y, cache).

    The slots written so far are the first min(index + 1, T) of the
    cache, for both kinds: a local layer's ring buffer holds exactly its
    window there, in ring order, which a non-causal softmax does not see.
    The G = H / K query heads of a kv head go to the kernel as G query
    rows of one head: q (B, 1, H, hd) is (B, K, G, hd) as it lies, so the
    call is the (B, S, H, hd) entry point's, q a (B, G, K, hd) view against
    the (B, n, K, hd) prefix of the cache as it lies. The kernels that read
    through strides (the short and the hd-256 tensor-core ones) copy
    neither, and the hd-256 one writes o in q's strides, so (B, 1, H * hd)
    is a view of it; the others' wrapper copies the prefix (strided in B).

    `kv_override` (k, v), each (B, T, K, hd): cross-attention over all T
    of them (the encoder's output, `cross_kv`), the query without RoPE;
    nothing is written and `cache` comes back as it was given.

    `tp`: the rank's query heads against its kv heads' cache, the output
    projection summed over the model group."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, K = ((cfg.num_heads, cfg.num_kv_heads) if tp is None
            else (tp.heads, tp.kv_heads))
    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    if kv_override is None:
        pos = torch.full((1,), index, device=x.device)
        q, k_new, v_new = _project_qkv(params, h, cfg, pos, tp)
        T = cache.k.shape[1]
        slot = index % T
        cache.k[:, slot] = k_new[:, 0]
        cache.v[:, slot] = v_new[:, 0]
        n = min(index + 1, T)
        k, v = cache.k[:, :n], cache.v[:, :n]
    else:
        q = _project_q(params, h, cfg)
        k, v = kv_override
    o = flash_ops.flash_attention_bshd(q.reshape(B, K, H // K, hd)
                                       .transpose(1, 2), k, v, causal=False)
    y = o.transpose(1, 2).reshape(B, 1, H * hd) @ params["wo"]
    return x + (y if tp is None else tp.leave(y)), cache
