"""Plain PyTorch version of the flash-attention kernel, forward and
backward: the functions `csrc/flash_attention.cu` computes, written with
materialised float32 scores.

q is (B, H, Sq, hd); k and v are (B, K, Sk, hd) with H a multiple of K
(GQA: query head h reads kv head h // (H // K)). Causal masking is
top-left on absolute positions (key j <= query i); `window` > 0 keeps
i - j < window. A query row that sees no key (possible with a window and
Sq > Sk) gets output 0, gradient 0 and log-sum-exp -inf, following the
TPU kernel; the reference's jnp oracle `attention_ref` gives the mean of
v there (ROADMAP C3). Everywhere else this is the oracle's function."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: int, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def _grouped(t, k_heads):
    """(B, H, S, hd) -> (B, K, G, S, hd) float32."""
    B, H, S, hd = t.shape
    return t.reshape(B, k_heads, H // k_heads, S, hd).float()


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """-> (o (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) float32)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", _grouped(q, K),
                     k.float()) * hd ** -0.5
    mask = _mask(Sq, Sk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    live = mask.any(dim=-1)                  # rows that see some key
    p = torch.where(live[:, None], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    lse = torch.where(live, torch.logsumexp(s, dim=-1), float("-inf"))
    return (o.reshape(B, H, Sq, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """o alone; differentiable through plain torch ops (the CPU path)."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0):
    """FlashAttention-2's backward written out in float32, with the
    softmax recomputed from `lse` -> (dq like q, dk like k, dv like v)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qg, dog = _grouped(q, K), _grouped(do, K)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * scale
    mask = _mask(Sq, Sk, causal, window, q.device)
    lse_g = lse.reshape(B, K, H // K, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    delta = (dog * _grouped(o, K)).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dog)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", dog, vf) - delta)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg) * scale
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
