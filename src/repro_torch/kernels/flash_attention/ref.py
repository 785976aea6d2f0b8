"""Plain PyTorch version of the flash-attention kernel, forward and
backward: the functions `csrc/flash_attention.cu` computes, written with
materialised float32 scores.

q is (B, H, Sq, hd); k and v are (B, K, Sk, hd) with H a multiple of K
(GQA: query head h reads kv head h // (H // K)). Causal masking is
top-left on absolute positions (key j <= query i); `window` > 0 keeps
i - j < window. A query row that sees no key (possible with a window and
Sq > Sk) gets output 0, gradient 0 and log-sum-exp -inf, following the
TPU kernel; the reference's jnp oracle `attention_ref` gives the mean of
v there (ROADMAP C3). Everywhere else this is the oracle's function.

`attention_fwd_split_ref` and `combine_splits_ref` state the hd-256
forward's split over keys, `attention_bwd_group_parts_ref` and
`merge_groups_ref` the hd-256 backward's split over head groups.

Scores are scaled by `scale`, hd**-0.5 by default; the kernels' wrapper
zero-pads hd and passes the true hd's scale, which these functions take
too, so padded inputs can be checked against unpadded ones."""
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


def _attend(q, k, v, mask, scale):
    """o (B, H, Sq, hd) and lse (B, H, Sq), float32, of q over the keys
    that `mask` (Sq, Sk) keeps; a row that keeps none gets o 0 and lse
    -inf."""
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    s = torch.einsum("bkgqd,bktd->bkgqt", _grouped(q, K),
                     k.float()) * (hd ** -0.5 if scale is None else scale)
    s = torch.where(mask, s, NEG_INF)
    live = mask.any(dim=-1)                  # rows that see some key
    p = torch.where(live[:, None], torch.softmax(s, dim=-1), 0.0)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    lse = torch.where(live, torch.logsumexp(s, dim=-1), float("-inf"))
    return o.reshape(B, H, Sq, hd), lse.reshape(B, H, Sq)


def attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      scale=None):
    """-> (o (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) float32)."""
    mask = _mask(q.shape[2], k.shape[2], causal, window, q.device)
    o, lse = _attend(q, k, v, mask, scale)
    return o.to(q.dtype), lse


def attention_fwd_split_ref(q, k, v, ranges, *, causal: bool = True,
                            window: int = 0, scale=None):
    """The forward split over keys, as `csrc/flash_fwd_tc256.cu` splits
    it: for each key range [start, stop) of `ranges`, the attention over
    those keys alone (o normalised by its own sum) and its log-sum-exp ->
    (o_parts (n, B, H, Sq, hd), lse_parts (n, B, H, Sq)), float32. A row
    that sees no key of a range gets o 0 and lse -inf there."""
    Sk = k.shape[2]
    mask = _mask(q.shape[2], Sk, causal, window, q.device)
    kpos = torch.arange(Sk, device=q.device)
    parts = [_attend(q, k, v, mask & (kpos >= start) & (kpos < stop), scale)
             for start, stop in ranges]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([lse for _, lse in parts]))


def combine_splits_ref(o_parts, lse_parts):
    """The splits of `attention_fwd_split_ref` merged, as
    `flash_combine_kernel` merges them -> (o (B, H, Sq, hd), lse (B, H,
    Sq)), float32: lse = log sum_t exp(lse_t), o = sum_t exp(lse_t - lse)
    o_t. A split with lse_t = -inf adds nothing; a row with no key in any
    split gets o 0 and lse -inf."""
    live = lse_parts.amax(dim=0) > float("-inf")
    lse = torch.where(live, torch.logsumexp(lse_parts, dim=0),
                      float("-inf"))
    w = torch.exp(lse_parts - torch.where(live, lse, 0.0))
    return (w[..., None] * o_parts).sum(dim=0), lse


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """o alone; differentiable through plain torch ops (the CPU path)."""
    return attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def _bwd_terms(q, k, v, o, lse, do, causal, window, scale):
    """P and dS (B, K, G, Sq, Sk), the grouped q and do (B, K, G, Sq, hd),
    k, v and the scale, float32: FlashAttention-2's backward with the
    softmax recomputed from `lse`."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg, dog = _grouped(q, K), _grouped(do, K)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf) * scale
    mask = _mask(Sq, Sk, causal, window, q.device)
    lse_g = lse.reshape(B, K, H // K, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    delta = (dog * _grouped(o, K)).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", dog, vf) - delta)
    return p, ds, qg, dog, kf, scale


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, scale=None):
    """FlashAttention-2's backward written out in float32, with the
    softmax recomputed from `lse` -> (dq like q, dk like k, dv like v)."""
    p, ds, qg, dog, kf, scale = _bwd_terms(q, k, v, o, lse, do, causal,
                                           window, scale)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dog)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_bwd_group_parts_ref(q, k, v, o, lse, do, groups: int, *,
                                  causal: bool = True, window: int = 0,
                                  scale=None):
    """dK and dV split over head groups, as `csrc/flash_bwd_tc256.cu`
    splits them: group g of `groups` takes the query heads [g G / groups,
    (g + 1) G / groups) of each kv head's G -> (dk_parts, dv_parts), each
    (groups, B, K, Sk, hd) float32, dk_parts without the scale."""
    p, ds, qg, dog, _, _ = _bwd_terms(q, k, v, o, lse, do, causal, window,
                                      scale)
    G = qg.shape[2]
    cuts = [G * g // groups for g in range(groups + 1)]
    heads = [slice(a, b) for a, b in zip(cuts, cuts[1:])]
    return (torch.stack([torch.einsum("bkgqt,bkgqd->bktd", ds[:, :, h],
                                      qg[:, :, h]) for h in heads]),
            torch.stack([torch.einsum("bkgqt,bkgqd->bktd", p[:, :, h],
                                      dog[:, :, h]) for h in heads]))


def merge_groups_ref(dk_parts, dv_parts, scale: float, dtype):
    """The head groups' partial dK and dV added in order (g = 0, 1, ...),
    as `flash_bwd_tc256_merge_kernel` adds them, dK times `scale` ->
    (dk, dv) in `dtype`."""
    dk, dv = dk_parts[0].clone(), dv_parts[0].clone()
    for a, b in zip(dk_parts[1:], dv_parts[1:]):
        dk += a
        dv += b
    return (dk * scale).to(dtype), dv.to(dtype)
