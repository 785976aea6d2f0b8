"""Uplink update compression (beyond-paper extension), the port of
`repro.fl.compression`.

The paper (§5, Related Works) notes communication-efficient FL — gradient
compression — is orthogonal to the scheduling contribution and "can be
combined together". This module provides the two standard primitives for
the satellite uplink and the bytes accounting that feeds the link budget:

  * top-k sparsification (keep the k largest-magnitude entries per leaf)
    with the kept values int8-quantized at a per-leaf scale;
  * dense symmetric int8 quantization with a per-leaf scale.

Both are applied satellite-side to g_k before upload and inverted GS-side
before the eq.-4 aggregation. The byte counts and the quantization are the
reference's expressions: ``k = max(1, int(n * k_frac))``, ``k * 5`` bytes
for top-k and ``n + 4`` for dense int8, scale ``max(|kept|, 1e-12) / 127``,
round half to even, clip to ±127.

Ties at the k-th magnitude: `jax.lax.top_k` keeps the lower indices, and
`torch.topk` promises no order among equal values. The kept set here is
the reference's: every entry above the k-th largest magnitude, then the
entries equal to it in index order until k are kept (`_topk_mask`). The
roundtrips (`roundtrip_rows`, `roundtrip_int8_rows`) work on rows, the
last dim a leaf's entries and any leading dims a batch of satellites, so
the client update compresses the engine's update-buffer rows in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_SEQUENCES = (list, tuple)


class CompressedLeaf(NamedTuple):
    values: torch.Tensor     # int8 quantized kept values
    indices: torch.Tensor    # flat indices of kept entries (int32)
    scale: torch.Tensor      # () f32 dequant scale
    shape: tuple


class QuantLeaf(NamedTuple):
    values: torch.Tensor     # int8 quantized dense values, flat
    scale: torch.Tensor      # () f32 dequant scale
    shape: tuple


def _map(fn, tree, leaf_type=None):
    """Apply `fn` to every leaf of a tree of dicts, lists and tuples;
    instances of `leaf_type` (named tuples) count as leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, leaf_type) for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES) and not (
            leaf_type is not None and isinstance(tree, leaf_type)):
        return type(tree)(_map(fn, v, leaf_type) for v in tree)
    return fn(tree)


def _scale(mag):
    """Per-row dequantization scale from the rows' magnitudes (the kept
    ones for top-k: the largest is always kept), (..., 1) f32."""
    return mag.amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0


def _quantize(x, scale):
    """int8 codes of x at `scale`: round half to even, clip to ±127."""
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def _topk_mask(mag, k: int):
    """Bool mask of the k largest of `mag` along the last dim, ties at the
    k-th largest kept in index order (the set `jax.lax.top_k` keeps)."""
    kth = torch.topk(mag, k, dim=-1, sorted=False).values.amin(
        dim=-1, keepdim=True)
    above = mag > kth
    tie = mag == kth
    room = k - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    return above | (tie & (tie.cumsum(dim=-1, dtype=torch.int32) <= room))


def roundtrip_rows(rows, k_frac: float):
    """Top-k + int8 compress and decompress each row of `rows` (..., n)
    float32: the lossy update the GS sees, same shape."""
    n = rows.shape[-1]
    k = max(1, int(n * k_frac))
    mag = rows.abs()
    keep = _topk_mask(mag, k)
    scale = _scale(mag)
    deq = _quantize(rows, scale).to(torch.float32) * scale
    return torch.where(keep, deq, 0.0)


def roundtrip_int8_rows(rows):
    """Dense int8 compress and decompress each row of `rows` (..., n)."""
    scale = _scale(rows.abs())
    return _quantize(rows, scale).to(torch.float32) * scale


def compress_topk_int8(update, k_frac: float = 0.1):
    """Returns (compressed tree, bytes_compressed, bytes_raw). Each leaf's
    kept indices are in `jax.lax.top_k`'s order: descending magnitude,
    ties by the lower index."""
    total_raw = 0
    total_comp = 0

    def one(u):
        nonlocal total_raw, total_comp
        flat = u.reshape(-1).to(torch.float32)
        n = flat.shape[0]
        k = max(1, int(n * k_frac))
        mag = flat.abs()
        idx = torch.sort(mag, descending=True, stable=True).indices[:k]
        kept = flat[idx]
        scale = _scale(kept.abs())[0]
        total_raw += n * 4
        total_comp += k * (1 + 4)   # int8 value + int32 index
        return CompressedLeaf(values=_quantize(kept, scale),
                              indices=idx.to(torch.int32), scale=scale,
                              shape=tuple(u.shape))

    comp = _map(one, update)
    return comp, total_comp, total_raw


def decompress(comp):
    def one(c):
        n = 1
        for d in c.shape:
            n *= d
        flat = torch.zeros((n,), dtype=torch.float32,
                           device=c.values.device)
        flat[c.indices.long()] = c.values.to(torch.float32) * c.scale
        return flat.reshape(c.shape)

    return _map(one, comp, CompressedLeaf)


def roundtrip(update, k_frac: float = 0.1):
    """Compress + decompress — what the GS sees after an uplink with
    top-k/int8 compression. Returns (lossy update, compression ratio)."""
    comp, b_c, b_r = compress_topk_int8(update, k_frac)
    return decompress(comp), b_r / max(b_c, 1)


def compress_int8(update):
    """Dense symmetric int8 quantization, per-leaf scale (no sparsity).

    Returns (compressed tree, bytes_compressed, bytes_raw); the wire
    format is one int8 per entry plus one f32 scale per leaf.
    """
    total_raw = 0
    total_comp = 0

    def one(u):
        nonlocal total_raw, total_comp
        flat = u.reshape(-1).to(torch.float32)
        n = flat.shape[0]
        scale = _scale(flat.abs())[0]
        total_raw += n * 4
        total_comp += n * 1 + 4     # int8 values + f32 scale
        return QuantLeaf(values=_quantize(flat, scale),
                         scale=scale, shape=tuple(u.shape))

    comp = _map(one, update)
    return comp, total_comp, total_raw


def decompress_int8(comp):
    def one(c):
        return (c.values.to(torch.float32) * c.scale).reshape(c.shape)

    return _map(one, comp, QuantLeaf)


def roundtrip_int8(update):
    """Dense-int8 analogue of `roundtrip`: (lossy update, ratio)."""
    comp, b_c, b_r = compress_int8(update)
    return decompress_int8(comp), b_r / max(b_c, 1)


def uplink_bytes_ratio(k_frac: float = 0.0, *, int8: bool = False) -> float:
    """Analytic compressed/raw bytes ratio of one uplinked update.

    Mirrors the per-leaf accounting of `compress_topk_int8` /
    `compress_int8` in the large-leaf limit, where the per-leaf scale is
    amortized away: raw entries cost 4 bytes (f32); a kept top-k entry
    costs 5 (int8 value + int32 index), so top-k lands at
    ``k_frac * 5 / 4``; dense int8 keeps every entry at 1 byte, so 1/4.
    ``k_frac`` in {0, None} with ``int8=False`` is the uncompressed wire
    (ratio 1.0). Top-k takes precedence over ``int8``. The link-budget
    layer multiplies `LinkConfig.model_mb` by this ratio to get the
    effective upload size feeding `transfer_windows`/`LinkGate.need_up`.
    """
    if k_frac:
        return float(k_frac) * 5.0 / 4.0
    if int8:
        return 1.0 / 4.0
    return 1.0
