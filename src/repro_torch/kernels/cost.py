"""The work of one call of each kernel: the bytes it must move (each input
read once, each output written once) and the operations it does on these
inputs, from the call's shapes. `chip_smoke.py` divides them by the H100's
rates for the least time a call could take (`bound`), and a call on the
meta device records them (`record_meta`) for the dry run's op counter
(`repro_torch.launch.roofline`), so both read this one copy.

The rates are the H100 SXM data sheet's (dense): HBM3 at 3.35 TB/s,
float32 outside the tensor cores at 67 TFLOP/s, bf16 on the tensor cores
at 989 TFLOP/s. The aggregation and RMSNorm do their arithmetic on the
CUDA cores in float32; attention's operations are bounded by the tensor
cores' bf16 rate, the least time the card could take for them, though its
CUDA-core route runs in float32.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.kernels import meta_counts

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12


def bound(moved_bytes, ops, flop_per_s) -> Tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes over the HBM
    rate and the operations over `flop_per_s`."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agg(m: int, n: int, upd_bytes: int, par_bytes: int = 4):
    """(bytes, operations) of one aggregation of M rows over N columns:
    every input (M rows of updates, params, M weights and M row indices)
    read once, the output written once, against 2*M*N float32
    operations."""
    return (m * upd_bytes + 2 * par_bytes) * n + 8 * m, 2 * m * n


def rmsnorm_fwd(n: int, itemsize: int, scale_bytes: int, rows: int):
    """(bytes, operations) of the forward over n elements in `rows` rows:
    x read, y written, the scale read, rstd (float32) written."""
    return 2 * n * itemsize + scale_bytes + 4 * rows, 4 * n


def rmsnorm_bwd(n: int, itemsize: int, scale_bytes: int, rows: int):
    """(bytes, operations) of the backward: x and dy read, dx written, the
    scale read and dscale written, rstd read."""
    return 3 * n * itemsize + 2 * scale_bytes + 4 * rows, 10 * n


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps (top-left causal, a window of the
    last `window` keys): the work this call's inputs need."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def flash(B: int, H: int, K: int, sq: int, sk: int, hd: int, itemsize: int,
          causal: bool, window: int, backward: bool = False):
    """(bytes, operations) of one attention call at the true head dim:
    forward q, k, v read, o and lse written, 4*hd operations a visible
    (query, key) pair and head; backward q, o, do, k, v, lse read and dq,
    dk, dv written, 2.5 times the forward's operations."""
    qo = B * H * sq * hd * itemsize        # bytes of q (and of o, do, dq)
    kv = B * K * sk * hd * itemsize        # bytes of k (and of v, dk, dv)
    lse = 4 * B * H * sq
    ops = 4 * hd * B * H * visible_pairs(sq, sk, causal, window)
    if backward:
        return 4 * qo + 4 * kv + lse, 2.5 * ops
    return 2 * qo + 2 * kv + lse, ops


def flash_combine(splits: int, rows: int, hd: int, itemsize: int):
    """(bytes, operations) of merging `splits` partial results of `rows`
    query rows at head dim hd: the float32 partial o and lse of every split
    read, o (in the inputs' type) and lse (float32) written; a multiply
    and an add a split and element."""
    return (splits * rows * (hd + 1) * 4 + rows * (hd * itemsize + 4),
            2 * splits * rows * hd)


def record_meta(name: str, moved_bytes, ops) -> None:
    """Record a call of kernel `name` made on the meta device: its work,
    and no launch (`launch_counts` is untouched)."""
    meta_counts[name, "calls"] += 1
    meta_counts[name, "bytes"] += moved_bytes
    meta_counts[name, "flops"] += ops
