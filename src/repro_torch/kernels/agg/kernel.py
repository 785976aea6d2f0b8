"""Wrapper of the CUDA aggregation kernel (`csrc/agg.cu`):

    out[n] = params[n] + sum_m weights[m] * updates[rows[m], n]

It replaces the Pallas TPU kernel `repro.kernels.agg.kernel.
weighted_aggregate`, one launch a call. `updates` is an (R, N) buffer
whose rows may lie a row stride apart (a column slice of a wider buffer),
and `rows` (int32, (M,)) names the row of each of the M updates, so a
caller reads its update buffer in the weights' order where it lies; no
`rows` means rows 0..M-1. The wrapper checks device, dtype, shape and
strides and raises on anything the kernel does not take. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor goes to the kernel,
which is built at first use, or the call raises. There is no fallback from
one to the other. A meta tensor (the dry run's) gives an empty meta output
and records the call's work (`cost.record_meta`), launching nothing.

The source holds two designs that compute every output bit for bit alike
(`design_for` picks one): "register", a thread per 4 columns walking the
rows, and "ring", row tiles streamed into shared memory by TMA bulk copies
(`RING_STAGES` stages of `RING_TILE_BYTES` a row).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, cost, launch_counts
from repro_torch.kernels.agg.ref import weighted_aggregate_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "agg.cu"
NAME = "weighted_aggregate"
DESIGNS = ("register", "ring")
_DTYPES = (torch.float32, torch.bfloat16)
# The ring takes N from RING_MIN_N on, with RING_STAGES stages of
# RING_TILE_BYTES a row. From chip_smoke.py's `agg sweep` at the paper's
# size on an H100 (PERF.md): 2 stages of 16 KB were within 0.1% of
# the fastest ring with float32 and with bfloat16 updates (2-12 stages of
# 8, 16 and 32 KB spanned 1.5% and 3%). From its `agg cutoff` rows with
# that ring: at M = 20 the register design was 1-8% faster up to N =
# 8,388,608 and the ring 8% faster at 16,777,216; at M = 191 the register
# design was faster up to 262,144, the two within 0.5% from 1,048,576 to
# 8,388,608, and the ring 1-2% faster from 16,777,216 on.
RING_MIN_N = 1 << 24
RING_STAGES = 2
RING_TILE_BYTES = 16384
RING_MAX_SMEM = 232448       # bytes of shared memory a block may take


def design_for(n: int, row_stride_bytes: int) -> str:
    """The design a call takes: the ring from RING_MIN_N columns on, where
    every row starts at one offset from a 16-byte boundary; else the
    register design."""
    if n >= RING_MIN_N and row_stride_bytes % 16 == 0:
        return "ring"
    return "register"


def ring_fits(stages: int, tile_bytes: int) -> bool:
    """Whether the ring takes `stages` stages of `tile_bytes` a row: whole
    warps of consumer threads (2 KB of tile a warp), at most 512 of them,
    and the ring within a block's shared memory."""
    return (stages >= 1 and tile_bytes > 0 and tile_bytes % 2048 == 0
            and tile_bytes <= 32768
            and stages * (tile_bytes + 16) <= RING_MAX_SMEM)


def _check(params_flat, updates, weights, rows):
    if params_flat.dim() != 1 or updates.dim() != 2 or weights.dim() != 1:
        raise ValueError(
            f"weighted_aggregate takes params (N,), updates (R, N) and "
            f"weights (M,); got {tuple(params_flat.shape)}, "
            f"{tuple(updates.shape)}, {tuple(weights.shape)}")
    (n,), (r, n_upd), (m,) = (params_flat.shape, updates.shape,
                              weights.shape)
    if n_upd != n or (m != r if rows is None else r == 0 < m):
        raise ValueError(
            f"shape mismatch: params {tuple(params_flat.shape)}, updates "
            f"{tuple(updates.shape)}, weights {tuple(weights.shape)}")
    if params_flat.dtype not in _DTYPES or updates.dtype not in _DTYPES:
        raise TypeError(f"params and updates must be float32 or bfloat16; "
                        f"got {params_flat.dtype}, {updates.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32; got {weights.dtype}")
    tensors = (params_flat, updates, weights) + (
        () if rows is None else (rows,))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.shape != (m,):
            raise TypeError(f"rows must be int32 of shape ({m},); got "
                            f"{rows.dtype} {tuple(rows.shape)}")
        if not rows.is_contiguous():
            raise ValueError("weighted_aggregate takes contiguous rows")
    if not (params_flat.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_aggregate takes contiguous params and "
                         "weights")
    # the rows of updates: contiguous, each at least N apart
    if (n > 1 and updates.stride(1) != 1) or (r > 1
                                              and updates.stride(0) < n):
        raise ValueError(f"weighted_aggregate takes updates whose rows are "
                         f"contiguous and N apart at least; got strides "
                         f"{updates.stride()}")


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel's C entry point, typed (built at first use)."""
    lib = build.load(SOURCE)
    fn = lib.agg_launch
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _stream(t):
    """PyTorch's current stream on t's device, as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _meta(params_flat, updates, weights):
    """The meta device's call: the output's shape and dtype, the work of
    `cost.agg` recorded."""
    cost.record_meta(NAME, *cost.agg(
        weights.shape[0], params_flat.shape[0], updates.element_size(),
        params_flat.element_size()))
    return torch.empty_like(params_flat)


def weighted_aggregate(params_flat, updates, weights, rows=None, *,
                       design=None, stages=RING_STAGES,
                       tile_bytes=RING_TILE_BYTES):
    """params_flat: (N,), updates: (R, N) with contiguous rows, weights:
    (M,) float32, rows: None (R == M) or int32 (M,) of row indices in
    [0, R) -> (N,) in the params' dtype, accumulated in float32 in the
    order m = 0..M-1. `design` ("register" or "ring"; None: `design_for`)
    and the ring's `stages` and `tile_bytes` choose the kernel on the card;
    every choice gives the same bits."""
    _check(params_flat, updates, weights, rows)
    device = params_flat.device
    if device.type == "cpu":
        return weighted_aggregate_ref(params_flat, updates, weights, rows)
    if device.type == "meta":
        return _meta(params_flat, updates, weights)
    if device.type != "cuda":
        raise ValueError(f"weighted_aggregate runs on CUDA (or, as its "
                         f"plain version, on the CPU, or shapes alone on "
                         f"the meta device); got {device}")
    launch = _library()
    r, n = updates.shape
    ld = updates.stride(0) if r > 1 else n
    if design is None:
        design = design_for(n, ld * updates.element_size())
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}; got {design!r}")
    if design == "ring" and not (
            (ld * updates.element_size()) % 16 == 0
            and ring_fits(stages, tile_bytes)):
        raise ValueError(f"the ring takes rows a multiple of 16 bytes apart "
                         f"and `ring_fits` stages and tiles; got row stride "
                         f"{ld}, {stages} stages of {tile_bytes} bytes")
    out = torch.empty_like(params_flat)
    err = launch(params_flat.data_ptr(), updates.data_ptr(),
                 weights.data_ptr(), 0 if rows is None else rows.data_ptr(),
                 out.data_ptr(), weights.shape[0], n, ld,
                 int(params_flat.dtype == torch.bfloat16),
                 int(updates.dtype == torch.bfloat16),
                 DESIGNS.index(design), stages, tile_bytes,
                 _stream(params_flat))
    if err:
        raise RuntimeError(f"agg_launch failed with cudaError {err}")
    launch_counts[NAME] += 1
    return out
