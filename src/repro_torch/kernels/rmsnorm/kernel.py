"""Wrappers of the CUDA RMSNorm kernels (`csrc/rmsnorm.cu`), forward and
backward, over x viewed as (G, R, D) with one scale row per group:

    y = x * rsqrt(mean(x^2) + eps) * scale        (scale applied in f32)

They replace the Pallas TPU kernel `repro.kernels.rmsnorm.kernel.rmsnorm`
(which has no backward). Each wrapper checks device, dtype, shape and
contiguity and raises on anything the kernel does not take. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor goes to the kernel,
which is built at first use, or the call raises. There is no fallback
from one to the other.

Each direction is one launch. The wrapper picks the kernel's layout from
the shape and the pointers (`vector_width`, `layout`, `tiles`). The
kernel holds a row in registers up to `MAX_LOADS` loads: 16384 bfloat16
or 8192 float32 elements on the 16-byte path, 4096 elements on the 1-wide
one. A wider row takes the row-looping instantiation (`LOOP`: a block a
row, read twice in chunks), so any width runs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_fwd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
NAME = "rmsnorm"
NAME_BWD = "rmsnorm_bwd"
THREADS = 256             # threads of a block; a row takes at most all
# Loads of a row a thread holds before more threads share the row. Few
# loads and many threads measured fastest on the H100 (`chip_smoke.py`'s
# layout line at the zoo shape): fewer registers, more blocks resident.
FWD_LOADS = 2
BWD_LOADS = 2
MAX_LOADS = {True: THREADS * 8, False: THREADS * 16}   # by wide path
LOOP = (THREADS.bit_length() - 1, 0)   # the row-looping layout: nl = 0
TILES = 264               # backward tiles to aim for: two per H100 SM
TILE_STEPS = 16           # a backward tile's rows: at most 16 block steps
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ROWS = 2 ** 31 - 1   # CUDA's limit on gridDim.x: at most a block a row


def vector_width(d: int, itemsize: int, *ptrs: int) -> int:
    """Elements the kernel moves per access: 16 bytes' worth when a row
    is a whole number of 16-byte loads and every pointer is 16-byte
    aligned, else 1 (the 1-wide instantiation of the same kernels)."""
    if (d * itemsize) % 16 or any(p % 16 for p in ptrs):
        return 1
    return 16 // itemsize


@functools.lru_cache(maxsize=256)
def layout(chunks: int, wide: bool, max_loads: int):
    """(log2 threads per row, loads per thread) for a row of `chunks`
    accesses: up to 32 lanes a row (8 at D = 32 float32, 4 rows a warp),
    then more warps a row while a thread would hold more than `max_loads`;
    the loads rounded up to a power of two. A row of more than
    `MAX_LOADS[wide]` accesses takes `LOOP` (a block a row, 0 loads held)."""
    if chunks > MAX_LOADS[wide]:
        return LOOP
    tpr = min(32, 1 << (chunks - 1).bit_length())
    while -(-chunks // tpr) > max_loads and tpr < THREADS:
        tpr *= 2
    return tpr.bit_length() - 1, 1 << (-(-chunks // tpr) - 1).bit_length()


@functools.lru_cache(maxsize=256)
def tiles(groups: int, rows: int, tpr_log2: int):
    """(rows per tile, tiles per group) of the backward: a tile is a
    multiple of the rows a block holds at once, at most `TILE_STEPS` such
    steps unless the groups would then make more than about `TILES`
    tiles. A group of the transformer path (256 rows, 32 a step) is one
    tile: no grid barrier, a plain launch. A function of the shape alone,
    so the order of dscale's sums is too."""
    rpb = THREADS >> tpr_log2
    per_group = max(1, min(-(-TILES // groups),
                           -(-rows // (rpb * TILE_STEPS))))
    tile = -(-(-(-rows // per_group)) // rpb) * rpb
    return tile, -(-rows // tile)


def _check(x, scale):
    """Check x (*lead, ..., D) against scale (*lead, D), both on one
    device and contiguous; -> (G, R, D)."""
    if scale.dim() < 1 or x.dim() < scale.dim():
        raise ValueError(f"rmsnorm takes x (*lead, ..., D) and scale "
                         f"(*lead, D); got {tuple(x.shape)}, "
                         f"{tuple(scale.shape)}")
    lead = scale.shape[:-1]
    if x.shape[:len(lead)] != lead or x.shape[-1] != scale.shape[-1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"x and scale must be float32 or bfloat16; got "
                        f"{x.dtype}, {scale.dtype}")
    n = x.numel()
    if n == 0:
        raise ValueError(f"rmsnorm takes a non-empty x; got "
                         f"{tuple(x.shape)}")
    if x.device != scale.device:
        raise ValueError(f"inputs on different devices: {x.device}, "
                         f"{scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm runs on CUDA (or, as its plain version, "
                         f"on the CPU); got {x.device}")
    d = x.shape[-1]
    if n // d > _MAX_ROWS:
        raise ValueError(f"rmsnorm takes at most {_MAX_ROWS} rows; got "
                         f"{n // d}")
    g = math.prod(lead)
    return g, n // (g * d), d


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernels' C entry points, typed (built at first use)."""
    lib = build.load(SOURCE)
    fwd, bwd = lib.rmsnorm_fwd_launch, lib.rmsnorm_bwd_launch
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fwd.argtypes = [p, p, p, p, i64, i64, i64, ctypes.c_float, i32, i32,
                    i32, i32, p]
    bwd.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, i32, i32, i32,
                    i32, p]
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def _dtypes(x, scale):
    """The C interface's type code: 1 for bfloat16 x, 2 for a bfloat16
    scale."""
    return (x.dtype == torch.bfloat16) + 2 * (scale.dtype == torch.bfloat16)


def _fwd(x, scale, eps, g, r, d, max_loads=FWD_LOADS):
    """Launch the forward on checked CUDA tensors (`max_loads` other than
    the default only to measure the other layouts). y and rstd are two
    allocations: one shared through views costs more host time
    (`chip_smoke.py`'s host line)."""
    launch, _ = _library()
    y = torch.empty_like(x)
    rstd = torch.empty(g * r, dtype=torch.float32, device=x.device)
    vec = vector_width(d, x.element_size(), x.data_ptr(), scale.data_ptr(),
                       y.data_ptr())
    tpr_log2, nl = layout(d // vec, vec > 1, max_loads)
    err = launch(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 rstd.data_ptr(), g, r, d, eps, _dtypes(x, scale), vec,
                 tpr_log2, nl,
                 torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm_fwd_launch failed with cudaError {err}")
    launch_counts[NAME] += 1
    return y, rstd


def _bwd(x, scale, rstd, dy, g, r, d, max_loads=BWD_LOADS):
    """Launch the backward on checked CUDA tensors (`max_loads` as in
    `_fwd`): dx and dscale, and a float32 workspace for the tiles' partial
    sums only where a group has more than one tile (not at the transformer
    path's shapes) or the row-looping kernel keeps its column sums there."""
    _, launch = _library()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    b = x.element_size()
    vec = vector_width(d, b, x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                       scale.data_ptr())
    tpr_log2, nl = layout(d // vec, vec > 1, max_loads)
    tile, per_group = tiles(g, r, tpr_log2)
    partial = None if per_group == 1 and nl else torch.empty(
        g * per_group * d, dtype=torch.float32, device=x.device)
    err = launch(x.data_ptr(), scale.data_ptr(), rstd.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 0 if partial is None else partial.data_ptr(), g,
                 r, d, tile, _dtypes(x, scale), vec, tpr_log2, nl,
                 torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm_bwd_launch failed with cudaError {err}")
    launch_counts[NAME_BWD] += 1
    return dx, dscale


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (*lead, ..., D), scale: (*lead, D) -> (y like x, rstd (rows,)
    float32)."""
    g, r, d = _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_fwd_ref(x, scale, eps)
    return _fwd(x, scale, eps, g, r, d)


def rmsnorm_bwd(x, scale, rstd, dy):
    """Gradients of `rmsnorm` for the cotangent dy (like x) -> (dx like x,
    dscale like scale); dscale sums each group's rows in a fixed order."""
    g, r, d = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    if rstd.shape != (g * r,) or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be ({g * r},) float32; got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    devices = {x.device, rstd.device, dy.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not (rstd.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, rstd, dy)
    return _bwd(x, scale, rstd, dy, g, r, d)
