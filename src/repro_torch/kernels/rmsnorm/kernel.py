"""Wrappers of the CUDA RMSNorm kernels (`csrc/rmsnorm.cu`), forward and
backward, over x viewed as (G, R, D) with one scale row per group:

    y = x * rsqrt(mean(x^2) + eps) * scale        (scale applied in f32)

They replace the Pallas TPU kernel `repro.kernels.rmsnorm.kernel.rmsnorm`
(which has no backward). Each wrapper checks device, dtype, shape and
contiguity and raises on anything the kernel does not take. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor goes to the kernel,
which is built at first use, or the call raises. There is no fallback
from one to the other.
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
CHUNK_ROWS = 256          # rows per partial dscale sum of the backward
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_LIMIT = 65535       # CUDA's limit on gridDim.y and gridDim.z


def _groups(x, scale):
    """Check x (*lead, ..., D) against scale (*lead, D); -> (G, R, D)."""
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
    if x.numel() == 0:
        raise ValueError(f"rmsnorm takes a non-empty x; got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    g = math.prod(lead)
    r = x.numel() // max(g * d, 1)
    if g > _GRID_LIMIT or -(-r // CHUNK_ROWS) > _GRID_LIMIT:
        raise ValueError(f"rmsnorm takes at most {_GRID_LIMIT} scale rows "
                         f"and {_GRID_LIMIT * CHUNK_ROWS} rows per scale "
                         f"row; got {g} and {r}")
    return g, r, d


def _device(*tensors):
    """The one device of `tensors`, which must be contiguous."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rmsnorm takes contiguous tensors")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm runs on CUDA (or, as its plain version, "
                         f"on the CPU); got {device}")
    return device


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernels' C entry points, typed (built at first use)."""
    lib = build.load(SOURCE)
    fwd, bwd = lib.rmsnorm_fwd_launch, lib.rmsnorm_bwd_launch
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fwd.argtypes = [p, p, p, p, i64, i64, i64, ctypes.c_float,
                    ctypes.c_int, ctypes.c_int, p]
    bwd.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def rmsnorm(x, scale, eps: float = 1e-6):
    """x: (*lead, ..., D), scale: (*lead, D) -> (y like x, rstd (rows,)
    float32)."""
    g, r, d = _groups(x, scale)
    device = _device(x, scale)
    if device.type == "cpu":
        return rmsnorm_fwd_ref(x, scale, eps)
    launch, _ = _library()
    y = torch.empty_like(x)
    rstd = torch.empty(g * r, dtype=torch.float32, device=device)
    err = launch(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                 rstd.data_ptr(), g, r, d, eps,
                 int(x.dtype == torch.bfloat16),
                 int(scale.dtype == torch.bfloat16), _stream(device))
    if err:
        raise RuntimeError(f"rmsnorm_fwd_launch failed with cudaError {err}")
    launch_counts[NAME] += 1
    return y, rstd


def rmsnorm_bwd(x, scale, rstd, dy):
    """Gradients of `rmsnorm` for the cotangent dy (like x) -> (dx like x,
    dscale like scale); dscale sums each group's rows in a fixed order."""
    g, r, d = _groups(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    if rstd.shape != (g * r,) or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be ({g * r},) float32; got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    device = _device(x, scale, rstd, dy)
    if device.type == "cpu":
        return rmsnorm_bwd_ref(x, scale, rstd, dy)
    _, launch = _library()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    chunks = -(-r // CHUNK_ROWS)
    work = torch.empty(g * chunks * d, dtype=torch.float32, device=device)
    err = launch(x.data_ptr(), scale.data_ptr(), rstd.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 work.data_ptr(), g, r, d, CHUNK_ROWS,
                 int(x.dtype == torch.bfloat16),
                 int(scale.dtype == torch.bfloat16), _stream(device))
    if err:
        raise RuntimeError(f"rmsnorm_bwd_launch failed with cudaError {err}")
    launch_counts[NAME_BWD] += 1
    return dx, dscale
