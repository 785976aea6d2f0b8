"""Wrappers of the CUDA flash-attention kernels
(`csrc/flash_attention.cu`), forward and backward: GQA, top-left causal
masking, optional sliding window, fully masked kv tiles skipped.

They replace the Pallas TPU kernel `repro.kernels.flash_attention.
kernel.flash_attention` (which has no backward). Each wrapper checks
device, dtype, shape and contiguity and raises on anything the kernel does
not take. A CPU tensor goes to the plain version (`ref.py`); a CUDA tensor
goes to the kernel, which is built at first use, or the call raises. There
is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NAME = "flash_attention"
NAME_BWD = "flash_attention_bwd"
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, *rest, window: int):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q (B, H, Sq, hd) and k, v "
                         f"(B, K, Sk, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (H must be "
                         f"a multiple of K)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention takes non-empty q, k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    tensors = (q, k, v) + rest
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention takes contiguous tensors")
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA (or, as its plain "
                         f"version, on the CPU); got {device}")
    return device


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernels' C entry points, typed (built at first use)."""
    lib = build.load(SOURCE)
    fwd, bwd = lib.flash_fwd_launch, lib.flash_bwd_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    dims = [i] * 8 + [ctypes.c_float, i, p]
    fwd.argtypes = [p] * 5 + dims
    bwd.argtypes = [p] * 10 + dims
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _dims(q, k, causal, window):
    B, H, Sq, hd = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], hd, int(causal), int(window),
            hd ** -0.5, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (o like q, lse (B, H, Sq)
    float32)."""
    device = _check(q, k, v, window=window)
    if device.type == "cpu":
        return attention_fwd_ref(q, k, v, causal=causal, window=window)
    launch, _ = _library()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *_dims(q, k, causal, window))
    if err:
        raise RuntimeError(f"flash_fwd_launch failed with cudaError {err}")
    launch_counts[NAME] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Gradients of `flash_attention` for the cotangent do (like o) ->
    (dq like q, dk like k, dv like v)."""
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype};"
                         f" got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {tuple(q.shape[:3])} float32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    device = _check(q, k, v, o, lse, do, window=window)
    if device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    _, launch = _library()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 *_dims(q, k, causal, window))
    if err:
        raise RuntimeError(f"flash_bwd_launch failed with cudaError {err}")
    launch_counts[NAME_BWD] += 1
    return dq, dk, dv
