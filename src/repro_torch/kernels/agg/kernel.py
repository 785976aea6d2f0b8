"""Wrapper of the CUDA aggregation kernel (`csrc/agg.cu`):

    out[n] = params[n] + sum_m weights[m] * updates[m, n]

It replaces the Pallas TPU kernel `repro.kernels.agg.kernel.
weighted_aggregate`. The wrapper checks device, dtype, shape and
contiguity and raises on anything the kernel does not take. A CPU tensor
goes to the plain version (`ref.py`); a CUDA tensor goes to the kernel,
which is built at first use, or the call raises. There is no fallback from
one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.agg.ref import weighted_aggregate_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "agg.cu"
NAME = "weighted_aggregate"
_DTYPES = (torch.float32, torch.bfloat16)


def _check(params_flat, updates, weights):
    if params_flat.dim() != 1 or updates.dim() != 2 or weights.dim() != 1:
        raise ValueError(
            f"weighted_aggregate takes params (N,), updates (M, N) and "
            f"weights (M,); got {tuple(params_flat.shape)}, "
            f"{tuple(updates.shape)}, {tuple(weights.shape)}")
    m, n = updates.shape
    if params_flat.shape[0] != n or weights.shape[0] != m:
        raise ValueError(
            f"shape mismatch: params {tuple(params_flat.shape)}, updates "
            f"{tuple(updates.shape)}, weights {tuple(weights.shape)}")
    if params_flat.dtype not in _DTYPES or updates.dtype not in _DTYPES:
        raise TypeError(f"params and updates must be float32 or bfloat16; "
                        f"got {params_flat.dtype}, {updates.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32; got {weights.dtype}")
    devices = {params_flat.device, updates.device, weights.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not (params_flat.is_contiguous() and updates.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("weighted_aggregate takes contiguous tensors")


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel's C entry point, typed (built at first use)."""
    lib = build.load(SOURCE)
    fn = lib.agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def weighted_aggregate(params_flat, updates, weights):
    """params_flat: (N,), updates: (M, N), weights: (M,) float32 -> (N,)
    in the params' dtype, accumulated in float32."""
    _check(params_flat, updates, weights)
    device = params_flat.device
    if device.type == "cpu":
        return weighted_aggregate_ref(params_flat, updates, weights)
    if device.type != "cuda":
        raise ValueError(f"weighted_aggregate runs on CUDA (or, as its "
                         f"plain version, on the CPU); got {device}")
    launch = _library()
    m, n = updates.shape
    out = torch.empty_like(params_flat)
    # the 4-wide path loads 4 elements per row at once: it needs whole
    # groups of 4 and pointers aligned to 4 elements
    align = 4 * updates.element_size(), 4 * params_flat.element_size()
    wide = n % 4 == 0 and updates.data_ptr() % align[0] == 0 \
        and params_flat.data_ptr() % align[1] == 0 \
        and out.data_ptr() % align[1] == 0
    err = launch(params_flat.data_ptr(), updates.data_ptr(),
                 weights.data_ptr(), out.data_ptr(), m, n,
                 int(params_flat.dtype == torch.bfloat16),
                 int(updates.dtype == torch.bfloat16), int(wide),
                 torch._C._cuda_getCurrentRawStream(params_flat.get_device()))
    if err:
        raise RuntimeError(f"agg_launch failed with cudaError {err}")
    launch_counts[NAME] += 1
    return out
