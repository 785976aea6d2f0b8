"""Wrappers of the CUDA flash-attention kernels, forward and backward:
GQA, top-left causal masking, optional sliding window, fully masked kv
tiles skipped.

They replace the Pallas TPU kernel `repro.kernels.flash_attention.
kernel.flash_attention` (which has no backward). Each wrapper checks
device, dtype, shape and contiguity and raises on anything the kernel does
not take. A CPU tensor goes to the plain version (`ref.py`), at any head
dim; a CUDA tensor goes to a kernel, which is built at first use, or the
call raises. There is no fallback from one to the other.

On the card a head dim `hd` from 1 to `MAX_HEAD_DIM` is zero-padded to
the next instantiated width (`padded_head_dim`): zero columns change no
dot product and give zero output columns, and the kernel takes the scale
of the true `hd`. Up to 256 the widths are `HEAD_DIMS`; above, multiples
of 256, which take row-looping kernels. `route` then picks the kernels of
both directions:
  "tc"         bfloat16 at padded hd 64 or 128: `csrc/flash_fwd_tc.cu` and
               `csrc/flash_bwd_tc.cu`, on the tensor cores (`mma.sync`
               with bf16 inputs and float32 sums);
  "cuda_core"  every other case: `csrc/flash_attention.cu`, float32
               arithmetic on the CUDA cores (float32 on the tensor cores
               would mean TF32, which changes the numbers).
Either backward reads either forward's o and log-sum-exp alike.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
SOURCE_TC = CSRC / "flash_fwd_tc.cu"
SOURCE_BWD_TC = CSRC / "flash_bwd_tc.cu"
NAME = "flash_attention"          # every forward call, either route
NAME_TC = "flash_attention_tc"    # the forward calls that took "tc"
NAME_BWD = "flash_attention_bwd"  # every backward call, either route
NAME_BWD_TC = "flash_attention_bwd_tc"   # the backward calls that took "tc"
HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # instantiated on the CUDA cores
TC_HEAD_DIMS = (64, 128)                # instantiated on the tensor cores
WIDE_CHUNK = 256     # above 256, widths are multiples of this
# The widest padded head dim: the largest multiple of WIDE_CHUNK whose
# float32 dk and dv rows (8 bytes a dim) fit one block's 227 KB of shared
# memory in the row-looping kernels.
MAX_HEAD_DIM = 232_448 // 8 // WIDE_CHUNK * WIDE_CHUNK
# bf16 parts P and dS are split into as operands of the tensor-core
# backward's dV, dK and dQ products: 1 (one rounding) or 2 (high and low)
BWD_TC_PARTS = 2
_DTYPES = (torch.float32, torch.bfloat16)


def padded_head_dim(hd: int) -> int:
    """The width a head dim of `hd` (1 to `MAX_HEAD_DIM`) is zero-padded to
    on the card: the next of `HEAD_DIMS`, or above 256 the next multiple of
    `WIDE_CHUNK`."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    if hd <= MAX_HEAD_DIM:
        return -(-hd // WIDE_CHUNK) * WIDE_CHUNK
    raise ValueError(
        f"head dim {hd} above the kernels' limit of {MAX_HEAD_DIM}, the "
        f"widest whose float32 row accumulators fit one block's shared "
        f"memory (the TPU kernel keeps a (bq, hd) float32 accumulator in "
        f"VMEM, so it has a ceiling too; no configuration in the repository "
        f"has a head dim above 256)")


def route(dtype, padded_hd: int) -> str:
    """The kernels of both directions for inputs of `dtype` at a padded
    head dim: "tc" (tensor cores) or "cuda_core"."""
    if dtype == torch.bfloat16 and padded_hd in TC_HEAD_DIMS:
        return "tc"
    return "cuda_core"


def pad_head_dim(t, width: int):
    """t (..., hd) zero-padded along its last dim to `width` (t itself
    when it is that wide already)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


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


def _typed(fn, pointers):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * pointers + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _library():
    """The CUDA-core kernels' C entry points, typed (built at first use)."""
    lib = build.load(SOURCE)
    return _typed(lib.flash_fwd_launch, 5), _typed(lib.flash_bwd_launch, 10)


@functools.lru_cache(maxsize=None)
def _library_tc():
    """The tensor-core forward's C entry point, typed (built at first
    use)."""
    return _typed(build.load(SOURCE_TC).flash_fwd_tc_launch, 5)


@functools.lru_cache(maxsize=None)
def _library_bwd_tc():
    """The tensor-core backward's C entry point, typed (built at first
    use): the CUDA-core backward's arguments, then the number of bf16
    parts of P and dS."""
    fn = _typed(build.load(SOURCE_BWD_TC).flash_bwd_tc_launch, 10)
    fn.argtypes = [*fn.argtypes, ctypes.c_int]
    return fn


def _aligned(tensors):
    """The tensors, each copied if it does not start on 16 bytes (the
    tensor-core kernels' 16-byte copies need 16-byte aligned rows)."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def _dims(q, k, causal, window, hd):
    """The C entry points' sizes for padded q and k, with the scale of the
    true head dim `hd`."""
    B, H, Sq, width = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], width, int(causal),
            int(window), hd ** -0.5, int(q.dtype == torch.bfloat16),
            torch._C._cuda_getCurrentRawStream(q.get_device()))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (o like q, lse (B, H, Sq)
    float32)."""
    device = _check(q, k, v, window=window)
    if device.type == "cpu":
        return attention_fwd_ref(q, k, v, causal=causal, window=window)
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    tc = route(q.dtype, width) == "tc"
    launch = _library_tc() if tc else _library()[0]
    q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    if tc:
        q, k, v = _aligned((q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *_dims(q, k, causal, window, hd))
    if err:
        raise RuntimeError(f"flash_fwd{'_tc' if tc else ''}_launch failed "
                           f"with cudaError {err}")
    launch_counts[NAME] += 1
    if tc:
        launch_counts[NAME_TC] += 1
    return (o if width == hd else o[..., :hd].contiguous()), lse


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
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    tc = route(q.dtype, width) == "tc"
    launch = _library_bwd_tc() if tc else _library()[1]
    q, k, v, o, do = (pad_head_dim(t, width) for t in (q, k, v, o, do))
    if tc:
        q, k, v, o, do = _aligned((q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 *_dims(q, k, causal, window, hd),
                 *((BWD_TC_PARTS,) if tc else ()))
    if err:
        raise RuntimeError(f"flash_bwd{'_tc' if tc else ''}_launch failed "
                           f"with cudaError {err}")
    launch_counts[NAME_BWD] += 1
    if tc:
        launch_counts[NAME_BWD_TC] += 1
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
