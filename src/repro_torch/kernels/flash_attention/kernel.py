"""Wrappers of the CUDA flash-attention kernels, forward and backward:
GQA, top-left causal masking, optional sliding window, fully masked kv
tiles skipped.

They replace the Pallas TPU kernel `repro.kernels.flash_attention.
kernel.flash_attention` (which has no backward). Each wrapper checks
device, dtype, shape and contiguity and raises on anything the kernel does
not take. A CPU tensor goes to the plain version (`ref.py`), at any head
dim; a CUDA tensor goes to a kernel, which is built at first use, or the
call raises. There is no fallback from one to the other. A meta tensor
(the dry run's) takes the card's path up to the launch, its padding and
copies included, then gives empty meta outputs (o and the log-sum-exp, or
the gradients) and records the call's work (`cost.record_meta`),
launching nothing.

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
A bfloat16 call at padded hd 256 that `route` sends to the CUDA cores and
that does not take the short kernels takes "tc256" both ways
(`forward_route`, `backward_route`), the tensor cores with every tensor
read and written through its strides: `csrc/flash_fwd_tc256.cu` forward,
split over keys where it has at most `DECODE_ROWS` query rows a unit
(`decode_splits`; its partial results merged by that source's combine
kernel), and `csrc/flash_bwd_tc256.cu` backward, its G query heads a kv
head split into groups where its key blocks alone do not fill the card
(`bwd_groups`; the groups' partial dK and dV merged in a fixed order by
that source's merge kernel).
On the CUDA cores, a call whose (b, kv head) unit fits `SHORT_BUDGET`
(`short_fits`: the transformer path's calls, S = 8) takes that source's
short-sequence kernels, both directions: a warp a unit, the backward in
one launch, and every tensor read and written through its strides, so the
(B, S, H, hd) entry points (`flash_attention_bshd`,
`flash_attention_bshd_bwd`) copy nothing. Either backward reads either
forward's o and log-sum-exp alike.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, cost, launch_counts
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
SOURCE_TC = CSRC / "flash_fwd_tc.cu"
SOURCE_BWD_TC = CSRC / "flash_bwd_tc.cu"
SOURCE_TC256 = CSRC / "flash_fwd_tc256.cu"
SOURCE_BWD_TC256 = CSRC / "flash_bwd_tc256.cu"
NAME = "flash_attention"          # every forward call, either route
NAME_TC = "flash_attention_tc"    # the forward calls that took "tc"
NAME_BWD = "flash_attention_bwd"  # every backward call, either route
NAME_BWD_TC = "flash_attention_bwd_tc"   # the backward calls that took "tc"
NAME_SHORT = "flash_attention_short"     # the forward calls that took the
NAME_BWD_SHORT = "flash_attention_bwd_short"   # short kernels; backward
NAME_TC256 = "flash_attention_tc256"     # the forward calls that took "tc256"
NAME_COMBINE = "flash_attention_combine"   # their combines (split calls)
NAME_BWD_TC256 = "flash_attention_bwd_tc256"   # the backward calls that
                                               # took "tc256"
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
# Bytes of one (b, kv head) unit's float32 backward working set that the
# short-sequence kernels take (`kShortBudget` in `csrc/flash_attention.cu`):
# four such units (128 threads) fit one block's 227 KB of shared memory.
SHORT_BUDGET = 49_152
# The short-sequence entry points' one argument (`ShortArgs` in the CUDA
# source), 8-byte fields: the pointers of q, k, v, o, lse, do, dq, dk and
# dv (the forward's first 5); B, H, K, Sq, Sk, the padded hd, causal,
# window and the bf16 flag; the stream; the scale; then the batch,
# sequence and head strides of q, k, v, o, do, dq, dk and dv (the
# forward's first 4); unused fields 0.
SHORT_ARGS = struct.Struct("<9Q9qQd24q")
# The hd-256 tensor-core entry points' one argument (`Tc256Args` in
# `csrc/flash_fwd_tc256.cu`), 8-byte fields: the pointers of q, k, v, o,
# lse, o_part and lse_part (the last two 0 unsplit); B, H, K, Sq, Sk, the
# padded hd, causal, window and splits; the stream; the scale; then
# the batch, sequence and head strides of q, k, v and o.
TC256_ARGS = struct.Struct("<7Q9qQd12q")
TC256_KEYS = 32     # keys a kv tile of the hd-256 forward (`kBK`)
DECODE_ROWS = 16    # query rows a unit at most of a split call (`kDecodeRows`)
DECODE_BLOCKS_PER_SM = 2   # blocks an SM a split call aims at
MAX_SPLITS = 256    # splits the combine takes (`kMaxSplits`)
# The hd-256 tensor-core backward's one argument (`Tc256BwdArgs` in
# `csrc/flash_bwd_tc256.cu`), 8-byte fields: the pointers of q, k, v, o,
# lse, do, dq, dk, dv, the delta workspace and the head groups' partial
# dK/dV workspace (0 with one group); B, H, K, Sq, Sk, the padded hd,
# causal, window, groups and parts (`BWD_TC_PARTS`); the stream; the
# scale; then the batch, sequence and head strides of q, k, v, o, do, dq,
# dk and dv.
TC256_BWD_ARGS = struct.Struct("<11Q10qQd24q")
BWD_KEYS = 64       # keys a dk/dv block of the hd-256 backward (`kRows`)
# dk/dv blocks an SM (one resident at a time) that a call of the hd-256
# backward aims at: causal and window masking leave a call's last key
# blocks short, so more blocks than SMs balance the card. At
# recurrentgemma-9b's call (64 key blocks, 16 heads) 1, 2, 4, 8 and 16
# groups took 4.90, 3.35, 2.78, 2.39 and 2.44 ms on an NVIDIA H100 80GB
# HBM3 at 700 W (chip_smoke.py's `flash` row, `ms_by_groups`): 3 picks 8.
BWD_WAVES = 3
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


def forward_route(G: int, Sq: int, Sk: int, padded_hd: int, dtype) -> str:
    """The forward's kernels for a call with G query heads a kv head, Sq
    queries, Sk keys and a padded head dim: "short" where `short_fits`,
    "tc256" for the other bfloat16 calls at 256, else `route`'s answer."""
    if short_fits(G, Sq, Sk, padded_hd, dtype):
        return "short"
    if dtype == torch.bfloat16 and padded_hd == 256:
        return "tc256"
    return route(dtype, padded_hd)


# The backward's kernels: the forward's answer ("short", "tc256", else
# `route`'s), since the hd-256 backward came beside the hd-256 forward.
backward_route = forward_route


def bwd_groups(units: int, key_tiles: int, G: int, sm_count: int) -> int:
    """The head groups of an hd-256 backward call whose `units` (b, kv
    head) units have `key_tiles` dk/dv blocks of `BWD_KEYS` keys each and G
    query heads, on a card of `sm_count` SMs: the fewest groups, a divisor
    of G, that give `BWD_WAVES` blocks an SM, or G (each group's blocks
    walk G / groups heads); 1 where the blocks alone give that many."""
    blocks = units * key_tiles
    return next(d for d in range(1, G + 1)
                if G % d == 0 and (d * blocks >= BWD_WAVES * sm_count
                                   or d == G))


def split_ranges(lo: int, hi: int, splits: int, tile: int = TC256_KEYS):
    """The key ranges [start, stop) of `splits` splits of keys [lo, hi), as
    the hd-256 forward cuts a unit's keys: its n tiles of `tile` keys from
    lo, in order, split t taking tiles [t n / splits, (t + 1) n / splits).
    A split past the last tile is empty."""
    n = -(-(hi - lo) // tile) if hi > lo else 0
    return [(min(hi, lo + n * t // splits * tile),
             min(hi, lo + n * (t + 1) // splits * tile))
            for t in range(splits)]


def decode_splits(units: int, visible_keys: int, sm_count: int) -> int:
    """The number of splits over keys for `units` (b, head, query tile)
    units that each see `visible_keys` keys, on a card of `sm_count` SMs:
    1 where the units alone fill the card (a prefill) or see one kv tile;
    else about `DECODE_BLOCKS_PER_SM` blocks an SM, the tiles spread evenly
    and every split at least one tile (`split_ranges` of the count covers
    the keys with non-empty ranges)."""
    tiles = -(-visible_keys // TC256_KEYS)
    if units >= sm_count or tiles <= 1:
        return 1
    want = min(tiles, MAX_SPLITS,
               -(-DECODE_BLOCKS_PER_SM * sm_count // units))
    per = -(-tiles // want)                  # tiles a split
    return -(-tiles // per)


def short_fits(G: int, Sq: int, Sk: int, padded_hd: int, dtype) -> bool:
    """Whether a call with G query heads a kv head, Sq queries, Sk keys and
    a padded head dim takes the short-sequence kernels: a CUDA-core call
    at a padded hd of at most 256 whose unit (one b, one kv head) has a
    backward working set, in float32, within `SHORT_BUDGET` bytes: q, o
    and do of its G heads, k and v, lse and delta, P and dS."""
    if route(dtype, padded_hd) != "cuda_core" or padded_hd > HEAD_DIMS[-1]:
        return False
    rows = G * Sq
    return 4 * (3 * rows * padded_hd + 2 * Sk * padded_hd + 2 * rows
                + 2 * rows * Sk) <= SHORT_BUDGET


def pad_head_dim(t, width: int):
    """t (..., hd) zero-padded along its last dim to `width` (t itself
    when it is that wide already)."""
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _check(q, k, v, *rest, window: int, bshd: bool = False):
    """The device of q, k, v (and `rest`), after checking them: q
    (B, H, Sq, hd) and k, v (B, K, Sk, hd), contiguous; with `bshd`, q
    (B, Sq, H, hd) and k, v (B, Sk, K, hd) in any strides."""
    qs, ks, vs = q.shape, k.shape, v.shape
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4:
        layout = ("(B, Sq, H, hd) and k, v (B, Sk, K, hd)" if bshd
                  else "(B, H, Sq, hd) and k, v (B, K, Sk, hd)")
        raise ValueError(f"flash_attention takes q {layout}; got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(vs)}")
    head = 2 if bshd else 1
    B, H, hd = qs[0], qs[head], qs[3]
    if ks != vs or ks[0] != B or ks[3] != hd or ks[head] == 0 \
            or H % ks[head]:
        raise ValueError(f"shape mismatch: q {tuple(qs)}, k {tuple(ks)}, v "
                         f"{tuple(vs)} (H must be a multiple of K)")
    if 0 in qs or 0 in ks:
        raise ValueError(f"flash_attention takes non-empty q, k, v; got "
                         f"{tuple(qs)}, {tuple(ks)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    tensors = (q, k, v) + rest
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {dt}, {k.dtype}, {v.dtype}")
    device = q.device
    if any(t.device != device for t in tensors[1:]):
        raise ValueError(f"inputs on different devices: "
                         f"{ {t.device for t in tensors} }")
    if not bshd and not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention takes contiguous tensors")
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on CUDA (or, as its plain "
                         f"version, on the CPU, or shapes alone on the meta "
                         f"device); got {device}")
    return device


def _typed(fn, pointers):
    """fn's argument types: `pointers` pointers, the sizes, the scale, the
    type flag and the stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * pointers + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _library():
    """The CUDA-core kernels' C entry points, typed (built at first use):
    the forward and backward, then the short-sequence forward and
    backward (each taking one `SHORT_ARGS` block)."""
    lib = build.load(SOURCE)
    short = (lib.flash_fwd_short_launch, lib.flash_bwd_short_launch)
    for fn in short:
        fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    return (_typed(lib.flash_fwd_launch, 5), _typed(lib.flash_bwd_launch, 10),
            *short)


@functools.lru_cache(maxsize=None)
def _library_tc():
    """The tensor-core forward's C entry point, typed (built at first
    use)."""
    return _typed(build.load(SOURCE_TC).flash_fwd_tc_launch, 5)


@functools.lru_cache(maxsize=None)
def _library_tc256():
    """The hd-256 tensor-core forward's and its combine's C entry points,
    typed (built at first use), each taking one `TC256_ARGS` block."""
    lib = build.load(SOURCE_TC256)
    fns = (lib.flash_fwd_tc256_launch, lib.flash_combine_launch)
    for fn in fns:
        fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _library_bwd_tc256():
    """The hd-256 tensor-core backward's C entry point, typed (built at
    first use), taking one `TC256_BWD_ARGS` block."""
    fn = build.load(SOURCE_BWD_TC256).flash_bwd_tc256_launch
    fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device `index` (queried once: it costs host time)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library_bwd_tc():
    """The tensor-core backward's C entry point, typed (built at first
    use): the CUDA-core backward's arguments, then the number of bf16
    parts of P and dS."""
    fn = _typed(build.load(SOURCE_BWD_TC).flash_bwd_tc_launch, 10)
    fn.argtypes = [*fn.argtypes, ctypes.c_int]
    return fn


def _stream(t):
    """PyTorch's current stream on t's device, as a raw pointer."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _dims(q, k, causal, window, hd):
    """The C entry points' sizes for padded q (B, H, Sq, hd) and k, with
    the scale of the true head dim `hd`."""
    return (*_sizes(q, k, False), q.shape[-1], int(causal), int(window),
            hd ** -0.5, int(q.dtype == torch.bfloat16), _stream(q))


def _sizes(q, k, bshd: bool):
    """(B, H, K, Sq, Sk) of q and k, in the (B, S, H, hd) layout with
    `bshd`, else (B, H, S, hd)."""
    qs, ks = q.shape, k.shape
    if bshd:
        return qs[0], qs[2], ks[2], qs[1], ks[1]
    return qs[0], qs[1], ks[1], qs[2], ks[2]


def _rows16(t):
    """t, or a contiguous copy of it where its last dim is strided or a row
    would not start on 16 bytes (the 16-byte copies of the short and the
    tensor-core kernels; a padded hd's row is a multiple of 16 bytes)."""
    if t.data_ptr() % 16 == 0 and (t.is_contiguous() or (
            t.stride(-1) == 1 and all(
                n == 1 or st * t.element_size() % 16 == 0
                for n, st in zip(t.shape[:3], t.stride()[:3])))):
        return t
    return t.clone(memory_format=torch.contiguous_format)


_ZEROS = (0,) * 24


def _record_meta(name, sizes, hd, q, causal, window, backward):
    """Record a meta call of `sizes` (B, H, K, Sq, Sk) at the true head
    dim `hd`: the work of `cost.flash`."""
    cost.record_meta(name, *cost.flash(*sizes, hd, q.element_size(), causal,
                                       window, backward))


def _short_args(tensors, strided, sizes, causal, window, hd, bshd):
    """The `SHORT_ARGS` block of a call: the pointers of `tensors` (the
    first padded q), the sizes, the padded and the true head dim `hd` (its
    scale), and the batch, sequence and head strides of `strided`."""
    q = tensors[0]
    st = []
    for t in strided:
        x = t.stride()
        st += x[:3] if bshd else (x[0], x[2], x[1])
    return SHORT_ARGS.pack(*(t.data_ptr() for t in tensors),
                           *_ZEROS[len(tensors):9], *sizes, q.shape[-1],
                           causal, window, q.dtype == torch.bfloat16,
                           _stream(q), hd ** -0.5, *st, *_ZEROS[len(st):])


def _short_fwd(q, k, v, causal, window, bshd, sizes):
    """The short-sequence forward on CUDA (or meta) tensors in either
    layout, of `sizes` (a call that `short_fits`): o in q's layout
    (contiguous), lse (B, H, Sq) float32."""
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    q, k, v = (_rows16(pad_head_dim(t, width)) for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = q.new_empty((sizes[0], sizes[1], sizes[3]), dtype=torch.float32)
    if q.device.type == "meta":
        _record_meta(NAME, sizes, hd, q, causal, window, False)
    else:
        err = _library()[2](_short_args((q, k, v, o, lse), (q, k, v, o),
                                        sizes, causal, window, hd, bshd))
        if err:
            raise RuntimeError(f"flash_fwd_short_launch failed with "
                               f"cudaError {err}")
        launch_counts[NAME] += 1
        launch_counts[NAME_SHORT] += 1
    return (o if width == hd else o[..., :hd].contiguous()), lse


def _short_bwd(q, k, v, o, lse, do, causal, window, bshd, sizes):
    """The short-sequence backward, one launch, on CUDA (or meta) tensors
    in either layout, of `sizes` (a call that `short_fits`): dq in q's
    layout, dk and dv in k's (contiguous); no workspace."""
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    q, k, v, o, do = (_rows16(pad_head_dim(t, width))
                      for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    if q.device.type == "meta":
        _record_meta(NAME_BWD, sizes, hd, q, causal, window, True)
    else:
        err = _library()[3](_short_args((q, k, v, o, lse, do, dq, dk, dv),
                                        (q, k, v, o, do, dq, dk, dv), sizes,
                                        causal, window, hd, bshd))
        if err:
            raise RuntimeError(f"flash_bwd_short_launch failed with "
                               f"cudaError {err}")
        launch_counts[NAME_BWD] += 1
        launch_counts[NAME_BWD_SHORT] += 1
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def _call_splits(sizes, causal, device_index: int) -> int:
    """The splits over keys of an hd-256 tensor-core call of `sizes` (B,
    H, K, Sq, Sk) on CUDA device `device_index`: `decode_splits` where it
    has at most `DECODE_ROWS` query rows a unit (one query tile, keys 0 to
    min(Sk, Sq) - 1 under causal masking, Sk - 1 otherwise), else 1."""
    B, H, _, Sq, Sk = sizes
    if Sq > DECODE_ROWS:
        return 1
    return decode_splits(B * H, min(Sk, Sq) if causal else Sk,
                         _sm_count(device_index))


def _tc256_args(tensors, parts, sizes, causal, window, splits, hd, bshd):
    """The `TC256_ARGS` block of a call: the pointers of q, k, v, o, lse
    and the split workspaces `parts` (pointers, or none), the sizes, the
    padded hd (q's last dim), the true head dim `hd` (its scale), and
    the batch, sequence and head strides of q, k, v and o (0 along a dim
    of size 1, which no index moves along)."""
    q = tensors[0]
    return TC256_ARGS.pack(*(t.data_ptr() for t in tensors), *parts,
                           *_ZEROS[len(tensors) + len(parts):7], *sizes,
                           q.shape[-1], causal, window, splits, _stream(q),
                           hd ** -0.5, *_bsh_strides(tensors[:4], bshd))


def _split_parts(q, sizes, splits):
    """The pointers of a split call's workspaces (o_part (splits, B, H, Sq,
    256) and lse_part (splits, B, H, Sq), float32) in one allocation, and
    that allocation; none unsplit."""
    if splits == 1:
        return (), None
    B, H, _, Sq, _ = sizes
    rows = splits * B * H * Sq
    ws = q.new_empty(rows * 257, dtype=torch.float32)
    return (ws.data_ptr(), ws.data_ptr() + rows * 256 * 4), ws


def _tc256_fwd(q, k, v, causal, window, bshd, sizes):
    """The hd-256 tensor-core forward on CUDA (or meta) tensors in either
    layout, of `sizes`: o in q's layout, lse (B, H, Sq) float32; split
    over keys (`_call_splits`), then combined, where that gives more than
    one split. A head dim below 256 is zero-padded to it."""
    hd = q.shape[-1]
    q, k, v = (_rows16(pad_head_dim(t, 256)) for t in (q, k, v))
    meta = q.device.type == "meta"
    fwd, combine = (None, None) if meta else _library_tc256()
    o = torch.empty_like(q)
    B, H, _, Sq, _ = sizes
    lse = q.new_empty((B, H, Sq), dtype=torch.float32)
    if meta:
        _record_meta(NAME, sizes, hd, q, causal, window, False)
    else:
        splits = _call_splits(sizes, causal, q.get_device())
        parts, ws = _split_parts(q, sizes, splits)   # ws held to the end
        args = _tc256_args((q, k, v, o, lse), parts, sizes, causal, window,
                           splits, hd, bshd)
        err = fwd(args)
        if err:
            raise RuntimeError(f"flash_fwd_tc256_launch failed with "
                               f"cudaError {err}")
        launch_counts[NAME] += 1
        launch_counts[NAME_TC256] += 1
        if splits > 1:
            err = combine(args)
            if err:
                raise RuntimeError(f"flash_combine_launch failed with "
                                   f"cudaError {err}")
            launch_counts[NAME_COMBINE] += 1
    return (o if o.shape[-1] == hd else o[..., :hd].contiguous()), lse


def _bsh_strides(tensors, bshd):
    """The batch, sequence and head strides of each tensor, in that order
    (0 along a dim of size 1, which no index moves along)."""
    order = (0, 1, 2) if bshd else (0, 2, 1)
    return [t.stride(d) if t.shape[d] > 1 else 0 for t in tensors
            for d in order]


def _call_groups(sizes, device_index: int) -> int:
    """The head groups of an hd-256 backward call of `sizes` (B, H, K, Sq,
    Sk) on CUDA device `device_index` (`bwd_groups`)."""
    B, H, K, _, Sk = sizes
    return bwd_groups(B * K, -(-Sk // BWD_KEYS), H // K,
                      _sm_count(device_index))


def _tc256_bwd_args(tensors, part, sizes, causal, window, groups, parts, hd,
                   bshd):
    """The `TC256_BWD_ARGS` block of a call: the pointers of q, k, v, o,
    lse, do, dq, dk, dv and delta (`tensors`, q padded) and of the partial
    workspace `part` (0 for none), the sizes, the padded hd (q's last dim),
    `groups`, `parts`, the true head dim `hd` (its scale), and the batch,
    sequence and head strides of q, k, v, o, do, dq, dk and dv."""
    q, k, v, o, lse, do, dq, dk, dv, delta = tensors
    return TC256_BWD_ARGS.pack(
        *(t.data_ptr() for t in tensors), part, *sizes, q.shape[-1], causal,
        window, groups, parts, _stream(q), hd ** -0.5,
        *_bsh_strides((q, k, v, o, do, dq, dk, dv), bshd))


def _group_parts(q, sizes, groups):
    """The pointer of an hd-256 backward call's partial dK/dV workspace
    ((2, groups, B, K, Sk, 256) float32), and the workspace; 0 and none
    with one group."""
    if groups == 1:
        return 0, None
    B, _, K, _, Sk = sizes
    ws = q.new_empty(2 * groups * B * K * Sk * 256, dtype=torch.float32)
    return ws.data_ptr(), ws


def _tc256_bwd(q, k, v, o, lse, do, causal, window, bshd, sizes):
    """The hd-256 tensor-core backward on CUDA (or meta) tensors in either
    layout, of `sizes`: dq, dk and dv like q, k and v (in their strides
    where they are dense, contiguous otherwise), one launch of the C entry
    point (delta, dk/dv, the groups' merge where `_call_groups` gives more
    than one, dq). A head dim below 256 is zero-padded to it."""
    hd = q.shape[-1]
    q, k, v, o, do = (_rows16(pad_head_dim(t, 256))
                      for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    B, H, _, Sq, _ = sizes
    delta = q.new_empty((B, H, Sq), dtype=torch.float32)
    if q.device.type == "meta":
        _record_meta(NAME_BWD, sizes, hd, q, causal, window, True)
    else:
        launch = _library_bwd_tc256()
        groups = _call_groups(sizes, q.get_device())
        part, ws = _group_parts(q, sizes, groups)    # ws held to the end
        err = launch(_tc256_bwd_args(
            (q, k, v, o, lse, do, dq, dk, dv, delta), part, sizes, causal,
            window, groups, BWD_TC_PARTS, hd, bshd))
        if err:
            raise RuntimeError(f"flash_bwd_tc256_launch failed with "
                               f"cudaError {err}")
        launch_counts[NAME_BWD] += 1
        launch_counts[NAME_BWD_TC256] += 1
    if hd != 256:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (o like q, lse (B, H, Sq)
    float32)."""
    device = _check(q, k, v, window=window)
    if device.type == "cpu":
        return attention_fwd_ref(q, k, v, causal=causal, window=window)
    sizes = _sizes(q, k, False)
    kind = forward_route(sizes[1] // sizes[2], sizes[3], sizes[4],
                         padded_head_dim(q.shape[-1]), q.dtype)
    if kind == "short":
        return _short_fwd(q, k, v, causal, window, False, sizes)
    if kind == "tc256":
        return _tc256_fwd(q, k, v, causal, window, False, sizes)
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    tc = route(q.dtype, width) == "tc"
    q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    if tc:
        q, k, v = (_rows16(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = q.new_empty(q.shape[:3], dtype=torch.float32)
    if device.type == "meta":
        _record_meta(NAME, _sizes(q, k, False), hd, q, causal, window, False)
    else:
        launch = _library_tc() if tc else _library()[0]
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), *_dims(q, k, causal, window, hd))
        if err:
            raise RuntimeError(f"flash_fwd{'_tc' if tc else ''}_launch "
                               f"failed with cudaError {err}")
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
    sizes = _sizes(q, k, False)
    kind = backward_route(sizes[1] // sizes[2], sizes[3], sizes[4],
                          padded_head_dim(q.shape[-1]), q.dtype)
    if kind == "short":
        return _short_bwd(q, k, v, o, lse, do, causal, window, False,
                          sizes)
    if kind == "tc256":
        return _tc256_bwd(q, k, v, o, lse, do, causal, window, False,
                          sizes)
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    tc = route(q.dtype, width) == "tc"
    q, k, v, o, do = (pad_head_dim(t, width) for t in (q, k, v, o, do))
    if tc:
        q, k, v, o, do = (_rows16(t) for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = q.new_empty(q.shape[:3], dtype=torch.float32)
    if device.type == "meta":
        _record_meta(NAME_BWD, _sizes(q, k, False), hd, q, causal, window,
                     True)
    else:
        launch = _library_bwd_tc() if tc else _library()[1]
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                     *_dims(q, k, causal, window, hd),
                     *((BWD_TC_PARTS,) if tc else ()))
        if err:
            raise RuntimeError(f"flash_bwd{'_tc' if tc else ''}_launch "
                               f"failed with cudaError {err}")
        launch_counts[NAME_BWD] += 1
        if tc:
            launch_counts[NAME_BWD_TC] += 1
    if width != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd), in any strides (the
    transformer's projections) -> (o (B, Sq, H, hd) like q, lse (B, H, Sq)
    float32). On the card a call that `short_fits` reads the tensors in
    place and writes o contiguous, so that (B, Sq, H * hd) is a view of
    it; a call that takes "tc256" reads them in place too and writes o in
    q's strides where q is dense (contiguous otherwise); any other call is
    transposed to (B, H, S, hd) for `flash_attention` and back."""
    device = _check(q, k, v, window=window, bshd=True)
    if device.type == "cpu":
        o, lse = attention_fwd_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window)
        return o.transpose(1, 2), lse
    sizes = _sizes(q, k, True)
    kind = forward_route(sizes[1] // sizes[2], sizes[3], sizes[4],
                         padded_head_dim(q.shape[-1]), q.dtype)
    if kind == "short":
        return _short_fwd(q, k, v, causal, window, True, sizes)
    if kind == "tc256":
        return _tc256_fwd(q, k, v, causal, window, True, sizes)
    o, lse = flash_attention(*(t.transpose(1, 2).contiguous()
                               for t in (q, k, v)),
                             causal=causal, window=window)
    return o.transpose(1, 2), lse


def flash_attention_bshd_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0):
    """Gradients of `flash_attention_bshd` for the cotangent do (like o,
    any strides) -> (dq like q, dk like k, dv like v), each in the
    (B, S, H, hd) layout. On the card a call that `short_fits` or takes
    "tc256" (`backward_route`) reads the tensors in place; any other call
    is transposed to (B, H, S, hd) for `flash_attention_bwd` and back."""
    B, Sq, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} {q.dtype};"
                         f" got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be {(B, H, Sq)} float32, contiguous; "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    device = _check(q, k, v, o, lse, do, window=window, bshd=True)
    if device.type == "cpu":
        grads = attention_bwd_ref(*(t.transpose(1, 2) for t in (q, k, v, o)),
                                  lse, do.transpose(1, 2), causal=causal,
                                  window=window)
        return tuple(g.transpose(1, 2) for g in grads)
    sizes = _sizes(q, k, True)
    kind = backward_route(sizes[1] // sizes[2], sizes[3], sizes[4],
                          padded_head_dim(q.shape[-1]), q.dtype)
    if kind == "short":
        return _short_bwd(q, k, v, o, lse, do, causal, window, True,
                          sizes)
    if kind == "tc256":
        return _tc256_bwd(q, k, v, o, lse, do, causal, window, True, sizes)
    grads = flash_attention_bwd(
        *(t.transpose(1, 2).contiguous() for t in (q, k, v, o)), lse,
        do.transpose(1, 2).contiguous(), causal=causal, window=window)
    return tuple(g.transpose(1, 2) for g in grads)
