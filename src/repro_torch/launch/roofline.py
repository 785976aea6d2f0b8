"""Roofline terms of one step, counted on the meta device (the port of
`repro.launch.roofline`).

The reference reads its terms from the compiled HLO of a dry-run lowering.
The port has no compiler, so it counts what an eager step does: `OpCounter`
is a `TorchDispatchMode` over one execution of the step on meta tensors
(shapes and dtypes, no memory, no card), which sees every ATen op the step
issues, its backward and a remat's recomputation included:

  * FLOPs: matrix products and convolutions by `torch.utils.flop_counter`'s
    registered formulas (2 * M * N * K for a product), as the reference
    counts its dots and convolutions;
  * HBM bytes: the tensor inputs plus the tensor outputs of every op that
    is not a view or an allocation. In eager mode each op is its own HBM
    boundary, as a fusion is in the reference. A write into a slice
    (`copy_`, as the KV-cache write, or a scatter into a buffer) counts
    the bytes read plus the bytes written, twice the slice, as the
    reference's dynamic-update-slice rule; `fill_` and `zero_` count the
    bytes written;
  * the port's own kernels: a kernel call on the meta device launches
    nothing and records its work by the formulas of
    `repro_torch.kernels.cost` (`kernels.meta_counts`), which the counter
    adds;
  * collective bytes: 0. The reference counts the collectives GSPMD
    inserts into its per-shard program (the model axis's all-gathers and
    reduce-scatters of tensor parallelism, the data axes' gradient sums);
    the dry run executes the step of one device on the mesh's shape, which
    issues none. The port's tensor-parallel partition exists on live
    meshes (`models/layers.py::TensorParallel`, the steps of
    `launch/steps.py` on a model axis above 1); counting its collectives
    on the meta device, from one rank's program, waits for ROADMAP A.10
    part 6.

The counter executes the whole step, so its totals are global, where the
reference's per-shard HLO totals are scaled by the chips; `analyze` keeps
the reference's keys and the terms' formulas:

    compute    = FLOPs      / (chips * PEAK_FLOPS)
    memory     = bytes      / (chips * HBM_BW)
    collective = coll_bytes / (chips * ICI_BW)
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost, meta_counts
from repro_torch.tree import tree_leaves

# H100 SXM5, per card (NVIDIA H100 Tensor Core GPU data sheet): dense bf16
# on the tensor cores and HBM3, the rates `kernels.cost` holds, and NVLink 4
# at 900 GB/s both ways, 450 GB/s a direction.
PEAK_FLOPS = cost.BF16_TC_FLOP_PER_S      # bf16 FLOP/s
HBM_BW = cost.HBM_BYTES_PER_S             # bytes/s
ICI_BW = 450e9                            # bytes/s a direction

_aten = torch.ops.aten
# ops that move no data: allocations and views the schema does not mark
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
         _aten.lift_fresh, _aten.detach, _aten.alias}
# writes into part of a buffer: the bytes read and written are the other
# operands', twice
_SCATTERS = {_aten.index_put_, _aten._index_put_impl_, _aten.index_copy_,
             _aten.scatter_, _aten.scatter_add_, _aten.index_add_,
             _aten.masked_scatter_}
_WRITE_ONLY = {_aten.fill_, _aten.zero_}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _op_bytes(func, args, kwargs, out) -> int:
    """The HBM bytes of one executed op, by the rules above."""
    packet = func.overloadpacket
    if packet is _aten.copy_:
        return _nbytes(_tensors(args[:2]))
    if packet in _SCATTERS:
        return 2 * _nbytes(_tensors((args[1:], kwargs)))
    if packet in _WRITE_ONLY:
        return _nbytes(_tensors(args[:1]))
    written = [a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write
               and a.kwarg_only]
    reads = _tensors((args, {k: v for k, v in kwargs.items()
                             if k not in written}))
    return _nbytes(reads) + _nbytes(_tensors(out))


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and HBM bytes of the ops executed under it, and of
    the port's kernels called on the meta device meanwhile. After the
    `with` block: `flops`, `bytes` (totals), `ops` (ops counted),
    `kernel_calls`, `kernel_flops`, `kernel_bytes` (by kernel entry
    point) and `flops_by_op` (matrix products by ATen op)."""

    def __init__(self):
        super().__init__()
        self._depth = 0
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.flops_by_op = Counter()
        self.kernel_calls = Counter()
        self.kernel_flops = Counter()
        self.kernel_bytes = Counter()

    def __enter__(self):
        if not self._depth:
            self._before = Counter(meta_counts)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        delta = Counter(meta_counts)
        delta.subtract(self._before)
        for (name, what), n in delta.items():
            if n:
                {"calls": self.kernel_calls, "flops": self.kernel_flops,
                 "bytes": self.kernel_bytes}[what][name] += n
        self.flops += sum(self.kernel_flops.values())
        self.bytes += sum(self.kernel_bytes.values())
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite op (`matmul` under inference mode, which skips
            # the autograd key that decomposes it) runs as its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[str(packet)] += n
        if not (func.is_view or packet in _FREE):
            self.bytes += _op_bytes(func, args, kwargs, out)
            self.ops += 1
        return out


# ---------------------------------------------------------------------------
# Report assembly


def analyze(counter: OpCounter, chips: int) -> dict:
    """The reference's keys and terms from a step's global counts."""
    flops, moved = float(counter.flops), float(counter.bytes)
    coll = 0.0
    return {
        "hlo_flops": flops,
        "hlo_bytes": moved,
        "collective_bytes": coll,
        "collective_by_kind": {},
        "collective_count": 0,
        "t_compute_s": flops / (chips * PEAK_FLOPS),
        "t_memory_s": moved / (chips * HBM_BW),
        "t_collective_s": coll / (chips * ICI_BW),
    }


def model_flops(cfg, shape, num_params_active: float, num_params_total: float
                ) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * num_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * num_params_active * tokens
    return 2.0 * num_params_active * shape.global_batch


def count_params(params_shape) -> int:
    """Elements of the tree's leaves (meta tensors hold none)."""
    return int(sum(x.numel() for x in tree_leaves(params_shape)))


def _named_leaves(tree, name=""):
    """(the key of the leaf's own node, leaf) for every leaf: its dict
    key, or "" for a list's item (the reference's path[-1].key)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v)
    else:
        yield name, tree


def count_active_params(cfg, params_shape) -> float:
    """Active params per token: total minus inactive expert fraction."""
    total = count_params(params_shape)
    if not cfg.num_experts:
        return float(total)
    expert = sum(leaf.numel() for name, leaf in _named_leaves(params_shape)
                 if name in ("w_gate", "w_up", "w_down") and leaf.dim() >= 3)
    frac = cfg.experts_per_token / cfg.num_experts
    return float(total - expert + expert * frac)
