"""Public functions of the aggregation kernel: the flat form, and tree
forms that take one launch per distinct (params, updates) dtype pair,
which is one on every path of the port (as `repro.kernels.agg.ops`, whose
functions launch once per leaf).

A tree goes through the kernel as one flat buffer laid out by
`FlatLayout`: its leaves in `tree_flatten`'s order (the reference's
`jax.tree` order), each starting on a 16-byte boundary, so a view of a
leaf is as aligned as a tensor of its own; the few elements between
leaves are zero. Where a tree's leaves already are views of one such
buffer at the layout's offsets (the engine keeps its parameters so, and
writes its update rows so), the buffer is read in place; any other tree
is copied into one (one `torch.cat` a tree). `flat_tree` lays a new
tree out so: a params tree, or an (M, ...) update stack, as views of one
buffer a dtype, which a caller at full width needs, since a copy of such
a tree may not fit.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.agg.kernel import weighted_aggregate
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def _contiguous_strides(shape):
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    return tuple(reversed(strides))


class FlatLayout:
    """Where each of a list of leaves lies in one flat buffer of `size`
    elements: leaf i at `offsets[i]`, shaped `shapes[i]`, every offset a
    multiple of `align` elements."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], align: int):
        self.shapes = [tuple(s) for s in shapes]
        self.offsets, end = [], 0
        for shape in self.shapes:
            end = -(-end // align) * align
            self.offsets.append(end)
            end += math.prod(shape)
        self.size = end

    @classmethod
    def of(cls, leaves) -> "FlatLayout":
        """The layout of `leaves`, each on 16 bytes of their dtype, which
        they must share."""
        dtypes = {leaf.dtype for leaf in leaves}
        if len(dtypes) != 1:
            raise TypeError(f"a flat buffer holds one dtype; the leaves "
                            f"have {sorted(map(str, dtypes))}")
        align = max(1, 16 // leaves[0].element_size())
        return cls([leaf.shape for leaf in leaves], align)

    def views(self, buf) -> List[torch.Tensor]:
        """The leaves as views of `buf` (..., size), its leading dims
        kept (a row of leaves for each of them)."""
        lead = tuple(buf.shape[:-1])
        return [buf.narrow(-1, off, math.prod(shape)).view(lead + shape)
                for off, shape in zip(self.offsets, self.shapes)]

    def buffer_of(self, leaves, lead: int = 0) -> Optional[torch.Tensor]:
        """The (..., size) buffer whose `views` `leaves` are, read in
        place, or None when they are not. With `lead` = 1 the leaves are
        (M, *shape) and the buffer (M, size), rows a common stride apart."""
        first = leaves[0]
        if len(leaves) != len(self.shapes):
            return None
        rows = tuple(first.shape[:lead])
        outer = tuple(first.stride()[:lead])
        size = first.element_size()
        base = first.data_ptr() - self.offsets[0] * size
        storage = first.untyped_storage().data_ptr()
        for leaf, off, shape in zip(leaves, self.offsets, self.shapes):
            if (leaf.dtype != first.dtype or leaf.shape != rows + shape
                    or leaf.data_ptr() != base + off * size
                    or leaf.stride() != outer + _contiguous_strides(shape)
                    or leaf.untyped_storage().data_ptr() != storage):
                return None
        if lead and rows[0] > 1 and outer[0] < self.size:
            return None
        return first.as_strided(rows + (self.size,), outer + (1,),
                                first.storage_offset() - self.offsets[0])

    def flat(self, leaves, lead: int = 0) -> torch.Tensor:
        """`buffer_of(leaves)`, or else a new buffer holding them in their
        dtype (one `torch.cat`, zeros between leaves)."""
        buf = self.buffer_of(leaves, lead)
        if buf is not None:
            return buf
        rows = tuple(leaves[0].shape[:lead])
        parts, end = [], 0
        for leaf, off, shape in zip(leaves, self.offsets, self.shapes):
            if off > end:
                parts.append(leaf.new_zeros(rows + (off - end,)))
            parts.append(leaf.reshape(rows + (-1,)))
            end = off + math.prod(shape)
        return torch.cat(parts, dim=-1)


def flat_tree(tree, lead: Tuple[int, ...] = (), dtype=None, device=None):
    """A zeroed tree shaped like `tree` (any device's tensors, meta ones
    too), each leaf (*lead, *leaf.shape) a view of one new buffer
    (*lead, size) for each dtype of `tree`'s leaves, at the offsets of
    `FlatLayout.of` those leaves: the layout that `aggregate_params_tree`
    reads in place, for params (`lead` ()) and for an update stack
    (`lead` (M,)) of the params' tree alike. The buffers are in `dtype`
    (default each group's own) on `device` (default the leaves')."""
    leaves, structure = tree_flatten(tree)
    out = [None] * len(leaves)
    for idx in _by_dtype(leaves, leaves):
        group = [leaves[i] for i in idx]
        layout = FlatLayout.of(group)
        buf = torch.zeros(tuple(lead) + (layout.size,),
                          dtype=dtype or group[0].dtype,
                          device=device or group[0].device)
        for i, v in zip(idx, layout.views(buf)):
            out[i] = v
    return tree_unflatten(structure, out)


def aggregate_flat(params_flat, updates, weights, rows=None):
    """params_flat (N,) + sum_m weights[m] * updates[rows[m]] in one
    launch; `updates` (R, N) may be a column slice of a wider buffer."""
    return weighted_aggregate(params_flat, updates, weights, rows)


def _by_dtype(p_leaves, u_leaves):
    """Leaf indices grouped by (params dtype, updates dtype), in order."""
    groups = {}
    for i, (p, u) in enumerate(zip(p_leaves, u_leaves)):
        groups.setdefault((p.dtype, u.dtype), []).append(i)
    return groups.values()


def weighted_aggregate_tree(update_stack, weights):
    """update_stack: tree of leaves with leading buffer dim M -> the
    weighted-sum tree in float32, one launch per updates dtype."""
    u_leaves, structure = tree_flatten(update_stack)
    out = [None] * len(u_leaves)
    for idx in _by_dtype(u_leaves, u_leaves):   # by the updates' dtype
        us = [u_leaves[i] for i in idx]
        layout = FlatLayout([u.shape[1:] for u in us], 4)   # float32
        zero = us[0].new_zeros(layout.size, dtype=torch.float32)
        summed = aggregate_flat(zero, layout.flat(us, lead=1), weights)
        for i, v in zip(idx, layout.views(summed)):
            out[i] = v
    return tree_unflatten(structure, out)


def aggregate_params_tree(params, update_stack, weights):
    """params + sum_m w_m * updates[m] leafwise, through the kernel: one
    launch per (params, updates) dtype pair; the result's leaves are views
    of the kernel's output, in the params' dtype."""
    p_leaves, structure = tree_flatten(params)
    u_leaves = tree_leaves(update_stack)
    out = [None] * len(p_leaves)
    for idx in _by_dtype(p_leaves, u_leaves):
        ps, us = [p_leaves[i] for i in idx], [u_leaves[i] for i in idx]
        layout = FlatLayout.of(ps)
        new = aggregate_flat(layout.flat(ps), layout.flat(us, lead=1),
                             weights)
        for i, v in zip(idx, layout.views(new)):
            out[i] = v
    return tree_unflatten(structure, out)
