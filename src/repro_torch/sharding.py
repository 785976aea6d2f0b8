"""Sharding rules of the model zoo (the port of `repro.sharding`): the
parameter, optimizer-state, batch and decode-state specs of a mesh, and
their DTensor placements.

Axes: 'model' = tensor parallel, 'data' = data parallel, 'pod' = pod axis
(multi-pod only). Batch/tokens shard over the data axes; 2-D weight matrices
shard their wide dim over 'model'; MoE expert stacks shard the expert dim
over 'model' when divisible (else per-expert d_ff); optimizer moments get an
extra 'data' axis (ZeRO-1) on the first divisible dim.

A spec is a tuple with one entry per dim of its leaf: None (whole), an
axis name, or a tuple of names (the dim split over those axes, the first
the outermost), the reference's `PartitionSpec` as a tuple, normalised as
it normalises: a tuple of one name is that name (`P(("data",))` is
`P("data")`). A 0-dim leaf, and the decode state's `index` (a host int
here, a 0-dim array there), has the spec `()`. The rules read a leaf's
key path (`repro_torch.tree.tree_map_with_path`) as the reference reads
its pytree path, quirks included: only a path through "stages" or a list
index counts as a stacked stage, so whisper's `enc_stage` leaves are
ranked as unstacked (ROADMAP C25).

A mesh here is a `repro_torch.core.mesh.MeshShape` (names and sizes, no
ranks: what the specs and the dry run need) or a live `DeviceMesh`;
`to_named` gives each spec its `NamedSharding`, whose `placements` are
the DTensor placements, one a mesh dim, and `local_shard` cuts a rank's
piece of a whole tensor by a spec. `shard_params` gives a rank its pieces
of a params tree (what the tensor-parallel steps of
`repro_torch.launch.steps` take), and `unshard_params` puts every rank's
pieces back together."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.mesh import MeshShape, axis_sizes
from repro_torch.tree import (DictKey, SequenceKey, tree_map,
                              tree_map_with_path)

# Leaf-name → role. Roles: col (shard output dim), row (shard input dim),
# vocab_in, replicate.
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_x", "router",
        "vis_proj", "conv_w", "w_a", "w_i"}
_ROW = {"wo", "w_down", "out_proj"}


def axis_names(mesh) -> tuple:
    return (mesh.axis_names if isinstance(mesh, MeshShape)
            else tuple(mesh.mesh_dim_names))


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_size(mesh) -> int:
    """The data-parallel shard count: the product of the data axes."""
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in data_axes(mesh)]))


def spec_of(*entries) -> tuple:
    """A spec from its entries, normalised as `PartitionSpec` does: a
    tuple of one axis name becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def is_spec(x) -> bool:
    """A spec is a plain tuple (a NamedTuple is a node of a state tree)."""
    return type(x) is tuple


def _leaf_name(path) -> str:
    for e in reversed(path):
        if isinstance(e, DictKey):
            return e.key
    return ""


def _in_stage(path) -> bool:
    return any(isinstance(e, DictKey) and e.key == "stages"
               for e in path) or any(isinstance(e, SequenceKey)
                                     for e in path)


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def param_spec(path, leaf, cfg: ModelConfig, mesh) -> tuple:
    name = _leaf_name(path)
    ndim = leaf.ndim
    stacked = _in_stage(path) and name not in ("embed", "lm_head")
    base = ndim - (1 if stacked else 0)
    ms = axis_sizes(mesh)["model"]

    def ok(dim_size):
        return dim_size % ms == 0

    spec = [None] * ndim
    if name == "embed" and ndim == 2:
        if ok(leaf.shape[0]):
            spec[0] = "model"
    elif name == "lm_head" and ndim == 2:
        if ok(leaf.shape[1]):
            spec[1] = "model"
    elif name in ("w_gate", "w_up", "w_down") and base == 3:
        # MoE expert stack (E, D, F) / (E, F, D)
        e_dim = ndim - 3
        if ok(leaf.shape[e_dim]):
            spec[e_dim] = "model"               # expert parallel
        elif name in ("w_gate", "w_up") and ok(leaf.shape[ndim - 1]):
            spec[ndim - 1] = "model"            # mixtral: shard d_ff
        elif name == "w_down" and ok(leaf.shape[ndim - 2]):
            spec[ndim - 2] = "model"
    elif name in _COL and base == 2:
        if ok(leaf.shape[ndim - 1]):
            spec[ndim - 1] = "model"
    elif name in _ROW and base == 2:
        if ok(leaf.shape[ndim - 2]):
            spec[ndim - 2] = "model"
    return spec_of(*spec)


def param_specs(params_shape, cfg: ModelConfig, mesh):
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, mesh), params_shape)


def opt_spec_from_param(pspec: tuple, shape, mesh) -> tuple:
    """ZeRO-1: additionally shard the first unsharded, divisible dim of the
    AdamW moments over 'data'."""
    ds = axis_sizes(mesh)["data"]
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % ds == 0 and dim >= ds:
            spec[i] = "data"
            break
    return spec_of(*spec)


def opt_state_specs(opt_shape, pspecs, cfg: ModelConfig, mesh):
    def for_moment(tree_shape):
        return tree_map(
            lambda leaf, ps: opt_spec_from_param(ps, leaf.shape, mesh),
            tree_shape, pspecs)
    return {
        "step": (),
        "m": for_moment(opt_shape["m"]),
        "v": for_moment(opt_shape["v"]),
    }


def batch_specs(batch_shape, mesh):
    """Shard the leading (batch) dim of every input over the data axes when
    divisible."""
    dp = data_axes(mesh)
    n = data_size(mesh)

    def spec(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % n == 0 and leaf.shape[0] >= n:
            return spec_of(dp, *([None] * (leaf.ndim - 1)))
        return spec_of(*([None] * leaf.ndim))

    return tree_map(spec, batch_shape)


# §Perf decode optimization (EXPERIMENTS.md hillclimb B): additionally shard
# the cache feature dim (head_dim / state channels) over 'model' so the
# scanned cache carry never gets all-gathered, and keep serve-step logits
# vocab-sharded. Baseline (False) keeps the first-recorded lowering.
DECODE_OPT = False


def decode_state_specs(state_shape, cfg: ModelConfig, mesh,
                       shape: ShapeConfig):
    """Decode caches: batch over data axes when divisible; for B=1 long
    decode, shard large cache sequence dims over 'data' instead. With
    DECODE_OPT, the trailing feature dim also shards over 'model'."""
    dp = data_axes(mesh)
    n = data_size(mesh)
    sizes = axis_sizes(mesh)
    ds, ms = sizes["data"], sizes["model"]

    def spec(path, leaf):
        if _ndim(leaf) == 0:
            return ()
        shp = leaf.shape
        out = [None] * leaf.ndim
        # stacked leading layer axis for stage caches
        start = 1 if _in_stage(path) and leaf.ndim >= 2 else 0
        bdim = start
        if bdim < leaf.ndim and shp[bdim] % n == 0 and shp[bdim] >= n:
            out[bdim] = dp
        elif leaf.ndim >= start + 2:
            # batch too small: shard the longest remaining dim (seq) on data
            cand = max(range(start, leaf.ndim), key=lambda i: shp[i])
            if shp[cand] % ds == 0 and shp[cand] >= 16384:
                out[cand] = "data"
        if DECODE_OPT and leaf.ndim >= start + 2 \
                and shp[-1] % ms == 0 and out[leaf.ndim - 1] is None:
            out[leaf.ndim - 1] = "model"
        return spec_of(*out)

    return tree_map_with_path(spec, state_shape)


# ---------------------------------------------------------------------------
# specs on a mesh: placements, sizes, a rank's piece


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A spec on a mesh (the reference's `NamedSharding`): `spec`, the
    mesh, and `placements`, the DTensor placements one a mesh dim in the
    mesh's order: `Shard(d)` on each mesh dim that splits tensor dim d
    (a dim split over ("pod", "data") takes it on both), `Replicate()`
    on the others."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in axis_names(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if name in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def shards(self) -> int:
        """How many pieces the spec cuts a leaf into (its bytes a chip
        are the leaf's over this)."""
        sizes = axis_sizes(self.mesh)
        return int(np.prod([sizes[a] for e in self.spec
                            for a in _entry_axes(e)], dtype=np.int64))

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.spec == self.spec
                and axis_sizes(other.mesh) == axis_sizes(self.mesh))

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def map_specs(fn, spec_tree):
    """`fn` of each spec of `spec_tree` (a spec itself, or a tree of
    them; specs are leaves, though they are tuples)."""
    return tree_map_with_path(lambda _, s: fn(s), spec_tree,
                              is_leaf=is_spec)


def to_named(spec_tree, mesh):
    """Each spec of `spec_tree` as its `NamedSharding` on `mesh`."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def coordinate(mesh) -> dict:
    """{axis name: this rank's index along it} on a live mesh."""
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coords))


def shard_range(size: int, entry, sizes: dict, coords: dict):
    """(start, length) of a rank's piece of a dim of `size` split by a
    spec entry, the entry's first axis the outermost."""
    axes = _entry_axes(entry)
    n = int(np.prod([sizes[a] for a in axes], dtype=np.int64))
    index = 0
    for a in axes:
        index = index * sizes[a] + coords[a]
    length = size // n
    return index * length, length


def piece(x, spec: tuple, sizes: dict, coords: dict):
    """The piece of the whole tensor `x` by `spec` at the mesh coordinate
    `coords` ({axis: index}) of a mesh of `sizes`: a view (`narrow` on
    each split dim)."""
    for d, entry in enumerate(spec):
        if entry is not None:
            start, length = shard_range(x.shape[d], entry, sizes, coords)
            x = x.narrow(d, start, length)
    return x


def local_shard(x, spec: tuple, mesh):
    """The rank's piece of the whole tensor `x` by `spec` on the live
    `mesh`: a view (`narrow` on each split dim)."""
    return piece(x, spec, axis_sizes(mesh), coordinate(mesh))


def shard_params(params, cfg: ModelConfig, mesh, coords: dict = None):
    """The rank's pieces of a whole params tree by `param_specs`, each a
    copy of its own (the whole tree can then be freed): on a live `mesh`
    the rank's coordinate, or `coords` on any mesh (a `MeshShape`
    too)."""
    sizes = axis_sizes(mesh)
    coords = coordinate(mesh) if coords is None else coords
    return tree_map(lambda x, spec: piece(x, spec, sizes, coords).clone(),
                    params, param_specs(params, cfg, mesh))


def assemble(pieces, spec: tuple, sizes: dict):
    """The whole tensor from every coordinate's piece: `pieces` is
    [(coords, piece)] (numpy arrays or tensors) covering the mesh; the
    inverse of `piece`. Ranks that hold the same piece (over an axis the
    spec leaves whole) must hold the same values; the first is taken."""
    first = pieces[0][1]
    shape = [n * int(np.prod([sizes[a] for a in _entry_axes(e)],
                             dtype=np.int64))
             for n, e in zip(first.shape, tuple(spec) + (None,) *
                             (first.ndim - len(spec)))]
    whole = np.empty(shape, dtype=np.asarray(first).dtype)
    for coords, p in pieces:
        index = []
        for d, entry in enumerate(spec):
            if entry is None:
                index.append(slice(None))
            else:
                start, length = shard_range(shape[d], entry, sizes, coords)
                index.append(slice(start, start + length))
        whole[tuple(index)] = np.asarray(p)
    return whole


def unshard_params(pieces, cfg: ModelConfig, mesh, whole_shapes):
    """The whole params tree (numpy) from [(coords, the pieces' tree)]
    covering `mesh`, by the specs of `whole_shapes` (a tree of the whole
    leaves, e.g. the meta device's): the inverse of `shard_params`."""
    specs = param_specs(whole_shapes, cfg, mesh)
    sizes = axis_sizes(mesh)
    coords = [c for c, _ in pieces]
    return tree_map(lambda *leaves: assemble(
        list(zip(coords, leaves[:-1])), leaves[-1], sizes),
        *(tree for _, tree in pieces), specs)


def model_sharded(spec: tuple) -> bool:
    """Whether a spec splits a dim over the 'model' axis."""
    return any("model" in _entry_axes(e) for e in spec)
