"""The satellite axis of the Algorithm-1 protocol state sharded across
devices: the port of `repro.core.mesh`, on `torch.distributed`.

The mesh is a 1-D `DeviceMesh` named ``"sat"`` over the ranks of a
process group: NCCL on the card, gloo on the CPU (``device="cpu"``, what
the tests use). The transitions take the mesh's group as their `axis`
(`axis_name` in `repro_torch.core.staleness` and `repro_torch.core.isl`,
the reference's spelling) and, where the reference calls `psum`, `pmax`
and `all_gather`, call the c10d collectives here; `axis=None` runs the
single-device program unchanged. Every rank runs the engine's host loop
on the same values: the counters that steer it are psums, so every rank
takes the same decisions and issues the same collectives in the same
order.

The state layout follows the reference's ``out_specs=(sat, rep)``: each
rank holds the whole padded (Kp,) `SatState` columns (a few int
columns), and only its own columns of the run's (windows, Kp)
connectivity, grant and fault tables (the memory the mesh exists for). A
scan runs on the rank's columns ``[r·Kp/n, (r+1)·Kp/n)`` and gathers the
state columns after it (`repro_torch.fl.engine._scan_windows`).

Padding: device counts rarely divide K, so `padded_size` / `pad_axis` /
`pad_state` extend the satellite axis with satellites that never existed
(connectivity False, grants 0, state -1, self-loop ISL indices). Such a
satellite never uploads, downloads, gossips, idles or enters the buffer,
so every counter and every real satellite's trajectory is the unpadded
run's, bit for bit (`docs/scaling.md`, "Parity contract").

The reference's `shard_map` is a shim over JAX's changing spellings and
has no counterpart here. Its `abstract_mesh`, a mesh without devices for
the zoo's sharding specs, is `MeshShape` here: axis names and sizes, no
ranks. Everything that reads a mesh's
shape (`axis_sizes`) takes a `MeshShape` as it takes a live
`DeviceMesh`; the zoo's mesh (`repro_torch.launch.mesh`,
`repro_torch.sharding`, the steps of `repro_torch.launch.steps`) builds
on both.

`collective_counts` counts the collectives that ran, by kind (`psum`,
`pmax`, `all_gather`, and the zoo's float collectives `psum_partial`,
`grad_psum`, `psum_shared`, `all_reduce`, `gather_params`,
`gather_shards`), beside
`repro_torch.kernels.launch_counts`: each function adds one where it
issues its collective (an autograd function's backward where its
backward does), and a CUDA graph that captured some adds them at each
replay (`fl/engine.py::ChunkGraphs`).

The zoo's autograd collectives, for a sum whose terms live on the ranks
of a group (`shard_map`'s `psum` under `jax.grad`, where each rank's
program is a piece of one global function):
  * `psum_partial`: partial results summed over the group (the expert
    combine over `model`); the gradient of each rank's partial is the
    sum's own, passed through unchanged;
  * `grad_psum`: the identity on a tensor that every rank of the group
    holds alike (the tokens and the router under expert parallelism);
    its gradient is summed over the group, since each rank used it for
    its part of the function;
  * `psum_shared`: a sum over the group whose result every rank then
    uses alike (the MoE balance statistics over the data axes); the
    gradient is summed over the group too, for the data-parallel step
    that averages the ranks' gradients afterwards.
`torch.distributed.nn.functional.all_reduce` is the last of these, and
applied to the combine it would give n times the gradients.

Tensor parallelism over the model axis (`repro_torch.models.layers.
TensorParallel`) adds `gather_shards`: the ranks' pieces of a leaf
concatenated along a dim (a column-sharded router, the kv columns of
another rank); its gradient is the rank's own piece of the cotangent,
which every rank holds whole (behind a `grad_psum` where the ranks'
cotangents are partial). Its vocab-parallel loss takes the row maximum
with `pmax`, outside autograd (the maximum cancels from the gradient).
"""
from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

SAT_AXIS = "sat"

collective_counts: Counter = Counter()


# ---------------------------------------------------------------------------
# meshes: shapes without ranks, and the world the live ones stand on


class MeshShape:
    """A mesh without devices (the reference's `AbstractMesh`): its axis
    names in order and their sizes. `shape` maps each name to its size,
    as a live mesh's `axis_sizes` does; it has no ranks, so nothing that
    needs a collective runs on it."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def __repr__(self):
        return f"MeshShape({self.shape})"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `MeshShape` or a live `DeviceMesh` (read
    through its `mesh_dim_names` and `size(i)`)."""
    if isinstance(mesh, MeshShape):
        return dict(mesh.shape)
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def is_live(mesh) -> bool:
    """Whether `mesh` has ranks (a `DeviceMesh`), not only a shape."""
    return mesh is not None and not isinstance(mesh, MeshShape)


def init_world(device) -> bool:
    """Start the default process group where none exists, on `device`'s
    backend (NCCL for "cuda", gloo for "cpu"): from the environment that
    `torchrun` sets (``env://``), else a world of one on an in-process
    store (`dist.HashStore`, no port). Binds a CUDA rank to its card.
    Returns whether it started the group: the caller that started it ends
    it (`torch.distributed.destroy_process_group`)."""
    dev = resolve_device(device)
    started = False
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "TORCHELASTIC_RUN_ID" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        started = True
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    return started


# ---------------------------------------------------------------------------
# the simulation mesh


def sim_mesh(num_devices: Optional[int] = None, *, axis: str = SAT_AXIS,
             device=None):
    """1-D `DeviceMesh` over the satellite axis, on every rank of the
    default process group. `num_devices` above the world size clips to it,
    as the reference's clips to the devices there are; below it raises,
    since a rank outside the mesh would run no shard.

    With no group initialized this starts one itself (`init_world`): a
    world of one on an in-process store, where a single-device mesh is
    valid and runs the sharded path with trivial collectives, or under
    `torchrun` the world it describes. Under `torch.multiprocessing.spawn`
    the caller's group is taken as it is. `device=None` means "cuda"
    (NCCL) and raises without a card; ``device="cpu"`` is the only way to
    a gloo mesh. The caller ends the group
    (`torch.distributed.destroy_process_group`)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    init_world(dev)
    world = dist.get_world_size()
    if num_devices is not None and int(num_devices) < world:
        raise ValueError(f"sim_mesh(num_devices={num_devices}) is below "
                         f"the world size {world}: every rank of the "
                         "default group holds a shard")
    return DeviceMesh(dev.type, list(range(world)), mesh_dim_names=(axis,))


def mesh_size(mesh) -> int:
    """Device count of a mesh (the satellite-axis shard count)."""
    return int(mesh.size())


def sat_sharding(mesh):
    """DTensor placements of an array whose leading axis is the
    satellite axis, sharded along the mesh's first axis (the reference's
    `NamedSharding(mesh, P(mesh.axis_names[0]))`): `Shard(0)` on that mesh
    dim, `Replicate()` on any other."""
    from torch.distributed.tensor import Replicate, Shard
    names = (mesh.axis_names if isinstance(mesh, MeshShape)
             else mesh.mesh_dim_names)
    return (Shard(0),) + (Replicate(),) * (len(names) - 1)


def axes_group(mesh, axes):
    """The process group over `axes` of a live mesh: the axis's own for
    one name, the axes flattened into one (outermost first, as a spec
    entry splits a dim) for several, e.g. ("pod", "data")."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten("_".join(axes)).get_group()


def mesh_axis(mesh):
    """The process group of the mesh's satellite axis: the `axis` the
    transitions and the collectives here take."""
    return mesh.get_group(mesh.mesh_dim_names[0])


def local_slice(total: int, axis) -> slice:
    """The rank's columns of a satellite axis of `total` (a multiple of
    the axis's size, `padded_size`)."""
    n, r = dist.get_world_size(axis), dist.get_rank(axis)
    per = total // n
    return slice(r * per, (r + 1) * per)


def local(x: torch.Tensor, axis) -> torch.Tensor:
    """The rank's columns of `x` along its last (satellite) axis, a view
    (`x` itself when `axis` is None)."""
    if axis is None:
        return x
    s = local_slice(x.shape[-1], axis)
    return x.narrow(-1, s.start, s.stop - s.start)


# ---------------------------------------------------------------------------
# satellite-axis padding (never-connected satellites: trajectory-inert)


def padded_size(K: int, mesh) -> int:
    """Smallest multiple of the mesh's device count >= K."""
    n = mesh_size(mesh)
    return -(-int(K) // n) * n


def pad_axis(arr, total: int, *, axis: int = -1, fill=0):
    """Pad `arr` with `fill` along `axis` up to length `total` (host
    numpy). The fill values model satellites that do not exist: False
    connectivity/alive rows, zero grants."""
    arr = np.asarray(arr)
    pad = total - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis if axis >= 0 else arr.ndim + axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def pad_state(state, total: int):
    """Extend a (..., K) `SatState` to `total` satellites that were never
    seeded (version/pending/buffered -1, zero progress/relay). With
    all-False connectivity columns the padding is trajectory-inert: no
    upload (nothing pending), no download (never connected), no idle or
    buffer contribution, no fault revive, and self-loop ISL entries
    neither offer nor adopt anything."""
    pad = total - state.version.shape[-1]
    if pad <= 0:
        return state

    def ext(x, fill):
        return torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], -1)
    return type(state)(*(None if x is None else ext(x, -1 if j < 3 else 0)
                         for j, x in enumerate(state)))


# ---------------------------------------------------------------------------
# collectives (the identity when `axis` is None)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the axis's ranks of an int32 tensor (exact), a new
    tensor."""
    if axis is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=axis)
    collective_counts["psum"] += 1
    return y


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Maximum over the axis's ranks of `x`, a new tensor: an int32
    tensor, or a float one that holds no gradient (the vocab-parallel
    loss's row maximum)."""
    if axis is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis)
    collective_counts["pmax"] += 1
    return y


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """The ranks' `x` concatenated in rank order along the last
    (satellite) axis: a (..., K/n) shard becomes (..., K), as
    `jax.lax.all_gather(..., tiled=True)` does for the reference's (K,)
    rows and `out_specs=P(..., ax)` for its sharded outputs. bool goes
    over the wire as uint8 (neither backend reduces bool, NCCL has no
    bool type)."""
    if axis is None:
        return x
    src = x.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(axis))]
    dist.all_gather(parts, wire, group=axis)
    collective_counts["all_gather"] += 1
    out = torch.cat(parts, dim=-1)
    return out.view(torch.bool) if src.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# the zoo's float collectives, with their gradients


class _AllReduce(torch.autograd.Function):
    """Forward: the group's sum (or the identity); backward: the
    identity (or the group's sum). `kind` names it in
    `collective_counts`."""

    @staticmethod
    def forward(ctx, x, group, fwd: bool, bwd: bool, kind: str):
        ctx.group, ctx.bwd, ctx.kind = group, bwd, kind
        if not fwd:
            return x.view_as(x)
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        collective_counts[kind] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        if not ctx.bwd:
            return g, None, None, None, None
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        collective_counts[ctx.kind + "_grad"] += 1
        return g, None, None, None, None


def psum_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of each rank's partial `x`; its gradient is
    the cotangent itself on every rank (`shard_map`'s `psum` of partial
    terms)."""
    return _AllReduce.apply(x, group, True, False, "psum_partial")


def grad_psum(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, which every rank of `group` holds alike; its gradient is the
    sum over the group of the ranks' cotangents."""
    return _AllReduce.apply(x, group, False, True, "grad_psum")


def psum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group`, used alike by every rank; the gradient is
    summed over the group too (for a step that averages its ranks'
    gradients afterwards)."""
    return _AllReduce.apply(x, group, True, True, "psum_shared")


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group` in place, outside autograd (a gradient sum, a
    bf16 partial product). Returns `x`."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    collective_counts["all_reduce"] += 1
    return x


class _GatherShards(torch.autograd.Function):
    """Forward: the group's pieces concatenated along `dim` in rank
    order; backward: the rank's own piece of the (whole) cotangent."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.r, ctx.size = dim, r, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        collective_counts["gather_shards"] += 1
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.size, ctx.size), None, None


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from every rank's equal piece `x` along `dim`
    (rank k's the k-th); its gradient is the rank's piece of the
    cotangent, whole on every rank."""
    return _GatherShards.apply(x, dim % x.dim(), group)

