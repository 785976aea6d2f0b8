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

The reference's `shard_map` and `abstract_mesh` are shims over JAX's
changing spellings and have no counterpart here; the role of
`abstract_mesh`, a mesh without devices for the zoo's sharding specs,
belongs to the zoo's mesh (`launch/mesh.py`, `sharding.py`), still to
port.

`collective_counts` counts the collectives that ran, by kind (`psum`,
`pmax`, `all_gather`), beside `repro_torch.kernels.launch_counts`: each
function adds one where it issues its collective, and a CUDA graph that
captured some adds them at each replay (`fl/engine.py::ChunkGraphs`).
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
# the simulation mesh


def sim_mesh(num_devices: Optional[int] = None, *, axis: str = SAT_AXIS,
             device=None):
    """1-D `DeviceMesh` over the satellite axis, on every rank of the
    default process group. `num_devices` above the world size clips to it,
    as the reference's clips to the devices there are; below it raises,
    since a rank outside the mesh would run no shard.

    With no group initialized this starts a world of one itself, on an
    in-process store (`dist.HashStore`, no port): a single-device mesh is
    valid and runs the sharded path with trivial collectives. Under
    `torch.multiprocessing.spawn` or `torchrun` the caller's group is
    taken as it is. `device=None` means "cuda" (NCCL) and raises without
    a card; ``device="cpu"`` is the only way to a gloo mesh. The caller
    ends the group (`torch.distributed.destroy_process_group`)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    world = dist.get_world_size()
    if num_devices is not None and int(num_devices) < world:
        raise ValueError(f"sim_mesh(num_devices={num_devices}) is below "
                         f"the world size {world}: every rank of the "
                         "default group holds a shard")
    return DeviceMesh(dev.type, list(range(world)), mesh_dim_names=(axis,))


def mesh_size(mesh) -> int:
    """Device count of a mesh (the satellite-axis shard count)."""
    return int(mesh.size())


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
    """Maximum over the axis's ranks of an int32 tensor, a new tensor."""
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
