"""The model zoo's meshes (the port of `repro.launch.mesh`): the production
meshes and the host mesh, as `torch.distributed` `DeviceMesh`es over the
ranks of the default process group, and the production meshes' shapes
without ranks for the dry run.

Functions, not module constants: importing this module starts no process
group.

With no group initialised a mesh starts one itself
(`repro_torch.core.mesh.init_world`): under `torchrun` the world it
describes, else a world of one on an in-process store, NCCL on the card
and gloo only for ``device="cpu"``, as `core/mesh.py::sim_mesh` does. The
caller ends the group (`torch.distributed.destroy_process_group`)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.mesh import MeshShape, init_world
from repro_torch.device import resolve_device

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((2, 16, 16), MULTI_POD_AXES)
    return MeshShape((16, 16), AXES)


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(multi_pod: bool = False, *, device=None):
    """The production mesh (`production_mesh_shape`) as a `DeviceMesh`
    over a world of exactly 256 (512 with `multi_pod`) ranks; any other
    world raises, naming its size (no group initialised is a world of
    one, and none is started for it)."""
    shape = production_mesh_shape(multi_pod)
    need = shape.size()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{need} ranks, one a chip of the {tuple(shape.shape.values())}"
            f" mesh; this world has {world}")
    dev = resolve_device(device)
    init_world(dev)
    return _device_mesh(dev.type, tuple(shape.shape.values()),
                        shape.axis_names)


def make_host_mesh(device=None):
    """(world, 1) over ("data", "model") on every rank of the default
    group: data parallel over the ranks, one model shard (the reference's
    mesh over the host's devices). A world of one gives (1, 1)."""
    dev = resolve_device(device)
    init_world(dev)
    return _device_mesh(dev.type, (dist.get_world_size(), 1), AXES)
