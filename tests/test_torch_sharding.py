"""The zoo's sharding specs in the port (`repro_torch.sharding`, the
`*_shardings` functions of `repro_torch.launch.steps`, `default_num_micro`
and the dry run's bytes a chip) against the reference's
(`repro.sharding`, `repro.launch.steps`), as tuples of axis names, leaf by
leaf, on both production meshes. The reference's specs are computed on
`repro.core.mesh.abstract_mesh` (no devices), the port's on a
`MeshShape`; no process group is started here."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as RSh
from repro.configs.base import INPUT_SHAPES as R_SHAPES
from repro.configs.base import get_config as rget
from repro.core.mesh import abstract_mesh
from repro.launch import input_specs as RIS
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro_torch import sharding as TSh
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import get_config as tget
from repro_torch.core.mesh import MeshShape
from repro_torch.core.mesh import axis_sizes, sat_sharding
from repro_torch.launch import dryrun
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.optim import adamw_init
from repro_torch.tree import (DictKey, GetAttrKey, SequenceKey, tree_leaves,
                              tree_map_with_path)

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ARCHS = ["gemma3-12b", "h2o-danube-1.8b", "mamba2-370m", "minitron-4b",
         "mixtral-8x7b", "phi-3-vision-4.2b", "qwen3-8b", "qwen3-8b-swa",
         "qwen3-moe-30b-a3b", "recurrentgemma-9b", "whisper-base"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE_SHAPES = ("decode_32k", "long_500k")


@functools.lru_cache(maxsize=None)
def _meshes(kind):
    shape, names = MESHES[kind]
    return abstract_mesh(shape, names), MeshShape(shape, names)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = rget(arch)
    return jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0),
                                                 cfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TS._meta_params(tget(arch))


def _ref_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def _port_specs(tree):
    return tree_leaves(tree, is_leaf=TSh.is_spec)


def _ref_named(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


def _port_named(tree):
    return [s.spec for s in tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, TSh.NamedSharding))]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references(arch, mesh_kind):
    """param_specs, opt_state_specs (ZeRO-1), batch_specs of every
    applicable input shape, and decode_state_specs at decode_32k and
    long_500k with DECODE_OPT off and on."""
    rm, tm = _meshes(mesh_kind)
    rc, tc = rget(arch), tget(arch)
    rp, tp = _ref_params(arch), _port_params(arch)
    rps, tps = RSh.param_specs(rp, rc, rm), TSh.param_specs(tp, tc, tm)
    assert _port_specs(tps) == _ref_specs(rps)
    ro = jax.eval_shape(r_adamw_init, rp)
    assert _port_specs(TSh.opt_state_specs(adamw_init(tp), tps, tc, tm)) \
        == _ref_specs(RSh.opt_state_specs(ro, rps, rc, rm))
    for name, rshape in R_SHAPES.items():
        tshape = T_SHAPES[name]
        if not RIS.applicable(rc, rshape) or rshape.kind != "train":
            continue
        rb = RIS.train_batch_specs(rc, rshape)
        tb = {k: TS._meta(v) for k, v in
              TS.IS.train_batch_specs(tc, tshape).items()}
        assert _port_specs(TSh.batch_specs(tb, tm)) == \
            _ref_specs(RSh.batch_specs(rb, rm)), name
    try:
        for name in DECODE_SHAPES:
            rshape, tshape = R_SHAPES[name], T_SHAPES[name]
            if not RIS.applicable(rc, rshape):
                continue
            rstate, _ = RS.make_decode_state_shape(rc, rshape)
            tstate = TS.make_decode_state_shape(tc, tshape)
            for opt in (False, True):
                RSh.DECODE_OPT = TSh.DECODE_OPT = opt
                assert _port_specs(TSh.decode_state_specs(
                    tstate, tc, tm, tshape)) == _ref_specs(
                    RSh.decode_state_specs(rstate, rc, rm, rshape)), (
                    name, opt)
    finally:
        RSh.DECODE_OPT = TSh.DECODE_OPT = False


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-base",
                                  "qwen3-moe-30b-a3b", "recurrentgemma-9b"])
def test_shardings_functions_equal_the_references(arch, mesh_kind,
                                                  monkeypatch):
    """The five `*_shardings` functions' in and out specs, and
    `default_num_micro`, on every applicable shape of the sweep and the
    agg and FL-round shapes."""
    monkeypatch.setattr(TS, "_meta_params",
                        functools.lru_cache(None)(TS._meta_params))
    rm, tm = _meshes(mesh_kind)
    rc, tc = rget(arch), tget(arch)
    for shard_buffer in (True, False):
        _, ri, ro = RS.agg_shardings(rc, rm, buffer_m=96,
                                     shard_buffer=shard_buffer)
        _, ti, to = TS.agg_shardings(tc, tm, buffer_m=96,
                                     shard_buffer=shard_buffer)
        assert (_port_named(ti), _port_named(to)) == (_ref_named(ri),
                                                      _ref_named(ro))
    _, ri, ro = RS.fl_round_shardings(rc, rm, buffer_m=16)
    _, ti, to = TS.fl_round_shardings(tc, tm, buffer_m=16)
    assert (_port_named(ti), _port_named(to)) == (_ref_named(ri),
                                                  _ref_named(ro))
    fns = {"train": "train_shardings", "prefill": "prefill_shardings",
           "decode": "decode_shardings"}
    for name, rshape in R_SHAPES.items():
        if rshape.kind not in fns or not RIS.applicable(rc, rshape):
            continue
        tshape = T_SHAPES[name]
        _, ri, ro = getattr(RS, fns[rshape.kind])(rc, rshape, rm)
        _, ti, to = getattr(TS, fns[rshape.kind])(tc, tshape, tm)
        assert _port_named(ti) == _ref_named(ri), name
        assert _port_named(to) == _ref_named(ro), name
        assert TS.default_num_micro(tc, tshape, tm) == \
            RS.default_num_micro(rc, rshape, rm), name


def test_default_num_micro_without_a_mesh_is_one_data_shard():
    for name, shape in T_SHAPES.items():
        assert TS.default_num_micro(tget("qwen3-8b"), shape) == min(
            max(1, shape.global_batch), 16), name


def _chip_bytes_from_reference(args, shardings, mesh):
    """Bytes a chip from the reference's specs: each leaf's over the
    product of the mesh sizes its spec shards it over; the decode state's
    `index`, a 0-dim array there, is a host int in the port and counts
    nothing."""
    total = 0
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    for (path, leaf), sh in zip(leaves, jax.tree.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        if jax.tree_util.keystr(path).endswith("['index']"):
            continue
        n = 1
        for entry in tuple(sh.spec):
            for a in ((entry,) if isinstance(entry, str)
                      else (entry or ())):
                n *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "train_4k"),
                                        ("qwen3-8b", "decode_32k"),
                                        ("mamba2-370m", "long_500k"),
                                        ("whisper-base", "agg_m96")])
def test_argument_bytes_a_chip(arch, shape, mesh_kind):
    """`dryrun.chip_bytes` of `build`'s arguments equals the per-chip
    bytes the reference's specs give its arguments."""
    rm, tm = _meshes(mesh_kind)
    rc, tc = rget(arch), tget(arch)
    _, rargs, ri, _ = RS.build(rc, R_SHAPES[shape], rm)
    _, targs, ti, _ = TS.build(tc, T_SHAPES[shape], tm)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(targs)
                if isinstance(t, torch.Tensor))
    got = dryrun.chip_bytes(targs, ti)
    assert got == _chip_bytes_from_reference(rargs, ri, rm)
    assert got < whole


def test_to_named_placements():
    """A spec's DTensor placements, one a mesh dim in the mesh's order;
    a dim over ("pod", "data") takes Shard on both."""
    multi = production_mesh_shape(True)
    cases = [((None, "model"), multi, (Replicate(), Replicate(), Shard(1))),
             ((("pod", "data"), None), multi,
              (Shard(0), Shard(0), Replicate())),
             (("data", None, "model"), multi,
              (Replicate(), Shard(0), Shard(2))),
             ((), production_mesh_shape(), (Replicate(), Replicate())),
             (("model", "data"), production_mesh_shape(),
              (Shard(1), Shard(0)))]
    for spec, mesh, want in cases:
        named = TSh.to_named({"a": [spec]}, mesh)["a"][0]
        assert named.spec == spec and named.placements == want, spec
    assert TSh.to_named((("pod", "data"), None), multi).shards() == 32
    assert sat_sharding(MeshShape((4,), ("sat",))) == (Shard(0),)
    assert sat_sharding(multi) == (Shard(0), Replicate(), Replicate())


def test_mesh_shapes():
    assert axis_sizes(production_mesh_shape()) == {"data": 16, "model": 16}
    assert axis_sizes(production_mesh_shape(True)) == {
        "pod": 2, "data": 16, "model": 16}
    assert production_mesh_shape(True).size() == 512
    assert MeshShape((4, 2), ("data", "model")).shape == {"data": 4,
                                                          "model": 2}
    with pytest.raises(ValueError):
        MeshShape((4,), ("data", "model"))


def test_serve_step_keeps_its_logits_spec_under_decode_opt():
    serve = TS.make_serve_step(tget("qwen3-8b"))
    assert serve.logits_spec() is None
    try:
        TSh.DECODE_OPT = True
        assert serve.logits_spec() == (None, None, "model")
    finally:
        TSh.DECODE_OPT = False


def test_spec_of_normalises_as_partition_spec():
    for entries in [(("data",), None), (("pod", "data"),), (None, "model"),
                    ()]:
        assert TSh.spec_of(*entries) == tuple(P(*entries))


def test_tree_map_with_path_keys():
    """Dict keys, list indices and NamedTuple fields give the roles of
    JAX's DictKey, SequenceKey and GetAttrKey, path for path."""
    from repro.models.attention import KVCache as RKV
    from repro_torch.models.attention import KVCache as TKV
    tree = {"a": (3, {"z": 4}), "b": [TKV(1, 2)]}     # keys in sorted order
    paths = []
    out = tree_map_with_path(lambda p, x: paths.append(p) or x * 10, tree)
    assert out == {"a": (30, {"z": 40}), "b": [TKV(10, 20)]}
    assert tree_leaves(out) == [30, 40, 10, 20]
    assert paths[2] == (DictKey("b"), SequenceKey(0), GetAttrKey("k"))
    rpaths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        {"a": (3, {"z": 4}), "b": [RKV(1, 2)]})[0]]
    assert [[type(k).__name__ for k in p] for p in paths] == [
        [type(k).__name__ for k in p] for p in rpaths]


def test_local_shard_and_shard_range():
    sizes = {"pod": 2, "data": 4, "model": 2}
    coords = {"pod": 1, "data": 2, "model": 0}
    assert TSh.shard_range(64, ("pod", "data"), sizes, coords) == (48, 8)
    assert TSh.shard_range(64, "data", sizes, coords) == (32, 16)
    assert TSh.shard_range(64, "model", sizes, coords) == (0, 32)
