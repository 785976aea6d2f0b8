"""The zoo's mesh on a world of one, in this process (a gloo group on an
in-process store, `launch.mesh.make_host_mesh(device="cpu")`, ended after
each test): every `build` kind on the host mesh gives the bits of
`mesh=None`, collectives and all; the host-mesh train step against the
reference's step; expert parallelism of one rank against the grouped
path; what still raises (the production meshes below 256 ranks, a live
model axis above 1 for the families and the FL round without a
tensor-parallel partition, a mesh on a machine without a card unless the CPU is
asked for).

The reference's train step constrains its microbatches to the mesh's data
axis; on jax 0.9 `repro.launch.mesh.make_host_mesh` gives `Explicit` axes,
under which that fails (ROADMAP C5), so the reference is built here on a
1x1 mesh with `Auto` axes, under `jax.set_mesh`, with its weights carried
across by `weights.zoo_params_from_numpy`."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType

from repro.configs.base import ShapeConfig as RShape
from repro.launch import steps as RS
from repro.launch.train import synthetic_lm_batch as r_batch
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro_torch import sharding as Sh
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import mesh as CM
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import synthetic_lm_batch
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.weights import (adamw_state_to_numpy, zoo_params_from_numpy,
                                 zoo_params_to_numpy)

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

TRAIN = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
STEPS = 2


@pytest.fixture
def host():
    """The host mesh of a gloo world of one, ended after the test, so no
    default group outlives it in the worker."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_host_mesh_is_world_by_one(host):
    assert host.mesh_dim_names == ("data", "model")
    assert CM.axis_sizes(host) == {"data": 1, "model": 1}
    assert Sh.coordinate(host) == {"data": 0, "model": 0}


@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_refuse_a_world_of_one(multi):
    """256 and 512 ranks or nothing; the message names the world found,
    and no group is started for it."""
    with pytest.raises(RuntimeError, match=f"world of {512 if multi else 256}"
                       " ranks.*this world has 1"):
        make_production_mesh(multi, device="cpu")
    assert not dist.is_initialized()


def test_host_mesh_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()
    assert not dist.is_initialized()


def _train(cfg, mesh, moe_groups, num_micro=2):
    fn, _, i, o = TS.build(cfg, TRAIN, mesh, num_micro=num_micro,
                           moe_groups=moe_groups)
    params = TT.init_params(0, cfg, device="cpu")
    opt = TS.init_opt_state(params, cfg, mesh)
    metrics = []
    for s in range(STEPS):
        params, opt, m = fn(params, opt, synthetic_lm_batch(cfg, TRAIN, s,
                                                            device="cpu"))
        metrics.append(m)
    return metrics, params, opt, (i, o)


@pytest.mark.parametrize("arch,moe_groups,num_micro", [
    ("qwen3-8b", 1, 2), ("qwen3-8b", 1, 1), ("mamba2-370m", 1, 2),
    ("mixtral-8x7b", -1, 2), ("mixtral-8x7b", -2, 2),
    ("qwen3-moe-30b-a3b", -2, 2)])
def test_train_step_on_the_host_mesh_equals_mesh_none(host, arch, moe_groups,
                                                      num_micro):
    """Data parallel with ZeRO-1 on one rank (every collective issued),
    and with moe_groups -2 expert parallel: two steps give `mesh=None`'s
    bits (-2 against one routing group, the expert-parallel program's
    groups on one data shard), with the shardings of the mesh."""
    cfg = get_config(arch).reduced()
    CM.collective_counts.clear()
    got = _train(cfg, host, moe_groups, num_micro)
    counts = dict(CM.collective_counts)
    want = _train(cfg, None, 1 if moe_groups == -2 else moe_groups,
                  num_micro)
    for a, b in zip(got[0], want[0]):
        _same(a, b)
    _same(got[1], want[1])
    _same(got[2], want[2])
    assert counts["all_reduce"] >= STEPS and counts["gather_params"] > 0
    if moe_groups == -2:
        assert counts["psum_partial"] > 0 and counts["grad_psum_grad"] > 0
    elif cfg.num_experts:
        assert counts["psum"] > 0 and counts["psum_shared_grad"] > 0
    ins, outs = got[3]
    assert all(isinstance(s, Sh.NamedSharding) for s in tree_leaves(
        ins, is_leaf=lambda x: isinstance(x, Sh.NamedSharding)))
    assert want[3] == (None, None) and outs[2]["loss"].spec == ()


def _agg_inputs(cfg, m=6):
    params = TT.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    leaves, structure = tree_flatten(params)
    ups = [torch.tensor(0.01 * rng.standard_normal((m,) + tuple(p.shape)),
                        dtype=p.dtype) for p in leaves]
    return (params, tree_unflatten(structure, ups),
            torch.tensor(rng.integers(0, 9, m).astype(np.int32)))


@pytest.mark.parametrize("kind", ["prefill", "decode", "agg", "agg_opt",
                                  "flround"])
def test_other_build_kinds_on_the_host_mesh_equal_mesh_none(host, kind):
    """Prefill, the serve step, both agg steps and the FL round through
    `build` on the host mesh: mesh=None's bits, and the mesh's shardings
    beside them (the agg_opt step's bf16 all-reduce runs on one rank)."""
    arch = {"flround": "mamba2-370m", "agg": "whisper-base",
            "agg_opt": "whisper-base"}.get(kind, "qwen3-8b")
    cfg = get_config(arch).reduced()
    shape = {"prefill": ShapeConfig("p", 16, 2, "prefill"),
             "decode": ShapeConfig("d", 24, 2, "decode"),
             "agg": ShapeConfig("a", 0, 6, "agg"),
             "agg_opt": ShapeConfig("a", 0, 6, "agg"),
             "flround": ShapeConfig("f", 16, 2, "flround")}[kind]
    moe_groups = -3 if kind == "agg_opt" else 1
    params = TT.init_params(0, cfg, device="cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    outs = []
    CM.collective_counts.clear()
    for mesh in (host, None):
        fn, _, i, o = TS.build(cfg, shape, mesh, moe_groups=moe_groups)
        assert (i is None) == (mesh is None)
        if kind == "prefill":
            outs.append(fn(params, {"tokens": toks}))
        elif kind == "decode":
            state = TT.init_decode_state(params, cfg, 2, 24, torch.float32)
            tok = torch.zeros((2, 1), dtype=torch.int32)
            for _ in range(3):
                tok, state = fn(params, state, tok)
            outs.append((tok, state))
        elif kind in ("agg", "agg_opt"):
            outs.append(fn(*_agg_inputs(cfg)))
        else:
            cb = {k: torch.tensor(np.random.default_rng(2).integers(
                0, cfg.vocab_size, (2, 4, 2, 16)), dtype=torch.int32)
                for k in ("tokens", "labels")}
            outs.append(fn(copy.deepcopy(params), cb,
                           torch.tensor([0, 3], dtype=torch.int32)))
    _same(outs[0], outs[1])
    if kind == "agg_opt":
        assert CM.collective_counts["all_reduce"] == len(tree_leaves(params))


def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@pytest.mark.parametrize("arch,moe_groups", [("qwen3-8b", 1),
                                             ("mixtral-8x7b", -1)])
def test_host_mesh_train_step_matches_the_reference(host, arch, moe_groups):
    """The host-mesh step (`build` on `make_host_mesh`) against the
    reference's `build` on its 1x1 mesh, from the reference's init, two
    steps at B 4 x S 32 in 2 microbatches, float32: loss and grad_norm,
    params and moments within tests/test_torch_zoo_train.py's
    tolerances."""
    from test_torch_zoo_train import (LOSS, _moments_close, _params_close)
    from repro.configs.base import get_config as rget
    rc, tc = rget(arch).reduced(), get_config(arch).reduced()
    rshape = RShape("t", seq_len=32, global_batch=4, kind="train")
    mesh = _ref_mesh()
    ref = []
    with jax.set_mesh(mesh):
        fn, _, _, _ = RS.build(rc, rshape, mesh, num_micro=2,
                               moe_groups=moe_groups)
        step = jax.jit(fn)
        rp = RT.init_params(jax.random.PRNGKey(0), rc)
        start = jax.tree.map(np.asarray, rp)
        ro = r_adamw_init(rp)
        for s in range(STEPS):
            rp, ro, m = step(rp, ro, r_batch(rc, rshape, s))
            ref.append((float(m["loss"]), float(m["grad_norm"]),
                        jax.tree.map(np.asarray, rp),
                        jax.tree.map(np.asarray, ro)))
    fn, _, _, _ = TS.build(tc, TRAIN, host, num_micro=2,
                           moe_groups=moe_groups)
    tp = zoo_params_from_numpy(start, "cpu")
    to = TS.init_opt_state(tp, tc, host)
    for s, (rl, rg, rparams, ropt) in enumerate(ref):
        tp, to, m = fn(tp, to, synthetic_lm_batch(tc, TRAIN, s,
                                                  device="cpu"))
        np.testing.assert_allclose(m["loss"].item(), rl, **LOSS)
        np.testing.assert_allclose(m["grad_norm"].item(), rg, **LOSS)
        _params_close(zoo_params_to_numpy(tp), rparams, f"params {s}")
        got = adamw_state_to_numpy(to)
        assert got["step"] == ropt["step"] == s + 1
        _moments_close(got["m"], ropt["m"], f"m {s}")
        _moments_close(got["v"], ropt["v"], f"v {s}")


def test_expert_parallel_one_rank_equals_grouped(host):
    """`moe_apply_ep` on the (1, 1) mesh: the grouped path's output, aux
    and gradients bit for bit (one routing group, every expert local)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              moe_capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    params = TM.moe_init(g, cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    runs = []
    for ep in (True, False):
        leaves = {k: v for k, v in params.items()}
        p = {"norm": {"scale": leaves["norm"]["scale"].clone()
                      .requires_grad_()},
             **{k: v.clone().requires_grad_() for k, v in leaves.items()
                if k != "norm"}}
        xl = x.clone().requires_grad_()
        y, aux = (TM.moe_apply_ep(p, xl, cfg, host) if ep
                  else TM.moe_apply(p, xl, cfg))
        ((y ** 2).sum() + aux).backward()
        runs.append([y, aux, xl.grad] + [t.grad for t in tree_leaves(p)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


class _LiveMesh:
    """A stand-in for a live mesh of (1, 2) over (data, model): what the
    steps read before they refuse it."""
    mesh_dim_names = ("data", "model")

    def size(self, i=None):
        return (1, 2)[i] if i is not None else 2


REFUSED = ("mamba2-370m", "recurrentgemma-9b", "whisper-base",
           "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch,kind", [(a, k) for a in REFUSED
                                       for k in ("train", "prefill",
                                                 "decode")]
                         + [("qwen3-8b", "flround")])
def test_a_live_model_axis_raises(arch, kind):
    """What has no tensor-parallel partition yet: on a live mesh whose
    model axis is above 1, the steps of the four families outside the
    decoder-only attention ones raise, naming the arch and ROADMAP A.10
    part 4, and the FL round of any family raises, naming part 5."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("s", 16, 2, kind)
    match = "A.10 part 5" if kind == "flround" else f"{arch}.*A.10 part 4"
    with pytest.raises(NotImplementedError, match=match):
        TS.build(cfg, shape, _LiveMesh())
    if kind == "train":
        with pytest.raises(NotImplementedError, match=match):
            TS.make_train_step(cfg, _LiveMesh())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_expert_parallelism_beside_a_live_model_axis_raises(arch):
    """The train step with moe_groups=-2 on a live mesh whose model axis
    is above 1 (expert parallelism beside tensor parallelism, held against
    no oracle yet) raises, naming the arch and ROADMAP A.10 part 8, from
    `make_train_step` and from `build`."""
    cfg = get_config(arch).reduced()
    match = f"{arch}.*A.10 part 8"
    with pytest.raises(NotImplementedError, match=match):
        TS.make_train_step(cfg, _LiveMesh(), moe_groups=-2)
    with pytest.raises(NotImplementedError, match=match):
        TS.build(cfg, ShapeConfig("s", 16, 2, "train"), _LiveMesh(),
                 moe_groups=-2)


def test_routing_groups_must_fall_within_a_rank(host, monkeypatch):
    """A data-parallel MoE step whose routing groups do not divide over
    the data shards would change capacity and drops: it raises."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="routing groups"):
        TS.make_train_step(get_config("mixtral-8x7b").reduced(), host,
                           moe_groups=1)


def test_zero1_state_on_the_host_mesh(host):
    """`init_opt_state` on the host mesh: whole moments (one data shard),
    zeros; `zero1_dims` picks the first dim each opt spec puts on 'data'."""
    cfg = get_config("qwen3-8b").reduced()
    params = TT.init_params(0, cfg, device="cpu")
    state = TS.init_opt_state(params, cfg, host)
    for p, m in zip(tree_leaves(params), tree_leaves(state["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any()
    dims = TS.zero1_dims(params, cfg, host)
    # the model axis (of size 1) takes the embedding's dim 0, so its
    # moments split on dim 1: the strided piece and the gather a leaf at
    # a time
    assert None not in dims and 1 in dims
