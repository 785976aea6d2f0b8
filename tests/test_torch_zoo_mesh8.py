"""The zoo's mesh on a spawned world of 8 gloo ranks: expert parallelism
(`repro_torch.models.moe.moe_apply_ep`), the sharded eq.-4 agg step
(`launch.steps.make_agg_step_opt(cfg, mesh)`) and the data-parallel ZeRO-1
train step (`launch.steps.make_train_step(cfg, mesh)`), each against the
reference or the port without a mesh.

One spawn runs every case (`torch.multiprocessing.spawn` over a
`FileStore`, one thread a rank, in its own subprocess and timeout, as
tests/test_torch_mesh.py's): every rank builds every mesh in the same
order, a mesh of fewer than 8 ranks leaves the others out, and each rank
pickles what it computed. Meanwhile this process runs the reference and
the port's `mesh=None` programs on the same inputs. The ranks import this
module for its port-only helpers, so the reference is imported inside the
test."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as Sh
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import mesh as CM
from repro_torch.launch import steps as TS
from repro_torch.launch.train import synthetic_lm_batch
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 8
AXES = ("data", "model")

# expert parallelism: tests/test_ep_subprocess.py's setting (reduced
# mixtral, 4 experts, capacity factor 8: no token dropped), x (4, 32, D)
EP_MESHES = ((4, 2), (2, 4))
EP_X = (4, 32)
EXPERT_LEAVES = (2, 3, 4)    # w_down, w_gate, w_up among the sorted keys
# float32 through a product, a softmax and the experts, summed over the
# data ranks in another order than the dense oracle's one program: each
# gradient leaf held to 1e-4 of its largest entry (the reference's own EP
# path parts from its dense oracle by up to 2e-4 on the router)
EP_FWD_ATOL = 3e-5
EP_GRAD_SCALE_TOL = 1e-4
# the balance loss: E·Σ_e f_e·P_e of float32 probability sums over 32-64
# tokens, in another order than the reference's (the counts are exact)
EP_AUX_RTOL = 1e-5
# the sharded agg step: whisper-base's tree at M 8, float32 params and
# updates, the product and its all-reduce in bf16; (2, 2, 2) puts the
# rows over ("pod", "data")
AGG_ARCH, AGG_M = "whisper-base", 8
AGG_MESHES = (((2, 2), AXES), ((2, 2, 2), ("pod",) + AXES))
# data parallel + ZeRO-1: B 8 in 2 microbatches of 4 rows (one row a rank
# at data 4), S 32, two steps; mixtral with one routing group a sequence
DP_MESHES = ((2, 1), (4, 1))
DP_ARCHS = ("qwen3-8b", "mixtral-8x7b")
DP_BATCH, DP_SEQ, DP_MICRO, DP_STEPS, DP_LR = 8, 32, 2, 2, 3e-4


def ep_config():
    return dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                               moe_capacity_factor=8.0)


def ep_inputs(cfg):
    """MoE params (the reference's tree, numpy float32) and x (B, S, D)
    from a seed; the norm's scale near 1 so its gradient is exercised."""
    rng = np.random.default_rng(0)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    params = {"norm": {"scale": 1.0 + normal((d,), 0.1)},
              "router": normal((d, e), d ** -0.5),
              "w_gate": normal((e, d, f), d ** -0.5),
              "w_up": normal((e, d, f), d ** -0.5),
              "w_down": normal((e, f, d), f ** -0.5)}
    return params, normal(EP_X + (d,), 1.0)


def _mesh(shape, names=AXES):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
    return mesh if mesh.get_coordinate() is not None else None


def _ep_rank(shape):
    """This rank's EP forward on its rows and model window, the
    gradients of sum(y^2) over its rows, and those of its share of the
    balance loss, aux / n_data (the ranks' shares sum to the loss aux,
    the mean over the data shards of each shard's aux; its gradient
    passes through `psum_shared`'s backward)."""
    mesh = _mesh(shape)
    cfg = ep_config()
    params, x = ep_inputs(cfg)
    d, m = Sh.coordinate(mesh)["data"], Sh.coordinate(mesh)["model"]
    el = cfg.num_experts // shape[1]
    rows = EP_X[0] // shape[0]
    local = {k: (v[m * el:(m + 1) * el] if k.startswith("w_") else v)
             for k, v in params.items()}
    leaves, structure = tree_flatten(local)
    live = [torch.tensor(a, requires_grad=True) for a in leaves]
    xl = torch.tensor(x[d * rows:(d + 1) * rows], requires_grad=True)
    y, aux = TM.moe_apply_ep(tree_unflatten(structure, live), xl, cfg, mesh)
    inputs = live + [xl]
    gy = torch.autograd.grad((y ** 2).sum(), inputs, retain_graph=True)
    ga = torch.autograd.grad(aux / shape[0], inputs, allow_unused=True)
    ga = [torch.zeros_like(t) if g is None else g for g, t in zip(ga, inputs)]
    return {"coord": (d, m), "y": y.detach().numpy(), "aux": aux.item(),
            "grads": [g.numpy() for g in gy[:-1]], "gx": gy[-1].numpy(),
            "aux_grads": [g.numpy() for g in ga[:-1]],
            "aux_gx": ga[-1].numpy()}


def agg_inputs(cfg):
    """The agg step's whole inputs: params (the port's init), M updates a
    leaf and staleness, from seeds."""
    params = TT.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    updates = [torch.tensor(0.01 * rng.standard_normal(
        (AGG_M,) + tuple(p.shape)), dtype=p.dtype) for p in
        tree_leaves(params)]
    _, structure = tree_flatten(params)
    stal = torch.tensor(rng.integers(0, 9, AGG_M).astype(np.int32))
    return params, tree_unflatten(structure, updates), stal


def agg_pieces(cfg, mesh):
    """Per leaf, the specs of the rank's pieces: the param's (model
    shards) and its updates' (rows over the data axes, model shards as
    the param's)."""
    params, _, _ = agg_inputs(cfg)
    pspecs = tree_leaves(Sh.param_specs(params, cfg, mesh),
                         is_leaf=Sh.is_spec)
    return [(ps, Sh.spec_of(Sh.data_axes(mesh), *ps)) for ps in pspecs]


def _agg_rank(shape, names):
    mesh = _mesh(shape, names)
    if mesh is None:
        return None
    cfg = get_config(AGG_ARCH).reduced()
    params, updates, stal = agg_inputs(cfg)
    pieces = agg_pieces(cfg, mesh)
    structure = tree_flatten(params)[1]
    lp = tree_unflatten(structure, [Sh.local_shard(p, ps, mesh) for p, (
        ps, _) in zip(tree_leaves(params), pieces)])
    lu = tree_unflatten(structure, [Sh.local_shard(u, us, mesh) for u, (
        _, us) in zip(tree_leaves(updates), pieces)])
    new = TS.make_agg_step_opt(cfg, mesh)(lp, lu, stal)
    return {"coord": Sh.coordinate(mesh),
            "new": [t.numpy() for t in tree_leaves(new)]}


def dp_shape():
    return ShapeConfig("t", seq_len=DP_SEQ, global_batch=DP_BATCH,
                       kind="train")


def dp_run(arch, mesh):
    """DP_STEPS steps of `build`'s train step (moe_groups -1) on `mesh`
    (None: one device): per step (loss, grad_norm), then the params and
    the AdamW state, as numpy."""
    cfg = get_config(arch).reduced()
    fn, _, _, _ = TS.build(cfg, dp_shape(), mesh, num_micro=DP_MICRO,
                           moe_groups=-1)
    params = TT.init_params(0, cfg, device="cpu")
    opt = TS.init_opt_state(params, cfg, mesh)
    metrics = []
    for s in range(DP_STEPS):
        params, opt, m = fn(params, opt, synthetic_lm_batch(
            cfg, dp_shape(), s, device="cpu"))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics,
            "params": [t.numpy() for t in tree_leaves(params)],
            "m": [t.numpy() for t in tree_leaves(opt["m"])],
            "v": [t.numpy() for t in tree_leaves(opt["v"])],
            "step": opt["step"].item()}


def _dp_rank(shape, arch):
    mesh = _mesh(shape)
    if mesh is None:
        return None
    out = dp_run(arch, mesh)
    cfg = get_config(arch).reduced()
    out["coord"] = Sh.coordinate(mesh)
    out["dims"] = TS.zero1_dims(TT.init_params(0, cfg, device="meta"), cfg,
                                mesh)
    return out


def _rank(rank, world, out_dir):
    """One rank of the spawned world: every case in one order, pickled to
    ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    out = {}
    for shape in EP_MESHES:
        out["ep", shape] = _ep_rank(shape)
    for shape, names in AGG_MESHES:
        out["agg", shape] = _agg_rank(shape, names)
    for shape in DP_MESHES:
        for arch in DP_ARCHS:
            out["dp", shape, arch] = _dp_rank(shape, arch)
    out["collectives"] = dict(CM.collective_counts)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


_SCRIPT = textwrap.dedent("""
    import sys
    import torch.multiprocessing as mp
    from tests.test_torch_zoo_mesh8 import _rank

    if __name__ == "__main__":
        world = int(sys.argv[2])
        mp.spawn(_rank, args=(world, sys.argv[1]), nprocs=world)
        print("ZOO_MESH8_OK")
""")


def _reference_ep():
    """The reference's dense oracle on the EP inputs: y and the gradients
    of sum(y^2) by params (in tree order) and by x; and, for each data
    size of EP_MESHES, the reference's EP balance loss (the mean over the
    data shards of `moe_apply`'s aux on each shard's rows, as its
    `moe_apply_ep` defines it) and its gradients by params and by x."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as rget
    from repro.models import moe as RM
    cfg = dataclasses.replace(rget("mixtral-8x7b").reduced(),
                              moe_capacity_factor=8.0)
    params, x = ep_inputs(ep_config())
    p, xj = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    y = RM.moe_apply_dense(p, xj, cfg)
    gp, gx = jax.grad(lambda p_, x_: jnp.sum(
        RM.moe_apply_dense(p_, x_, cfg) ** 2), argnums=(0, 1))(p, xj)
    aux = {}
    for nd in {shape[0] for shape in EP_MESHES}:
        def loss(p_, x_, nd=nd):
            return sum(RM.moe_apply(p_, s, cfg)[1]
                       for s in jnp.split(x_, nd)) / nd
        a, (ap, ax) = jax.value_and_grad(loss, argnums=(0, 1))(p, xj)
        aux[nd] = (float(a), [np.asarray(g) for g in jax.tree.leaves(ap)],
                   np.asarray(ax))
    return (np.asarray(y), [np.asarray(g) for g in jax.tree.leaves(gp)],
            np.asarray(gx), aux)


def _close_to_scale(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _check_ep(ranks, ref):
    """Rows by data index, gradients summed over the data ranks (experts:
    each model rank's window) against the dense oracle's, and the balance
    loss and its gradients against the reference's EP aux; never scaled
    by the model ranks."""
    y_ref, g_ref, gx_ref, aux_ref = ref
    for shape in EP_MESHES:
        outs = [r["ep", shape] for r in ranks]
        nd, nm = shape
        rows, el = EP_X[0] // nd, ep_config().num_experts // nm
        for o in outs:
            d, m = o["coord"]
            sl = slice(d * rows, (d + 1) * rows)
            np.testing.assert_allclose(o["y"], y_ref[sl], rtol=0,
                                       atol=EP_FWD_ATOL, err_msg=f"{shape}")
            _close_to_scale(o["gx"], gx_ref[sl], EP_GRAD_SCALE_TOL,
                            f"{shape} dx rows {sl}")
            _close_to_scale(o["aux_gx"], aux_ref[nd][2][sl],
                            EP_GRAD_SCALE_TOL, f"{shape} aux dx rows {sl}")
        for key, want_leaves in (("grads", g_ref),
                                 ("aux_grads", aux_ref[nd][1])):
            for i in range(len(want_leaves)):
                for m in range(nm):
                    got = sum(o[key][i] for o in outs
                              if o["coord"][1] == m)
                    want = want_leaves[i]
                    if i in EXPERT_LEAVES:
                        want = want[m * el:(m + 1) * el]
                    _close_to_scale(got, want, EP_GRAD_SCALE_TOL,
                                    f"{shape} {key} leaf {i} model rank "
                                    f"{m}")
        auxes = {o["aux"] for o in outs}
        assert len(auxes) == 1, auxes                   # the pmean
        np.testing.assert_allclose(auxes.pop(), aux_ref[nd][0],
                                   rtol=EP_AUX_RTOL, err_msg=f"{shape} aux")


def test_zoo_mesh_8_ranks_spawned(tmp_path):
    """8 gloo ranks in one spawned world (its own subprocess and
    timeout): `moe_apply_ep` at (4, 2) and (2, 4) against the reference's
    dense oracle (forward within EP_FWD_ATOL, gradients of sum(y^2)
    summed over the data ranks within EP_GRAD_SCALE_TOL of its leaves'
    scale) and its balance loss against the reference's EP aux (value
    within EP_AUX_RTOL, gradients as those of sum(y^2)); the sharded agg step at (2, 2) and (2, 2, 2) against the
    port's `mesh=None` step on the same pieces (bf16 products, the
    launch-tools test's bf16 tolerance); the DP + ZeRO-1 train step at
    (2, 1) and (4, 1) for reduced qwen3-8b and mixtral against `mesh=None`
    within tests/test_torch_zoo_train.py's tolerances, every rank's
    params equal and its moment pieces the same rows of `mesh=None`'s."""
    from test_torch_zoo_train import (LOSS, MOMENT_SCALE_TOL,
                                      PARAMS_ATOL, PARAMS_ILL_SHARE)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    deadline = time.monotonic() + 240
    with open(tmp_path / "out.txt", "w") as out, \
            open(tmp_path / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, str(tmp_path), str(RANKS)],
            stdout=out, stderr=err, cwd=ROOT, env=env)
        try:
            ref_ep = _reference_ep()
            none = {arch: dp_run(arch, None) for arch in DP_ARCHS}
            cfg = get_config(AGG_ARCH).reduced()
            params, updates, stal = agg_inputs(cfg)
            whole = [t.numpy() for t in tree_leaves(
                TS.make_agg_step_opt(cfg)(params, updates, stal))]
            scale = [np.abs(u.numpy()).sum(0).max()
                     for u in tree_leaves(updates)]
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, (tmp_path / "err.txt").read_text()[-3000:]
    assert "ZOO_MESH8_OK" in (tmp_path / "out.txt").read_text()
    ranks = []
    for k in range(RANKS):
        with open(tmp_path / f"rank{k}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    _check_ep(ranks, ref_ep)

    for shape, names in AGG_MESHES:
        sizes = dict(zip(names, shape))
        outs = [r["agg", shape] for r in ranks if r["agg", shape]]
        assert len(outs) == int(np.prod(shape))
        for o in outs:
            for i, (got, want) in enumerate(zip(o["new"], whole)):
                ps = tree_leaves(Sh.param_specs(
                    params, cfg, CM.MeshShape(shape, names)),
                    is_leaf=Sh.is_spec)[i]
                for d, entry in enumerate(ps):
                    if entry is not None:
                        start, n = Sh.shard_range(want.shape[d], entry,
                                                  sizes, o["coord"])
                        want = want.take(range(start, start + n), axis=d)
                np.testing.assert_allclose(
                    got, want, rtol=2 ** -7, atol=2 ** -7 * scale[i],
                    err_msg=f"agg {shape} leaf {i} at {o['coord']}")

    for shape in DP_MESHES:
        for arch in DP_ARCHS:
            want = none[arch]
            outs = [r["dp", shape, arch] for r in ranks
                    if r["dp", shape, arch]]
            assert len(outs) == shape[0]
            for o in outs:
                tag = f"dp {shape} {arch} rank {o['coord']}"
                for (gl, gg), (wl, wg) in zip(o["metrics"],
                                              want["metrics"]):
                    np.testing.assert_allclose(gl, wl, err_msg=tag, **LOSS)
                    np.testing.assert_allclose(gg, wg, err_msg=tag, **LOSS)
                assert o["step"] == want["step"] == DP_STEPS
                beyond = total = 0
                for a, b, first in zip(o["params"], want["params"],
                                       outs[0]["params"]):
                    np.testing.assert_array_equal(a, first, err_msg=tag)
                    np.testing.assert_allclose(a, b, rtol=0, atol=DP_LR,
                                               err_msg=tag)
                    beyond += int((np.abs(a - b) > PARAMS_ATOL).sum())
                    total += a.size
                assert beyond <= PARAMS_ILL_SHARE * total, (tag, beyond)
                d = o["coord"]["data"]
                split = 0
                for key in ("m", "v"):
                    for i, (piece, full, dim) in enumerate(zip(
                            o[key], want[key], o["dims"])):
                        if dim is not None:
                            n = full.shape[dim] // shape[0]
                            full = full.take(range(d * n, (d + 1) * n),
                                             axis=dim)
                            split += 1
                        np.testing.assert_allclose(
                            piece, full, rtol=0,
                            atol=MOMENT_SCALE_TOL * np.abs(full).max(),
                            err_msg=f"{tag} {key} leaf {i}")
                assert split > 0, tag
    counts = ranks[0]["collectives"]
    for kind in ("psum_partial", "grad_psum_grad", "psum_shared",
                 "all_reduce", "gather_params"):
        assert counts.get(kind, 0) > 0, (kind, counts)

