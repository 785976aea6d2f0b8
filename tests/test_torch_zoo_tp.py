"""Tensor parallelism over the model axis (`repro_torch.models.layers.
TensorParallel` through the train, prefill and serve steps of
`repro_torch.launch.steps` on a live mesh) against the reference's
unsharded program, which GSPMD's partition of its jitted steps computes.

One spawned world of 8 gloo ranks runs every case (`torch.multiprocessing.
spawn` over a `FileStore`, one thread a rank, in its own subprocess and
timeout, as tests/test_torch_zoo_mesh8.py's): each rank builds every mesh
of `MESHES` in the same order (a mesh of fewer than 8 ranks leaves the
others out), takes its pieces of the params (`sharding.shard_params`),
and pickles its pieces of what it computed. Meanwhile this process runs
the reference's steps on the same params and batches. The params are
numpy draws from a seed in the reference's tree; the batches are
`synthetic_lm_batch`'s, the same numpy draws in both packages.

The reduced configs have 4 query and 2 kv heads: at model 2 a rank holds
its kv head, at model 4 it gathers the columns of the kv head its query
head reads (`TensorParallel.kv_columns`). The single-process tests below
hold the shard/unshard round trip of every arch's tree and the
vocab-parallel loss and greedy pick, over ranks simulated by threads."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import sharding as Sh
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import mesh as CM
from repro_torch.launch import steps as TS
from repro_torch.launch.train import synthetic_lm_batch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from repro_torch.weights import zoo_params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 8
AXES = ("data", "model")
MESHES = ((1, 2), (1, 4), (2, 2), (2, 4))
ARCHS = ("qwen3-8b", "gemma3-12b", "qwen3-moe-30b-a3b", "mixtral-8x7b")
# the other decoder-only attention families, at the largest mesh only
MORE_ARCHS = ("qwen3-8b-swa", "h2o-danube-1.8b", "minitron-4b")
CASES = [(shape, arch) for shape in MESHES for arch in ARCHS] + [
    ((2, 4), arch) for arch in MORE_ARCHS]
# prefill of a MoE model whose one routing group (`build`'s default
# moe_groups) does not fall within a data shard: every rank runs each row
ONE_GROUP = ((2, 1), ("qwen3-moe-30b-a3b", "mixtral-8x7b"))
# the train step: B 4 in 2 microbatches of 2 (one row a rank at data 2),
# S 32, one routing group a sequence (`build`'s moe_groups -1)
TRAIN_B, TRAIN_S, MICRO, LR = 4, 32, 2, 3e-4
# a gradient leaf gathered from the ranks' pieces, against the
# reference's: float32 through two layers, partial products summed over
# the model group in another order (1e-6 of the leaf's scale seen)
GRAD_SCALE_TOL = 1e-4
# prefill B 2 x S 16; the serve loop: B 4, an 8-token prompt stepped, 4
# greedy tokens, a 32-slot cache
PREFILL_B, PREFILL_S = 2, 16
SERVE_B, PROMPT, GEN, CACHE = 4, 8, 4, 32


def tp_config(arch):
    return get_config(arch).reduced()


def tp_params(arch):
    """The reference's tree (numpy float32) from a seed: matrices
    N(0, fan_in^-1/2), norm scales 1 + N(0, 0.1)."""
    cfg = tp_config(arch)
    rng = np.random.default_rng(7)

    def draw(path, t):
        shape = tuple(t.shape)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)
                    ).astype(np.float32)
        return (shape[-2] ** -0.5 * rng.standard_normal(shape)
                ).astype(np.float32)
    return tree_map_with_path(draw, TT.init_params(0, cfg, device="meta"))


def train_shape():
    return ShapeConfig("t", seq_len=TRAIN_S, global_batch=TRAIN_B,
                       kind="train")


def prefill_batch(cfg):
    rng = np.random.default_rng(11)
    return rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)
                        ).astype(np.int32)


def serve_prompt(cfg):
    rng = np.random.default_rng(12)
    return rng.integers(0, cfg.vocab_size, (SERVE_B, PROMPT)
                        ).astype(np.int32)


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    mesh = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=AXES)
    return mesh if mesh.get_coordinate() is not None else None


def _case(shape, arch, params_np):
    """This rank's pieces of one case: the gradients of `loss_and_grad`,
    the metrics, params and moments after one step, the prefill's logits,
    the serve loop's tokens, and the collectives it issued."""
    mesh = _mesh(shape)
    if mesh is None:
        return None
    before = Counter(CM.collective_counts)
    cfg = tp_config(arch)
    whole = zoo_params_from_numpy(params_np, "cpu")
    params = zoo_params_from_numpy(params_np, "cpu", mesh=mesh, cfg=cfg)
    out = {"coord": Sh.coordinate(mesh),
           "param_numel": [t.numel() for t in tree_leaves(params)],
           "whole_numel": [t.numel() for t in tree_leaves(whole)]}
    del whole
    fn, _, _, _ = TS.build(cfg, train_shape(), mesh, num_micro=MICRO,
                           moe_groups=-1)
    batch = synthetic_lm_batch(cfg, train_shape(), 0, device="cpu")
    loss, grads = fn.loss_and_grad(params, batch)
    out["loss"] = loss.item()
    out["grads"] = [g.numpy().copy() for g in tree_leaves(grads)]
    opt = TS.init_opt_state(params, cfg, mesh)
    params, opt, m = fn(params, opt, batch)
    out["metrics"] = (m["loss"].item(), m["grad_norm"].item())
    out["params"] = [t.numpy().copy() for t in tree_leaves(params)]
    out["m"] = [t.numpy().copy() for t in tree_leaves(opt["m"])]
    out["v"] = [t.numpy().copy() for t in tree_leaves(opt["v"])]

    params = zoo_params_from_numpy(params_np, "cpu", mesh=mesh, cfg=cfg)
    pshape = ShapeConfig("p", seq_len=PREFILL_S, global_batch=PREFILL_B,
                         kind="prefill")
    pre, _, _, _ = TS.build(cfg, pshape, mesh, moe_groups=-1)
    out["prefill"] = pre(params, {"tokens": torch.tensor(
        prefill_batch(cfg))}).numpy().copy()

    dshape = ShapeConfig("d", seq_len=CACHE, global_batch=SERVE_B,
                         kind="decode")
    serve, _, _, _ = TS.build(cfg, dshape, mesh)
    state = TS.init_serve_state(params, cfg, SERVE_B, CACHE, mesh)
    out["cache_heads"] = tree_leaves(state["caches"])[0].shape[-2]
    prompt = torch.tensor(serve_prompt(cfg))
    for t in range(PROMPT - 1):
        _, state = serve(params, state, prompt[:, t:t + 1])
    tok, toks = prompt[:, -1:], []
    for _ in range(GEN):
        tok, state = serve(params, state, tok)
        toks.append(tok.numpy().copy())
    out["serve"] = np.concatenate(toks, axis=1)
    out["collectives"] = dict(Counter(CM.collective_counts) - before)
    return out


def _one_group_prefill(shape, arch, params_np):
    """This rank's prefill logits of `build`'s step with one MoE routing
    group over the whole batch, on a mesh that splits the batch."""
    mesh = _mesh(shape)
    if mesh is None:
        return None
    cfg = tp_config(arch)
    params = zoo_params_from_numpy(params_np, "cpu", mesh=mesh, cfg=cfg)
    pshape = ShapeConfig("p", seq_len=PREFILL_S, global_batch=PREFILL_B,
                         kind="prefill")
    pre, _, _, _ = TS.build(cfg, pshape, mesh)
    return pre(params, {"tokens": torch.tensor(prefill_batch(cfg))}
               ).numpy().copy()


def _rank(rank, world, out_dir):
    """One rank of the spawned world: every case in one order, pickled to
    ``rank{rank}.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
        params = pickle.load(f)
    out = {}
    for shape, arch in CASES:
        out[shape, arch] = _case(shape, arch, params[arch])
    shape, archs = ONE_GROUP
    for arch in archs:
        out["one group", arch] = _one_group_prefill(shape, arch,
                                                    params[arch])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


_SCRIPT = textwrap.dedent("""
    import sys
    import torch.multiprocessing as mp
    from tests.test_torch_zoo_tp import _rank

    if __name__ == "__main__":
        world = int(sys.argv[2])
        mp.spawn(_rank, args=(world, sys.argv[1]), nprocs=world)
        print("ZOO_TP_OK")
""")


# ---------------------------------------------------------------------------
# the reference's unsharded program (GSPMD's partition computes it)


def _reference(arch, params_np):
    """The reference's program on one device: the mean gradient over the
    microbatches and the loss (`make_train_step`'s loss function), one
    train step's metrics, params and moments, the prefill's logits, and
    the greedy serve loop's tokens with each step's top-2 logit gap."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.base import ShapeConfig as RShape
    from repro.configs.base import get_config as rget
    from repro.launch import steps as RS
    from repro.launch.train import synthetic_lm_batch as r_batch
    from repro.models import transformer as RT
    from repro.optim import adamw_init
    rc = rget(arch).reduced()
    groups = TRAIN_B // MICRO
    mesh = jax.make_mesh((1, 1), AXES,
                         axis_types=(AxisType.Auto, AxisType.Auto))
    p = jax.tree.map(jnp.asarray, params_np)
    batch = r_batch(rc, RShape("t", seq_len=TRAIN_S, global_batch=TRAIN_B,
                               kind="train"), 0)
    out = {}
    with jax.set_mesh(mesh):
        def loss_fn(p_, mb):
            logits, aux = RT.forward(p_, mb, rc, q_chunk=16, remat=True,
                                     moe_groups=groups)
            return RT.lm_loss(logits, mb["labels"]) + 0.01 * aux
        vg = jax.jit(jax.value_and_grad(loss_fn))
        rows = TRAIN_B // MICRO
        total, gsum = 0.0, None
        for i in range(MICRO):
            mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                  for k, v in batch.items()}
            l, g = vg(p, mb)
            g = jax.tree.map(lambda a: a.astype(jnp.float32), g)
            total += float(l)
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        out["loss_and_grad"] = (total / MICRO, [
            np.asarray(a) / MICRO for a in jax.tree.leaves(gsum)])
        step = jax.jit(RS.make_train_step(rc, mesh, num_micro=MICRO,
                                          q_chunk=16, lr=LR,
                                          moe_groups=groups))
        np_, no, m = step(p, adamw_init(p), batch)
        out["metrics"] = (float(m["loss"]), float(m["grad_norm"]))
        out["params"] = [np.asarray(a) for a in jax.tree.leaves(np_)]
        out["m"] = [np.asarray(a) for a in jax.tree.leaves(no["m"])]
        out["v"] = [np.asarray(a) for a in jax.tree.leaves(no["v"])]
        pre = jax.jit(RS.make_prefill_step(rc, moe_groups=PREFILL_B))
        out["prefill"] = np.asarray(pre(p, {"tokens": jnp.asarray(
            prefill_batch(rc))}))
        if rc.num_experts:
            pre = jax.jit(RS.make_prefill_step(rc, moe_groups=1))
            out["prefill_one_group"] = np.asarray(pre(p, {
                "tokens": jnp.asarray(prefill_batch(rc))}))
    dec = jax.jit(lambda p_, s, t: RT.decode_step(p_, t, s, rc))
    state = RT.init_decode_state(p, rc, SERVE_B, CACHE, jnp.float32)
    prompt = jnp.asarray(serve_prompt(rc))
    for t in range(PROMPT - 1):
        _, state = dec(p, state, prompt[:, t:t + 1])
    tok, toks, gaps = prompt[:, -1:], [], []
    for _ in range(GEN):
        logits, state = dec(p, state, tok)
        last = np.asarray(logits[:, -1])
        top = np.sort(last, axis=-1)[:, -2:]
        gaps.append(top[:, 1] - top[:, 0])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    out["serve"] = (np.concatenate(toks, axis=1), np.stack(gaps, axis=1))
    return out


def _close_to_scale(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _assemble_leaves(outs, key, specs, sizes):
    """Per leaf, the whole array from every rank's piece under `key`."""
    return [Sh.assemble([(o["coord"], o[key][i]) for o in outs], spec, sizes)
            for i, spec in enumerate(specs)]


def test_tensor_parallel_8_ranks_spawned(tmp_path):
    """8 gloo ranks in one spawned world (its own subprocess and timeout):
    the train step, prefill and serve of reduced qwen3-8b, gemma3-12b,
    qwen3-moe-30b-a3b and mixtral-8x7b at (data, model) = (1, 2), (1, 4),
    (2, 2) and (2, 4), and of reduced qwen3-8b-swa, h2o-danube-1.8b and
    minitron-4b at (2, 4), each against the reference's unsharded program:
    loss and grad_norm within LOSS; each gradient leaf, gathered from the
    ranks' pieces, within GRAD_SCALE_TOL of its largest entry; after one
    AdamW step the moments within MOMENT_SCALE_TOL and the params within
    PARAMS_ATOL / PARAMS_ILL_SHARE (tests/test_torch_zoo_train.py's);
    the prefill's gathered next-token logits within LOGITS, and at
    (2, 1) those of reduced qwen3-moe-30b-a3b and mixtral-8x7b with one
    routing group over the batch (every rank runs every row); the greedy
    tokens equal wherever the reference's top-2 gap is above TIE
    (tests/test_torch_zoo_serve.py's); a rank's param and moment elements
    the whole leaf's over its specs' shards; the kv columns gathered at
    model 4 and not at model 2."""
    from test_torch_zoo_serve import LOGITS, TIE
    from test_torch_zoo_train import (LOSS, MOMENT_SCALE_TOL, PARAMS_ATOL,
                                      PARAMS_ILL_SHARE)
    params = {arch: tp_params(arch) for arch in ARCHS + MORE_ARCHS}
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    deadline = time.monotonic() + 300
    with open(tmp_path / "out.txt", "w") as out, \
            open(tmp_path / "err.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, str(tmp_path), str(RANKS)],
            stdout=out, stderr=err, cwd=ROOT, env=env)
        try:
            refs = {arch: _reference(arch, params[arch])
                    for arch in ARCHS + MORE_ARCHS}
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, (tmp_path / "err.txt").read_text()[-3000:]
    assert "ZOO_TP_OK" in (tmp_path / "out.txt").read_text()
    ranks = []
    for k in range(RANKS):
        with open(tmp_path / f"rank{k}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    for shape, arch in CASES:
        mesh = CM.MeshShape(shape, AXES)
        sizes = CM.axis_sizes(mesh)
        tag = f"{arch} at {shape}"
        cfg, ref = tp_config(arch), refs[arch]
        outs = [r[shape, arch] for r in ranks if r[shape, arch]]
        assert len(outs) == int(np.prod(shape)), tag
        meta = TT.init_params(0, cfg, device="meta")
        pspecs = tree_leaves(Sh.param_specs(meta, cfg, mesh),
                             is_leaf=Sh.is_spec)
        ospecs = [Sh.opt_spec_from_param(ps, t.shape, mesh)
                  for ps, t in zip(pspecs, tree_leaves(meta))]

        # the train step's loss, gradient, metrics and state
        for o in outs:
            np.testing.assert_allclose(o["loss"], ref["loss_and_grad"][0],
                                       err_msg=tag, **LOSS)
            for got, want in zip(o["metrics"], ref["metrics"]):
                np.testing.assert_allclose(got, want, err_msg=tag,
                                           **LOSS)
        for i, (got, want) in enumerate(zip(_assemble_leaves(
                outs, "grads", pspecs, sizes), ref["loss_and_grad"][1])):
            _close_to_scale(got, want, GRAD_SCALE_TOL,
                            f"{tag} gradient leaf {i}")
        for key, specs in (("m", ospecs), ("v", ospecs)):
            for i, (got, want) in enumerate(zip(_assemble_leaves(
                    outs, key, specs, sizes), ref[key])):
                _close_to_scale(got, want, MOMENT_SCALE_TOL,
                                f"{tag} {key} leaf {i}")
        beyond = total = 0
        for i, (got, want) in enumerate(zip(_assemble_leaves(
                outs, "params", pspecs, sizes), ref["params"])):
            np.testing.assert_allclose(got, want, rtol=0, atol=LR,
                                       err_msg=f"{tag} param {i}")
            beyond += int((np.abs(got - want) > PARAMS_ATOL).sum())
            total += got.size
        assert beyond <= PARAMS_ILL_SHARE * total, (tag, beyond)

        # memory: each piece the whole leaf over its specs' shards
        for o in outs:
            for i, (n, whole) in enumerate(zip(o["param_numel"],
                                               o["whole_numel"])):
                assert n * Sh.NamedSharding(mesh, pspecs[i]).shards() \
                    == whole, (tag, i)
                assert o["m"][i].size * Sh.NamedSharding(
                    mesh, ospecs[i]).shards() == whole, (tag, i)

        # prefill: rows over data, vocab over model
        bspec = "data" if PREFILL_B % shape[0] == 0 else None
        logits = Sh.assemble([(o["coord"], o["prefill"]) for o in outs],
                             Sh.spec_of(bspec, "model"), sizes)
        np.testing.assert_allclose(logits, ref["prefill"],
                                   err_msg=f"{tag} prefill", **LOGITS)

        # serve: every rank returns the whole token
        want, gaps = ref["serve"]
        for o in outs:
            assert o["serve"].shape == want.shape, tag
            np.testing.assert_array_equal(o["serve"], outs[0]["serve"])
            assert o["cache_heads"] == (
                1 if shape[1] > 1 else cfg.num_kv_heads), tag
        for b in range(SERVE_B):
            parted = np.nonzero(outs[0]["serve"][b] != want[b])[0]
            if parted.size:
                t = int(parted[0])
                assert gaps[b, t] < TIE, (tag, b, t, gaps[b, t])

        counts = outs[0]["collectives"]
        assert counts.get("psum_partial", 0) > 0, (tag, counts)
        assert counts.get("grad_psum_grad", 0) > 0, (tag, counts)
        if not cfg.num_experts:    # the router is gathered in MoE
            assert bool(counts.get("gather_shards")) == (
                shape[1] == 4), (tag, counts)

    shape, archs = ONE_GROUP
    for arch in archs:
        outs = [r["one group", arch] for r in ranks
                if r["one group", arch] is not None]
        assert len(outs) == int(np.prod(shape)), arch
        for got in outs:
            np.testing.assert_allclose(
                got, refs[arch]["prefill_one_group"], **LOGITS,
                err_msg=f"{arch} at {shape}, one routing group")


# ---------------------------------------------------------------------------
# single process: the shard/unshard round trip, and the vocab-parallel
# loss and greedy pick over ranks simulated by threads


ALL_ARCHS = ("gemma3-12b", "h2o-danube-1.8b", "mamba2-370m", "minitron-4b",
             "mixtral-8x7b", "phi-3-vision-4.2b", "qwen3-8b", "qwen3-8b-swa",
             "qwen3-moe-30b-a3b", "recurrentgemma-9b", "whisper-base")


def _coordinates(mesh):
    """Every coordinate ({axis: index}) of a `MeshShape`, in rank order
    (the last axis the fastest)."""
    names = mesh.axis_names
    return [dict(zip(names, idx))
            for idx in np.ndindex(*(mesh.shape[a] for a in names))]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shard_then_unshard_round_trips(arch):
    """`shard_params` at every coordinate of (2, 4) and (2, 2, 2), then
    `unshard_params`, gives back every arch's reduced tree; a piece is its
    own copy, of the whole leaf's elements over the spec's shards."""
    cfg = get_config(arch).reduced()
    params = TT.init_params(0, cfg, device="cpu")
    meta = TT.init_params(0, cfg, device="meta")
    for shape, names in (((2, 4), AXES), ((2, 2, 2), ("pod",) + AXES)):
        mesh = CM.MeshShape(shape, names)
        pieces = [(c, Sh.shard_params(params, cfg, mesh, coords=c))
                  for c in _coordinates(mesh)]
        specs = tree_leaves(Sh.param_specs(meta, cfg, mesh),
                            is_leaf=Sh.is_spec)
        for _, tree in pieces:
            for p, whole, spec in zip(tree_leaves(tree),
                                      tree_leaves(params), specs):
                assert p.numel() * Sh.NamedSharding(mesh, spec).shards() \
                    == whole.numel()
                assert p.untyped_storage().nbytes() == p.numel() * 4
        back = Sh.unshard_params([(c, tree_map(lambda t: t.numpy(), tree))
                                  for c, tree in pieces], cfg, mesh, meta)
        for got, want in zip(tree_leaves(back), tree_leaves(params)):
            np.testing.assert_array_equal(got, want.numpy())


class _ThreadGroup:
    """A process group of `n` ranks that are threads of this process: the
    collectives of `torch.distributed` that `core/mesh.py` calls, on
    values exchanged through shared slots between two barriers."""

    def __init__(self, n):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)
        self.local = threading.local()

    def exchange(self, t):
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def run(self, fn):
        out, errors = [None] * self.n, []

        def one(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:       # reported after the join
                errors.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def thread_dist(monkeypatch):
    """`torch.distributed`'s rank, size, all-reduce and all-gather on a
    `_ThreadGroup`."""
    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        parts = group.exchange(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = torch.maximum(acc, p) if op == dist.ReduceOp.MAX \
                else acc + p
        t.copy_(acc)

    def all_gather(out, t, group=None):
        for o, p in zip(out, group.exchange(t)):
            o.copy_(p)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: group.n)
    monkeypatch.setattr(dist, "get_rank",
                        lambda group=None: group.local.rank)
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    return _ThreadGroup


def _tied_logits(V, n, seed):
    """Logits (3, 5, V) with forced ties: rows whose maximum is at two
    indices in different vocab pieces, in one piece, and at three."""
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (3, 5, V)).astype(np.float32))
    Vl = V // n
    x[0, 0, [3, Vl + 3]] = 9.0                 # across pieces 0 and 1
    x[0, 1, [(n - 1) * Vl + 1, Vl - 1]] = 9.0  # last and first piece
    x[1, 2, [Vl + 5, Vl + 7]] = 9.0            # within one piece
    x[2, 4, [2, Vl + 2, (n - 1) * Vl]] = 9.0
    return x


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_argmax_ties(thread_dist, n):
    """`TensorParallel.argmax` over n vocab pieces equals `torch.argmax`
    of the whole logits, ties (in one piece and across pieces) to the
    lowest index."""
    cfg = get_config("qwen3-8b").reduced()
    x = _tied_logits(cfg.vocab_size, n, 0)
    group = thread_dist(n)

    def rank(r):
        tp = TL.TensorParallel(cfg, group)
        return tp.argmax(x.chunk(n, dim=-1)[r])
    for got in group.run(rank):
        assert torch.equal(got, torch.argmax(x, dim=-1))


@pytest.mark.parametrize("n,masked", [(2, False), (4, False), (4, True)])
def test_vocab_parallel_loss_and_gradient(thread_dist, n, masked):
    """`transformer.lm_loss(tp=)` on n vocab pieces (the labels in every
    piece, a row with a forced tie) equals `lm_loss` of the whole logits,
    on every rank, and the ranks' gradients put together equal its
    gradient."""
    cfg = get_config("qwen3-8b").reduced()
    V = cfg.vocab_size
    x = _tied_logits(V, n, 1) * 3.0
    labels = torch.tensor(np.random.default_rng(2).integers(
        0, V, (3, 5)).astype(np.int32))
    labels[0, 0] = V - 1
    mask = (torch.tensor(np.random.default_rng(3).random((3, 5)) < 0.7)
            if masked else None)
    whole = x.clone().requires_grad_()
    want = TT.lm_loss(whole, labels, mask)
    want.backward()
    group = thread_dist(n)

    def rank(r):
        tp = TL.TensorParallel(cfg, group)
        piece = x.chunk(n, dim=-1)[r].clone().requires_grad_()
        loss = TT.lm_loss(piece, labels, mask, tp=tp)
        loss.backward()
        return loss.detach(), piece.grad
    outs = group.run(rank)
    for loss, _ in outs:
        np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    np.testing.assert_allclose(torch.cat([g for _, g in outs], -1),
                               whole.grad, rtol=0, atol=1e-7)


def test_a_query_head_count_that_does_not_divide_raises(thread_dist):
    """minitron-4b's 24 query heads at model 16 raise, naming the arch
    (GSPMD would reshard there, ROADMAP C29)."""
    group = thread_dist(16)
    group.local.rank = 0
    with pytest.raises(ValueError, match="minitron-4b"):
        TL.TensorParallel(get_config("minitron-4b"), group)


@pytest.mark.parametrize("arch,model", [("qwen3-moe-30b-a3b", 8),
                                        ("gemma3-12b", 16),
                                        ("qwen3-8b", 16)])
def test_kv_heads_of_a_rank(thread_dist, arch, model):
    """Where the kv heads do not split over the model axis, a rank's kv
    heads are those its query heads read: one for qwen3-moe at 8 (32/4
    heads), gemma3 at 16 (16/8) and qwen3-8b at 16 (32/8)."""
    cfg = get_config(arch)
    group = thread_dist(model)
    G = cfg.num_heads // cfg.num_kv_heads
    for r in range(model):
        group.local.rank = r
        tp = TL.TensorParallel(cfg, group)
        assert tp.heads == cfg.num_heads // model
        assert tp.kv_heads == 1
        assert tp.kv_lo == (r * tp.heads) // G


def test_moe_on_d_ff_pieces(thread_dist):
    """Mixtral's experts at a model axis above its expert count (`param_
    spec` then cuts d_ff, the router whole): `moe.moe_apply(model_group=)`
    on each rank's d_ff pieces of every expert, over 2 ranks, equals the
    whole layer within 1e-6 of each tensor's largest entry: the output
    and aux on every rank, the input's and the router's gradients whole on
    every rank, the experts' gradients the rank's pieces of the whole
    ones."""
    from repro_torch.models import moe as TM
    cfg = get_config("mixtral-8x7b").reduced()
    n, F = 2, cfg.d_ff // 2
    params = TM.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))

    def run(p, group=None):
        p = {k: (v.clone().requires_grad_() if torch.is_tensor(v) else
                 {"scale": v["scale"].clone().requires_grad_()})
             for k, v in p.items()}
        xl = x.clone().requires_grad_()
        y, aux = TM.moe_apply(p, xl, cfg, model_group=group)
        ((y ** 2).sum() + aux).backward()
        grads = {k: (v.grad if torch.is_tensor(v) else v["scale"].grad)
                 for k, v in p.items()}
        return y.detach().numpy(), aux.item(), xl.grad.numpy(), grads
    y, aux, gx, grads = run(params)
    group = thread_dist(n)

    def rank(r):
        cut = {"w_gate": (-1, r * F), "w_up": (-1, r * F),
               "w_down": (-2, r * F)}
        piece = {k: (v.narrow(cut[k][0], cut[k][1], F) if k in cut else v)
                 for k, v in params.items()}
        return run(piece, group)
    for r, (yr, auxr, gxr, gr) in enumerate(group.run(rank)):
        # float32 sums of the ranks' partial products in another order
        _close_to_scale(yr, y, 1e-6, f"rank {r} output")
        np.testing.assert_allclose(auxr, aux, rtol=1e-6)
        _close_to_scale(gxr, gx, 1e-6, f"rank {r} input gradient")
        _close_to_scale(gr["router"].numpy(), grads["router"].numpy(),
                        1e-6, f"rank {r} router gradient")
        for k, dim in (("w_gate", -1), ("w_up", -1), ("w_down", -2)):
            _close_to_scale(gr[k].numpy(),
                            grads[k].narrow(dim, r * F, F).numpy(), 1e-6,
                            f"rank {r} {k} gradient")
