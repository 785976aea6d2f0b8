"""The launch tools of the port (`repro_torch.launch.{steps, roofline,
dryrun, sweep}`) against the reference's (`repro.launch.*`) on the CPU:
the eq.-4 agg step and its bf16-product form, the FL round (eq. 3 then
eq. 4), `build`'s abstract arguments, the roofline's counts, the op
counter's FLOPs against the reference's HLO count, the kernels on the meta
device, and the dry-run and sweep CLIs in subprocesses.

Parameters come from the reference's initialisers through `reduced()`
configs, carried across with `weights.zoo_params_from_numpy`; updates,
staleness and tokens are made with numpy from a seed. The reference's
steps run under plain `jax.jit` with no mesh, but `make_agg_step_opt`,
whose `shard_map` needs one: a 1x1 mesh with `Auto` axes (ROADMAP C5)."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import INPUT_SHAPES as R_SHAPES
from repro.configs.base import ShapeConfig as RShape
from repro.configs.base import get_config as rget
from repro.launch import input_specs as RIS
from repro.launch import roofline as RRL
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels import cost, launch_counts, meta_counts
from repro_torch.kernels.agg import kernel as agg_kernel
from repro_torch.kernels.agg.ops import FlatLayout, flat_tree
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.launch import roofline as TRL
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_numpy, zoo_params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma3-12b", "h2o-danube-1.8b", "mamba2-370m", "minitron-4b",
         "mixtral-8x7b", "phi-3-vision-4.2b", "qwen3-8b", "qwen3-8b-swa",
         "qwen3-moe-30b-a3b", "recurrentgemma-9b", "whisper-base"]
# float32: the same products and sums in another order (the float32
# tolerance of tests/test_kernels.py)
F32 = dict(rtol=2e-5, atol=2e-5)
# a bf16 output: the float32 sums round to bf16, so where they part in
# their last bits the outputs part by one bf16 ulp, at most 2^-7 of the
# value
BF16 = dict(rtol=2 ** -7, atol=1e-6)
# the FL round in float32: two local SGD steps through a model of one or
# two layers and its backward in either framework, then eq. 4; each leaf
# held to 1e-4 of the largest entry of the reference's aggregated update
# (1e-6 of it seen), beside two float32 roundings of the param itself
# (an SGD step's and eq. 4's add: one ulp of 1.0, a norm's scale, is
# 2^-23 of it)
ROUND_SCALE_TOL = 1e-4
ROUND_RTOL = 2 ** -22
# the reference's sweep of (arch x shape) pairs: agg and flround shapes
# too, which `build` takes
SHAPES = list(R_SHAPES)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype="float32"):
    rc = rget(arch).reduced(param_dtype=dtype)
    tc = tget(arch).reduced(param_dtype=dtype)
    return rc, tc, RT.init_params(jax.random.PRNGKey(0), rc)


def _updates(params, m, seed):
    """M updates a leaf, numpy, in the leaf's dtype (bf16 leaves as
    jnp.bfloat16), scaled to about a step's size."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (0.01 * rng.standard_normal((m,) + p.shape)).astype(
            np.asarray(p).dtype), params)


def _staleness(m, seed):
    return np.random.default_rng(seed).integers(0, 9, m).astype(np.int32)


def _pairs(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    out = []
    for a, b in zip(gl, wl):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        out.append((a.float().numpy(), b.astype(np.float32)))
    return out


# ---------------------------------------------------------------------------
# The agg steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_agg_step_matches_the_reference(arch, dtype):
    """eq. 4 over a reduced zoo tree, M 4-6, updates in the params' dtypes;
    the port's params and stack laid out as views of one buffer a dtype
    (`flat_tree`), as a full-width caller lays them, read in place."""
    m = 4 + ARCHS.index(arch) % 3
    rc, tc, rp = _ref_params(arch, dtype)
    upd = _updates(rp, m, 1)
    stal = _staleness(m, 2)
    want = jax.jit(RS.make_agg_step(rc))(rp, upd, jnp.asarray(stal))
    tp = flat_tree(zoo_params_from_numpy(_np(rp), "cpu"))
    tu = flat_tree(tp, lead=(m,))
    tree_map(lambda d, s: d.copy_(s), tp,
             zoo_params_from_numpy(_np(rp), "cpu"))
    tree_map(lambda d, s: d.copy_(s), tu, params_from_numpy(upd, "cpu"))
    groups = {}
    for p, u in zip(tree_leaves(tp), tree_leaves(tu)):
        groups.setdefault(p.dtype, []).append((p, u))
    for pairs in groups.values():
        ps, us = zip(*pairs)
        layout = FlatLayout.of(ps)
        assert layout.buffer_of(ps) is not None
        assert layout.buffer_of(us, lead=1) is not None
    got = TS.make_agg_step(tc)(tp, tu, torch.as_tensor(stal))
    tol = F32 if dtype == "float32" else BF16
    for a, b in _pairs(got, want):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "mixtral-8x7b",
                                  "whisper-base"])
def test_agg_step_opt_matches_the_reference(arch, dtype):
    """The bf16-product agg step against the reference's `shard_map` form
    on a 1x1 mesh: both round the weights and the updates to bf16 and sum
    their products in float32 into a bf16 result, which may part by one
    bf16 ulp of the weighted sum; the float32 add to the params then
    rounds to the params' dtype."""
    m = 5
    rc, tc, rp = _ref_params(arch, dtype)
    upd = _updates(rp, m, 3)
    stal = _staleness(m, 4)
    mesh = _mesh()
    with jax.set_mesh(mesh):
        want = jax.jit(RS.make_agg_step_opt(rc, mesh))(rp, upd,
                                                       jnp.asarray(stal))
    got = TS.make_agg_step_opt(tc)(zoo_params_from_numpy(_np(rp), "cpu"),
                                   params_from_numpy(upd, "cpu"),
                                   torch.as_tensor(stal))
    for (a, b), u in zip(_pairs(got, want), jax.tree.leaves(upd)):
        scale = np.abs(np.asarray(u, np.float32)).sum(0).max()
        np.testing.assert_allclose(a, b, rtol=BF16["rtol"],
                                   atol=2 ** -7 * scale)


def test_agg_steps_refuse_a_mesh():
    """On a mesh's shape (no ranks) the agg steps and their shardings take
    the mesh: `make_agg_step_opt` is the one-shard program there, and the
    two `*_shardings` give the buffer's rows over 'data' and the params'
    model shards. What they refuse: a buffer whose rows are not the
    weights' (on a live mesh, the rank's share of them)."""
    from repro_torch.launch.mesh import production_mesh_shape
    cfg = tget("qwen3-8b").reduced()
    mesh = production_mesh_shape()
    params = TT.init_params(0, cfg, device="cpu")
    upd = tree_map(lambda p: 0.01 * torch.ones((4,) + tuple(p.shape)),
                   params)
    stal = torch.arange(4, dtype=torch.int32)
    got = TS.make_agg_step_opt(cfg, mesh)(params, upd, stal)
    want = TS.make_agg_step_opt(cfg)(params, upd, stal)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    for fn, m in ((TS.agg_shardings, 96), (TS.fl_round_shardings, 16)):
        _, ins, outs = fn(cfg, mesh, buffer_m=m)
        assert ins[1] is not None and outs is not None
        (spec,) = {s.spec[0] for s in tree_leaves(
            ins[1], is_leaf=lambda x: hasattr(x, "placements"))}
        assert spec == "data"
    with pytest.raises(ValueError, match="update rows"):
        TS.make_agg_step_opt(cfg)(params, tree_map(lambda u: u[:3], upd),
                                  stal)


# ---------------------------------------------------------------------------
# The FL round


ROUND = dict(local_steps=2, client_lr=0.05)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m"])
def test_fl_round_matches_the_reference(arch):
    """M 3 clients, 2 local SGD steps each at B 2 x S 32, then eq. 4,
    float32: the reference's vmapped scan against the port's loop."""
    m, b, s = 3, 2, 32
    rc, tc, rp = _ref_params(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rc.vocab_size, (m, ROUND["local_steps"], b, s + 1))
    batches = {"tokens": toks[..., :-1].astype(np.int32),
               "labels": toks[..., 1:].astype(np.int32)}
    stal = _staleness(m, 6)
    want = jax.jit(RS.make_fl_round_step(rc, **ROUND))(
        rp, jax.tree.map(jnp.asarray, batches), jnp.asarray(stal))
    tp = zoo_params_from_numpy(_np(rp), "cpu")
    before = [t.clone() for t in tree_leaves(tp)]
    launch_counts.clear()
    got = TS.make_fl_round_step(tc, **ROUND)(
        tp, {k: torch.as_tensor(v) for k, v in batches.items()},
        torch.as_tensor(stal))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), before))
    for (a, b), p in zip(_pairs(got, want), jax.tree.leaves(rp)):
        step = np.abs(b - np.asarray(p)).max()
        assert step > 0
        np.testing.assert_allclose(a, b, rtol=ROUND_RTOL,
                                   atol=ROUND_SCALE_TOL * step)


def test_fl_round_writes_its_updates_as_rows_of_one_buffer(monkeypatch):
    """The round's updates are rows of one float32 buffer a params dtype,
    which the aggregation reads in place: one kernel call a dtype (two for
    mamba2-370m, whose A_log, D and dt_bias stay float32 in a bf16
    model)."""
    from repro_torch.kernels.agg import ops
    calls = []
    real, real_flat = ops.aggregate_flat, FlatLayout.flat

    def spy(params_flat, updates, weights, rows=None):
        calls.append((params_flat.dtype, updates.dtype, updates.shape))
        return real(params_flat, updates, weights, rows)

    def in_place(self, leaves, lead=0):
        assert self.buffer_of(leaves, lead) is not None, "a copy"
        return real_flat(self, leaves, lead)

    monkeypatch.setattr(ops, "aggregate_flat", spy)
    monkeypatch.setattr(FlatLayout, "flat", in_place)
    cfg = tget("mamba2-370m").reduced(param_dtype="bfloat16")
    params = flat_tree(TT.init_params(0, cfg, device="cpu"))
    tree_map(lambda d, s: d.copy_(s), params,
             TT.init_params(0, cfg, device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (3, 1, 2, 8),
                         generator=torch.Generator().manual_seed(0))
    TS.make_fl_round_step(cfg, local_steps=1)(
        params, {"tokens": toks, "labels": toks}, torch.zeros(3).int())
    assert sorted(str(c[0]) for c in calls) == ["torch.bfloat16",
                                                "torch.float32"]
    assert all(c[1] == torch.float32 and c[2][0] == 3 for c in calls)


# ---------------------------------------------------------------------------
# build, the roofline's counts, the op counter


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                               None)))
                  for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat}


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif isinstance(tree, int):      # the decode state's host index
        return {prefix: ((), "int32")}
    else:
        assert tree.device.type == "meta", prefix
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    out = {}
    for k, v in items:
        out.update(_port_paths(v, prefix + (k,)))
    return out


def test_build_args_match_the_reference(monkeypatch):
    """For every arch x applicable shape: `build`'s arguments are meta
    tensors with the reference's abstract arguments' tree, shapes and
    dtypes (the decode state's `index` a host int where the reference
    holds an int32 scalar), and its step is the reference's kind. (An
    arch's meta params are drawn once here, for time.)"""
    monkeypatch.setattr(TS, "_meta_params",
                        functools.lru_cache(None)(TS._meta_params))
    mesh = _mesh()
    for arch in ARCHS:
        rc, tc = rget(arch), tget(arch)
        for name in SHAPES:
            rshape, tshape = R_SHAPES[name], T_SHAPES[name]
            if not RIS.applicable(rc, rshape):
                continue
            with jax.set_mesh(mesh):
                _, rargs, _, _ = RS.build(rc, rshape, mesh)
            fn, targs, i, o = TS.build(tc, tshape)
            assert i is None and o is None and callable(fn)
            assert len(targs) == len(rargs), (arch, name)
            for ta, ra in zip(targs, rargs):
                assert _port_paths(ta) == _ref_paths(ra), (arch, name)
    with pytest.raises(ValueError, match="give the step a mesh"):
        TS.build(tget("mixtral-8x7b"), T_SHAPES["train_4k"], moe_groups=-2)
    from repro_torch.launch.mesh import production_mesh_shape
    fn, _, i, _ = TS.build(tget("mixtral-8x7b"), T_SHAPES["train_4k"],
                           production_mesh_shape(), moe_groups=-2)
    assert callable(fn) and i is not None
    fn, _, _, _ = TS.build(tget("qwen3-8b"), T_SHAPES["agg_m96"],
                           moe_groups=-3)
    assert fn.__qualname__.startswith("make_agg_step_opt")


def test_roofline_counts_equal_the_references():
    """count_params, count_active_params and model_flops, as integers, on
    every arch (full config) x shape."""
    for arch in ARCHS:
        rc, tc = rget(arch), tget(arch)
        rparams = jax.eval_shape(
            lambda: RT.init_params(jax.random.PRNGKey(0), rc))
        tparams = TT.init_params(0, tc, device="meta")
        n, a = RRL.count_params(rparams), RRL.count_active_params(rc,
                                                                  rparams)
        assert TRL.count_params(tparams) == n, arch
        assert TRL.count_active_params(tc, tparams) == a, arch
        for name in SHAPES:
            assert TRL.model_flops(tc, T_SHAPES[name], a, n) == \
                RRL.model_flops(rc, R_SHAPES[name], a, n), (arch, name)


def test_op_counter_flops_against_the_reference_hlo():
    """Reduced qwen3-8b's prefill at B 2 x S 32: the op counter's FLOPs
    and the reference's `analyze(...)["hlo_flops"]` of a plain-jit compile
    part by exactly two terms. The reference's attention is two dots over
    all S x S (query, key) pairs; the port's attention kernel counts the
    causal pairs it computes (`cost.visible_pairs`), 4 * hd a pair and
    head. The port adds its RMSNorm kernel's 4 operations an element,
    which the reference's HLO leaves to elementwise fusions. Every matrix
    product (projections, MLP, the lm_head over all positions) is the
    same in both."""
    B, S = 2, 32
    rc, tc = rget("qwen3-8b").reduced(), tget("qwen3-8b").reduced()
    rshape = RShape("p", S, B, "prefill")
    rparams = jax.eval_shape(
        lambda: RT.init_params(jax.random.PRNGKey(0), rc))
    hlo = jax.jit(RS.make_prefill_step(rc)).lower(
        rparams, RIS.prefill_batch_specs(rc, rshape)).compile().as_text()
    ref = RRL.analyze(hlo, 1)["hlo_flops"]
    fn, args, _, _ = TS.build(tc, TShape("p", S, B, "prefill"))
    with TRL.OpCounter() as counter:
        fn(*args)
    hd, H, layers = tc.resolved_head_dim, tc.num_heads, tc.num_layers
    masked = 4 * hd * B * H * (S * S - cost.visible_pairs(S, S, True, 0))
    assert counter.kernel_calls == {"rmsnorm": 4 * layers + 1,
                                    "flash_attention": layers}
    assert counter.flops == ref - layers * masked \
        + counter.kernel_flops["rmsnorm"]
    assert abs(counter.flops - ref) <= 0.01 * ref


def test_op_counter_counts_bytes_by_the_rules():
    """A view and an allocation move nothing; an op moves its inputs and
    outputs; a write into a slice moves the slice twice; an out= op does
    not read its output; a kernel's meta call adds its formula."""
    x = torch.empty(4, 8, device="meta")
    buf = torch.empty(16, 8, device="meta")
    w = torch.empty(8, 8, device="meta")
    with TRL.OpCounter() as c:
        x.t()
        torch.empty(100, device="meta")
    assert (c.bytes, c.flops, c.ops) == (0, 0, 0)
    with TRL.OpCounter() as c:
        y = x + x
    assert c.bytes == 3 * 128
    with TRL.OpCounter() as c:
        buf[2:6].copy_(y)
    assert c.bytes == 2 * 128
    with TRL.OpCounter() as c:
        torch.sub(x, x, out=y)
    assert c.bytes == 3 * 128
    with TRL.OpCounter() as c, torch.inference_mode():
        x @ w
    assert c.flops == 2 * 4 * 8 * 8
    p = torch.empty(1000, device="meta")
    u = torch.empty(3, 1000, dtype=torch.bfloat16, device="meta")
    with TRL.OpCounter() as c:
        agg_kernel.weighted_aggregate(p, u, torch.empty(3, device="meta"))
    assert (c.bytes, c.flops) == cost.agg(3, 1000, 2, 4)
    assert c.kernel_calls == {"weighted_aggregate": 1}
    terms = TRL.analyze(c, 256)
    assert terms["t_memory_s"] == c.bytes / (256 * TRL.HBM_BW)
    assert terms["collective_bytes"] == 0.0


# ---------------------------------------------------------------------------
# The kernels on the meta device


def test_kernels_on_meta_give_shapes_and_record_their_work():
    """Each wrapper's meta call returns empty meta outputs of the kernel's
    shapes and dtypes (attention's log-sum-exp too, so its backward runs
    on meta) and records `cost`'s formulas; no launch is counted."""
    meta_counts.clear()
    before = dict(launch_counts)
    meta = dict(device="meta")
    p, u = torch.empty(40, **meta), torch.empty(3, 40, **meta)
    out = agg_kernel.weighted_aggregate(p, u, torch.empty(3, **meta))
    assert out.shape == (40,) and out.dtype == torch.float32
    x = torch.empty(2, 6, 32, dtype=torch.bfloat16, **meta)
    s = torch.empty(32, dtype=torch.bfloat16, **meta)
    y, rstd = rms_kernel.rmsnorm(x, s)
    dx, ds = rms_kernel.rmsnorm_bwd(x, s, rstd, y)
    assert (y.shape, y.dtype, rstd.shape, rstd.dtype) == (
        x.shape, x.dtype, (12,), torch.float32)
    assert (dx.shape, ds.shape) == (x.shape, s.shape)
    for hd in (64, 96, 8):        # tensor cores, padded, short route
        q = torch.empty(1, 40, 4, hd, dtype=torch.bfloat16, **meta)
        k = torch.empty(1, 40, 2, hd, dtype=torch.bfloat16, **meta)
        o, lse = flash_kernel.flash_attention_bshd(q, k, k)
        assert (o.shape, lse.shape) == (q.shape, (1, 4, 40))
        grads = flash_kernel.flash_attention_bshd_bwd(q, k, k, o, lse, o)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert dict(launch_counts) == before
    flash = [cost.flash(1, 4, 2, 40, 40, hd, 2, True, 0) for hd in
             (64, 96, 8)]
    assert meta_counts == {
        ("weighted_aggregate", "calls"): 1,
        ("weighted_aggregate", "bytes"): cost.agg(3, 40, 4, 4)[0],
        ("weighted_aggregate", "flops"): cost.agg(3, 40, 4, 4)[1],
        ("rmsnorm", "calls"): 1, ("rmsnorm_bwd", "calls"): 1,
        ("rmsnorm", "bytes"): cost.rmsnorm_fwd(384, 2, 64, 12)[0],
        ("rmsnorm", "flops"): 4 * 384,
        ("rmsnorm_bwd", "bytes"): cost.rmsnorm_bwd(384, 2, 64, 12)[0],
        ("rmsnorm_bwd", "flops"): 10 * 384,
        ("flash_attention", "calls"): 3, ("flash_attention_bwd", "calls"): 3,
        ("flash_attention", "bytes"): sum(f[0] for f in flash),
        ("flash_attention", "flops"): sum(f[1] for f in flash),
        ("flash_attention_bwd", "bytes"): sum(
            cost.flash(1, 4, 2, 40, 40, hd, 2, True, 0, True)[0]
            for hd in (64, 96, 8)),
        ("flash_attention_bwd", "flops"): 2.5 * sum(f[1] for f in flash)}
    meta_counts.clear()


class _CudaLabelled(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda")


def test_a_cuda_call_never_reaches_the_meta_branch(monkeypatch):
    """Tensors that say CUDA go to the kernels (which cannot be built
    here, so the call raises) with every meta branch made to raise."""
    monkeypatch.setattr(cost, "record_meta", lambda *a: pytest.fail(
        "a CUDA call reached the meta branch"))
    cuda = lambda *ts: [torch.Tensor._make_subclass(_CudaLabelled, t)  # noqa
                        for t in ts]
    x, s = torch.ones(2, 8, 16), torch.ones(16)
    q, k = torch.ones(1, 4, 8, 8), torch.ones(1, 2, 8, 8)
    qt, kt = torch.ones(1, 4, 256, 64), torch.ones(1, 2, 256, 64)
    calls = [lambda: agg_kernel.weighted_aggregate(
                 *cuda(torch.zeros(8), torch.ones(3, 8), torch.ones(3))),
             lambda: rms_kernel.rmsnorm(*cuda(x, s)),
             lambda: rms_kernel.rmsnorm_bwd(*cuda(x, s, torch.ones(16), x)),
             lambda: flash_kernel.flash_attention(*cuda(q, k, k)),
             lambda: flash_kernel.flash_attention(*cuda(qt.bfloat16(),
                                                        kt.bfloat16(),
                                                        kt.bfloat16()))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


# ---------------------------------------------------------------------------
# The CLIs, in subprocesses (a dry run touches no card)


REFERENCE_KEYS = {
    "arch", "shape", "mesh", "status", "time_s", "chips", "params_total",
    "params_active", "model_flops", "useful_flops_ratio", "hlo_flops",
    "hlo_bytes", "collective_bytes", "collective_by_kind",
    "collective_count", "t_compute_s", "t_memory_s", "t_collective_s",
    "xla_cost_flops_unscaled", "memory", "dominant_term"}


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_dryrun_and_sweep_write_the_reference_records(tmp_path):
    """A one-cell sweep runs `python -m repro_torch.launch.dryrun` in a
    fresh process, which writes an ok record with the reference's keys
    that `benchmarks/roofline_report.py` formats; run again, the sweep
    skips the recorded cell. A pair the reference skips is skipped; the
    reference's `--opt-decode` shards the decode caches' feature dim over
    'model' (fewer argument bytes a chip), `--strict-dtypes` is accepted
    beside the opt agg step, and its HLO dump raises, saying there is
    none."""
    out = tmp_path / "dryrun.json"
    sweep = ("repro_torch.launch.sweep", "--out", str(out), "--mesh",
             "multi", "--archs", "whisper-base", "--shapes", "agg_m96")
    r = _cli(*sweep, cwd=tmp_path)
    assert r.returncode == 0 and "1 ok, 0 failed" in r.stdout, r.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and REFERENCE_KEYS <= set(rec)
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "whisper-base", "agg_m96", "multi", 512)
    assert rec["kernel_calls"] == {"weighted_aggregate": 1}
    assert rec["memory"]["temp_bytes"] is None
    assert rec["params_total"] == 97_166_336
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.roofline_report import fmt_row
    finally:
        sys.path.remove(str(ROOT))
    assert "whisper-base" in fmt_row(rec) and "useful" in fmt_row(rec)
    r = _cli(*sweep, cwd=tmp_path)
    assert "0 combinations to run" in r.stdout, r.stdout
    from repro_torch.launch import dryrun
    assert dryrun.run_one("qwen3-8b", "long_500k", "single")["status"] == \
        "skipped"
    chip = {}
    for flags, tag in (((), "base"), (("--opt-decode",), "opt")):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                     *flags, "--variant", tag, "--out", str(out)])
        (rec,) = [r for r in json.loads(out.read_text())
                  if r["shape"] == "decode_32k+" + tag]
        assert rec["status"] == "ok"
        chip[flags] = rec["memory"]["argument_bytes"]
    assert 0 < chip[("--opt-decode",)] < chip[()]
    from repro_torch import sharding
    assert sharding.DECODE_OPT is False
    dryrun.main(["--arch", "whisper-base", "--shape", "agg_m96", "--moe-groups",
                 "-3", "--strict-dtypes", "--out", str(out)])
    (rec,) = [r for r in json.loads(out.read_text())
              if r["shape"] == "agg_m96" and r["mesh"] == "single"]
    assert rec["status"] == "ok" and rec["kernel_calls"] == {}
    with pytest.raises(SystemExit, match="no HLO"):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                     "--save-hlo=x", "--out", str(out)])
