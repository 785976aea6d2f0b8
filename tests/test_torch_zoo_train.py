"""The model zoo's train step in the port (`repro_torch.launch.steps.
make_train_step`: the loss and its gradient through every served block
kind, microbatches, clipping, AdamW) against `repro.launch.steps.
make_train_step` on the CPU, in float32, through `reduced()` configs.
Both start from the reference's `init_params` (carried across with
`weights.zoo_params_from_numpy`) and take two steps on the same
`synthetic_lm_batch` batches; loss, grad_norm, the params and AdamW's m
and v are compared after each.

The reference's step constrains its microbatches to the mesh's data axis.
On jax 0.9 `repro.launch.mesh.make_host_mesh` gives `Explicit` axes, under
which that constraint fails (ROADMAP C5), so the reference is built here
on a 1x1 mesh with `Auto` axes, under `jax.set_mesh`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import ShapeConfig as RShape
from repro.launch import steps as RS
from repro.launch.train import synthetic_lm_batch as r_batch
from repro.models import transformer as RT
from repro.optim import adamw_init as r_adamw_init
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import steps as TS
from repro_torch.launch.train import synthetic_lm_batch as t_batch
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init as t_adamw_init
from repro_torch.tree import tree_leaves
from repro_torch.weights import (adamw_state_to_numpy, zoo_params_from_numpy,
                                 zoo_params_to_numpy)
from test_torch_zoo_families import cfgs

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# every transformer config, and recurrentgemma's hybrid of two recurrent
# layers and a local one (`test_torch_zoo_families.CASES`)
SERVED = ("qwen3-8b", "qwen3-8b-swa", "gemma3-12b", "h2o-danube-1.8b",
          "minitron-4b", "mamba2-370m", "mixtral-8x7b", "qwen3-moe-30b-a3b",
          "recurrentgemma-9b", "recurrentgemma-9b/hybrid", "whisper-base",
          "phi-3-vision-4.2b")
# batch 4 in 2 microbatches of 2; 80 tokens: past the reduced window (64)
# and over three SSD chunks of 32
BATCH, SEQ, STEPS, LR = 4, 80, 2, 3e-4
CASES = [(arch, 2) for arch in SERVED] + [("qwen3-8b", 1),
                                          ("mamba2-370m", 1)]
# float32 through two layers and their backward in either framework: the
# loss and the global norm are sums over every position and leaf (1e-7
# seen)
LOSS = dict(rtol=1e-5, atol=0)
# m = 0.1 g (then 0.9 m + 0.1 g) and v = 0.05 g^2: each leaf held to 5e-5
# of its largest entry, the float32 gradients' error (1e-6 of the leaf's
# scale seen after one step, up to 1e-5 after two, whose gradients are
# taken at params that part where the first step was ill-conditioned)
MOMENT_SCALE_TOL = 5e-5
# an AdamW step moves a param by lr * m_hat / (sqrt(v_hat) + eps): at
# step 1 that is lr * g / (|g| + eps), as exact as g's sign and its size
# against eps. Where g is within its own error of 0, or near eps, the two
# packages' steps part by up to a step (3e-5, a tenth of lr, seen on at
# most 23 of 1.4 M entries). So every param is held to one step, lr, and
# all but PARAMS_ILL_SHARE of each tree to 1% of lr.
PARAMS_ATOL = 0.01 * LR
PARAMS_ILL_SHARE = 1e-4


def _ref_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@functools.lru_cache(maxsize=None)
def _run(arch, num_micro):
    """Both packages' trajectories: per step (loss, grad_norm, params,
    opt state), as numpy."""
    rc, tc = cfgs(arch)
    rshape = RShape("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    tshape = TShape("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    mesh = _ref_mesh()
    ref, port = [], []
    with jax.set_mesh(mesh):
        step = jax.jit(RS.make_train_step(rc, mesh, num_micro=num_micro,
                                          q_chunk=16, lr=LR))
        rp = RT.init_params(jax.random.PRNGKey(0), rc)
        np_params = jax.tree.map(np.asarray, rp)
        ro = r_adamw_init(rp)
        for s in range(STEPS):
            rp, ro, m = step(rp, ro, r_batch(rc, rshape, s))
            ref.append((float(m["loss"]), float(m["grad_norm"]),
                        jax.tree.map(np.asarray, rp),
                        jax.tree.map(np.asarray, ro)))
    tp = zoo_params_from_numpy(np_params, "cpu")
    to = t_adamw_init(tp)
    tstep = TS.make_train_step(tc, num_micro=num_micro, q_chunk=16, lr=LR)
    for s in range(STEPS):
        tp, to, m = tstep(tp, to, t_batch(tc, tshape, s, device="cpu"))
        port.append((m["loss"].item(), m["grad_norm"].item(),
                     zoo_params_to_numpy(tp), adamw_state_to_numpy(to)))
    return ref, port


def _pairs(got, want, what):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert [a.shape for a in gl] == [b.shape for b in wl], what
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert a.dtype == b.dtype, (what, i)
    return list(zip(gl, wl))


def _moments_close(got, want, what):
    for i, (a, b) in enumerate(_pairs(got, want, what)):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=MOMENT_SCALE_TOL * np.abs(b).max(),
            err_msg=f"{what} leaf {i}")


def _params_close(got, want, what):
    beyond = total = 0
    for i, (a, b) in enumerate(_pairs(got, want, what)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LR,
                                   err_msg=f"{what} leaf {i}")
        beyond += int((np.abs(a - b) > PARAMS_ATOL).sum())
        total += a.size
    assert beyond <= PARAMS_ILL_SHARE * total, (what, beyond, total)


@pytest.mark.parametrize("arch,num_micro", CASES)
def test_train_step_matches_the_reference(arch, num_micro):
    ref, port = _run(arch, num_micro)
    for s, ((rl, rg, rp, ro), (tl, tg, tp, to)) in enumerate(zip(ref, port)):
        np.testing.assert_allclose(tl, rl, err_msg=f"loss {s}", **LOSS)
        np.testing.assert_allclose(tg, rg, err_msg=f"grad_norm {s}", **LOSS)
        assert rg > 1.0, "clipping at 1.0 should bind"
        assert to["step"] == ro["step"] == s + 1
        _params_close(tp, rp, f"params after step {s}")
        _moments_close(to["m"], ro["m"], f"m after step {s}")
        _moments_close(to["v"], ro["v"], f"v after step {s}")


def _port_setup(arch, batch=BATCH, seq=SEQ):
    _, tc = cfgs(arch)
    tp = TT.init_params(0, tc, device="cpu")
    shape = TShape("t", seq_len=seq, global_batch=batch, kind="train")
    return tc, tp, t_batch(tc, shape, 0, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-12b", "mamba2-370m",
                                  "mixtral-8x7b"])
def test_remat_changes_no_bit(arch, monkeypatch):
    """Recomputing each repeat in the backward (the step's
    `make_loss_and_grad`) gives the gradients of keeping its activations
    (`forward(..., remat=False)` patched in), bit for bit (one repeat of a
    stage is the reference's `jax.checkpoint` unit), and twice alike."""
    tc, tp, batch = _port_setup(arch)
    fn = TS.make_loss_and_grad(tc, num_micro=2)
    runs = [fn(tp, batch)]
    with monkeypatch.context() as m:
        m.setattr(TT, "forward", functools.partial(TT.forward, remat=False))
        runs.append(fn(tp, batch))
    runs.append(fn(tp, batch))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", SERVED)
def test_every_leaf_gets_a_gradient(arch):
    """Autograd reaches every leaf of every block kind (global, local,
    MoE, SSD, RG-LRU, the encoder's and cross-attention), the vision
    projection and both embedding layouts (tied, untied); the microbatch
    sums are float32."""
    tc, tp, batch = _port_setup(arch)
    loss, grads = TS.make_loss_and_grad(tc, num_micro=2)(tp, batch)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for p, g in zip(tree_leaves(tp), tree_leaves(grads)):
        assert g.shape == p.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert ("lm_head" in tp["emb"]) != tc.tie_embeddings


def test_one_microbatch_keeps_the_params_dtype():
    tc = tget("qwen3-8b").reduced(param_dtype="bfloat16")
    tp = TT.init_params(0, tc, device="cpu")
    batch = t_batch(tc, TShape("t", 16, 2, "train"), 0, device="cpu")
    _, grads = TS.make_loss_and_grad(tc)(tp, batch)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))


def test_train_step_writes_in_place_and_reads_nothing_back():
    """The step returns the params and AdamW state it was given, written
    in place (ROADMAP C20), and its metrics as 0-dim tensors."""
    tc, tp, batch = _port_setup("qwen3-8b", batch=2, seq=16)
    opt = t_adamw_init(tp)
    before = [p.clone() for p in tree_leaves(tp)]
    params, state, metrics = TS.make_train_step(tc)(tp, opt, batch)
    assert params is tp and state is opt
    assert all(a is b for a, b in zip(tree_leaves(params), tree_leaves(tp)))
    assert not any(torch.equal(a, b) for a, b in zip(before,
                                                     tree_leaves(tp)))
    assert int(state["step"]) == 1
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in metrics.values())


class _LiveMesh:
    """A stand-in for a live (1, 2) mesh over (data, model)."""
    mesh_dim_names = ("data", "model")

    def size(self, i=None):
        return (1, 2)[i] if i is not None else 2


@pytest.mark.parametrize("kw", [{"mesh": _LiveMesh()}, {"moe_groups": -2}])
def test_meshes_and_expert_parallelism_raise(kw):
    """What the step still refuses: a live model axis above 1 for a family
    with no tensor-parallel partition (mamba2-370m, ROADMAP A.10 part 4),
    and expert parallelism without a mesh to hold the experts (the live
    meshes' steps: tests/test_torch_zoo_mesh*.py and
    tests/test_torch_zoo_tp.py)."""
    mesh = kw.pop("mesh", None)
    tc = tget("mamba2-370m" if mesh else "mixtral-8x7b").reduced()
    with pytest.raises(NotImplementedError if mesh else ValueError,
                       match="A.10 part 4" if mesh else "needs|mesh"):
        TS.make_train_step(tc, mesh, **kw)
