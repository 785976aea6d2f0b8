"""The port's optimizers and schedules (`repro_torch.optim`) against
`repro.optim` on the CPU: AdamW over three steps, SGD with and without
momentum, weight decay and a trainable mask, clipping by the global norm
above and below it, and the two learning-rate schedules. Trees hold
float32 and bfloat16 leaves in dicts and lists, drawn with numpy from a
seed; a bfloat16 leaf is the same float32 draw rounded on both sides.

The port works in place where the reference is functional (ROADMAP C20),
so every port call here gets tensors it may write."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as R
import repro_torch.optim as T
from repro_torch.tree import tree_leaves, tree_map

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

SHAPES = {"w": (6, 5), "blocks": [(7,), (2, 3, 4)], "norm": {"scale": (9,)}}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the same float32 operations in the same order on identical inputs; XLA
# may contract a multiply and an add into one rounding
F32 = dict(rtol=2e-6, atol=1e-9)
# a bfloat16 result rounded from float32 values one rounding apart lands
# at most one bfloat16 step (2**-8 relative) away
BF16 = dict(rtol=2 ** -8, atol=1e-9)


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (scale * rng.normal(size=s)
                                   ).astype(np.float32), SHAPES,
                        is_leaf=lambda x: isinstance(x, tuple))


def _both(tree, dtype):
    jd, td = DTYPES[dtype]
    return (jax.tree.map(lambda a: jnp.asarray(a, jd), tree),
            tree_map(lambda a: torch.tensor(a).to(td), tree))


def _close(port, ref, tol, what):
    pl = [t.float().numpy() for t in tree_leaves(port)]
    rl = [np.asarray(x, np.float32) for x in jax.tree.leaves(ref)]
    assert len(pl) == len(rl), what
    for i, (a, b) in enumerate(zip(pl, rl)):
        np.testing.assert_allclose(a, b, err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adamw_three_steps_match(dtype):
    rp, tp = _both(_draw(0, 0.05), dtype)
    rs, ts = R.adamw_init(rp), T.adamw_init(tp)
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["m"]))
    tol = F32 if dtype == "float32" else BF16
    for step in range(3):
        rg, tg = _both(_draw(10 + step, 0.5 ** step), dtype)
        ru, rs = R.adamw_update(rg, rs, rp, 1e-2)
        tu, ts = T.adamw_update(tg, ts, tp, 1e-2)
        _close(tu, ru, F32, f"updates {step}")
        _close(ts["m"], rs["m"], F32, f"m {step}")
        _close(ts["v"], rs["v"], F32, f"v {step}")
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        rp = R.apply_updates(rp, ru)
        tp = T.apply_updates(tp, tu)
        assert all(t.dtype == DTYPES[dtype][1] for t in tree_leaves(tp))
        _close(tp, rp, tol, f"params {step}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adamw_apply_is_update_then_apply(dtype):
    """The train step's leaf-at-a-time form gives `adamw_update` followed
    by `apply_updates`, bit for bit."""
    p0 = _draw(1, 0.05)
    (_, pa), (_, pb) = _both(p0, dtype), _both(p0, dtype)
    sa, sb = T.adamw_init(pa), T.adamw_init(pb)
    for step in range(3):
        _, g = _both(_draw(20 + step), dtype)
        u, sa = T.adamw_update(g, sa, pa, 3e-3, weight_decay=0.05)
        pa = T.apply_updates(pa, u)
        T.adamw_apply(tree_map(torch.clone, g), sb, pb, 3e-3,
                      weight_decay=0.05)
    for a, b in zip(tree_leaves([pa, sa]), tree_leaves([pb, sb])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adamw_update_and_apply_updates_write_nothing(dtype):
    """`adamw_update` and `apply_updates` are functional, as the
    reference's: their arguments keep their values."""
    _, p = _both(_draw(4, 0.05), dtype)
    _, g = _both(_draw(5), dtype)
    state = T.adamw_init(p)
    u, state = T.adamw_update(g, state, p, 1e-2)
    before = [t.clone() for t in tree_leaves([g, state, p])]
    u2, state2 = T.adamw_update(g, state, p, 1e-2)
    p2 = T.apply_updates(p, u2)
    for a, b in zip(tree_leaves([g, state, p]), before):
        assert torch.equal(a, b)
    assert int(state2["step"]) == 2 and int(state["step"]) == 1
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(p2),
                                                    tree_leaves(p)))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("masked", [False, True])
def test_sgd_matches(momentum, weight_decay, masked):
    rp, tp = _both(_draw(2), "float32")
    mask = None
    if masked:
        mask = jax.tree.map(lambda a: (a > 0).astype(np.float32), _draw(3))
    rs, ts = R.sgd_init(rp, momentum), T.sgd_init(tp, momentum)
    assert sorted(rs) == sorted(ts)
    for step in range(3):
        rg, tg = _both(_draw(30 + step), "float32")
        kw = dict(momentum=momentum, weight_decay=weight_decay)
        ru, rs = R.sgd_update(rg, rs, rp, 0.1, trainable_mask=None if mask
                              is None else _both(mask, "float32")[0], **kw)
        tu, ts = T.sgd_update(tg, ts, tp, 0.1, trainable_mask=None if mask
                              is None else _both(mask, "float32")[1], **kw)
        _close(tu, ru, F32, f"updates {step}")
        if momentum:
            _close(ts["mu"], rs["mu"], F32, f"mu {step}")
        assert int(ts["step"]) == int(rs["step"]) == step + 1
        rp, tp = R.apply_updates(rp, ru), T.apply_updates(tp, tu)
        _close(tp, rp, F32, f"params {step}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_above_and_below(dtype, max_norm):
    """0.5 is below the tree's norm (~5): every leaf scaled; 1e3 above it:
    the leaves come back as they were."""
    rg, tg = _both(_draw(4), dtype)
    want_norm = R.global_norm(rg)
    np.testing.assert_allclose(T.global_norm(tg).item(), want_norm, **F32)
    rc, rn = R.clip_by_global_norm(rg, max_norm)
    before = [t.clone() for t in tree_leaves(tg)]
    tc, tn = T.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(tn.item(), rn, **F32)
    assert (float(rn) > max_norm) == (max_norm == 0.5)
    _close(tc, rc, F32 if dtype == "float32" else BF16, "clipped")
    same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tc)))
    assert same == (max_norm == 1e3)
    assert all(t.dtype == DTYPES[dtype][1] for t in tree_leaves(tc))


STEPS = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]


def test_schedules_match():
    c_r, c_t = R.constant_schedule(3e-4), T.constant_schedule(3e-4)
    cos_r = R.cosine_schedule(1e-3, warmup=10, total=100, floor=0.1)
    cos_t = T.cosine_schedule(1e-3, warmup=10, total=100, floor=0.1)
    for s in STEPS:
        assert c_t(s).dtype == torch.float32
        assert c_t(s).item() == float(c_r(s))
        got = cos_t(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(cos_r(s)), **F32)
    # a tensor of steps at once
    got = cos_t(torch.tensor(STEPS))
    np.testing.assert_allclose(got.numpy(), np.asarray(cos_r(
        jnp.asarray(STEPS))), **F32)
