"""The model zoo's blocks in the port (`repro_torch.models.{attention,moe,
ssm}`) against `repro.models` on the CPU, in float32, through `reduced()`
configs: attention for global and local layers (S > W), single-token
decode against a KV cache (a local layer's ring buffer wrapping), MoE
with and without dropped tokens and under routing ties, the Mamba-2 SSD
block against the reference and against the port's own recurrence, and
the LM loss. Parameters come from the reference's initialisers, carried
across as numpy arrays; inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as rget
from repro.models import attention as RA
from repro.models import moe as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs.base import get_config as tget
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# one float32 block in either framework: the same products summed in
# another order, exp/rsqrt of another library
F32 = dict(rtol=1e-5, atol=1e-5)
# the chunked SSD against the sequential recurrence: the same function
# with the decays multiplied in another order over 64 steps
RECURRENCE = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **over):
    return rget(arch).reduced(**over), tget(arch).reduced(**over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=F32, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


@pytest.mark.parametrize("arch,kind,S", [("qwen3-8b", "global", 16),
                                         ("h2o-danube-1.8b", "local", 128)])
def test_attention_apply_matches(arch, kind, S):
    rc, tc = _cfgs(arch)
    if kind == "local":
        assert S > rc.window_size == 64     # the window binds
    p = _np(RA.attention_init(jax.random.PRNGKey(1), rc, kind))
    x = _x((2, S, rc.d_model), 2)
    want = RA.attention_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              rc, kind, q_chunk=32)
    got = TA.attention_apply(params_from_numpy(p, "cpu"), torch.tensor(x),
                             tc, kind, q_chunk=32)
    _close(got, want)
    # q_chunk does not change the port's result
    again = TA.attention_apply(params_from_numpy(p, "cpu"), torch.tensor(x),
                               tc, kind, q_chunk=7)
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch,kind,over,steps", [
    ("qwen3-8b", "global", {}, 6),
    ("h2o-danube-1.8b", "local", {"window_size": 4}, 11)])
def test_attention_decode_matches_with_its_cache(arch, kind, over, steps):
    """Token by token against the reference's decode: outputs and the
    cache after every step (the local layer's 4-slot ring wraps twice)."""
    rc, tc = _cfgs(arch, **over)
    p = _np(RA.attention_init(jax.random.PRNGKey(3), rc, kind))
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    rcache = RA.init_cache(rc, kind, 2, 16, jnp.float32)
    tcache = TA.init_cache(tc, kind, 2, 16, torch.float32)
    assert tuple(tcache.k.shape) == rcache.k.shape
    xs = _x((steps, 2, 1, rc.d_model), 4)
    for i in range(steps):
        ry, rcache = RA.attention_decode(pj, jnp.asarray(xs[i]), rcache,
                                         jnp.int32(i), rc, kind)
        ty, tcache = TA.attention_decode(pt, torch.tensor(xs[i]), tcache, i,
                                         tc, kind)
        _close(ty, ry, msg=f"step {i}")
        _close(tcache.k, rcache.k, msg=f"k at step {i}")
        _close(tcache.v, rcache.v, msg=f"v at step {i}")


def _moe(cf, seed=5, **over):
    rc, tc = _cfgs("mixtral-8x7b", moe_capacity_factor=cf, **over)
    p = _np(RM.moe_init(jax.random.PRNGKey(seed), rc))
    return rc, tc, p


@pytest.mark.parametrize("cf,groups", [(0.5, 1), (0.5, 2), (4.0, 1),
                                       (4.0, 2)])
def test_moe_apply_matches_with_and_without_drops(cf, groups):
    rc, tc, p = _moe(cf)
    x = _x((4, 16, rc.d_model), 6)
    T, k, E = 64, rc.experts_per_token, rc.num_experts
    C = TM._capacity(tc, T // groups)
    assert C == RM._capacity(rc, T // groups)
    # cf 0.5 drops assignments (capacity below the k·T/E average), 4.0
    # none (capacity at least every assignment of a group)
    assert (C * E < k * T // groups) == (cf < 1)
    assert (C >= k * T // groups) == (cf > 1)
    pj = jax.tree.map(jnp.asarray, p)
    ry, raux = RM.moe_apply(pj, jnp.asarray(x), rc, groups=groups)
    ty, taux = TM.moe_apply(params_from_numpy(p, "cpu"), torch.tensor(x), tc,
                            groups=groups)
    _close(ty, ry)
    _close(taux, raux)
    if cf > 1:   # no drop: the dense oracle, both packages
        dense = TM.moe_apply_dense(params_from_numpy(p, "cpu"),
                                   torch.tensor(x), tc)
        _close(ty, dense)
        _close(dense, RM.moe_apply_dense(pj, jnp.asarray(x), rc))


def test_moe_ties_keep_lax_top_k_order():
    """A zero router gives every expert probability 1/E: `lax.top_k` then
    takes the lowest k expert ids, and so must the port (`torch.topk`
    promises no order among ties). With a capacity that drops, which
    tokens keep their slots follows from that order."""
    rc, tc, p = _moe(0.5, seed=7)
    p["router"] = np.zeros_like(p["router"])
    x = _x((2, 16, rc.d_model), 8)
    probs, gates, idx = TM._route(torch.tensor(x), torch.tensor(p["router"]),
                                  tc.experts_per_token)
    assert torch.equal(idx, torch.tensor([0, 1]).expand_as(idx))
    ry, raux = RM.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rc)
    ty, taux = TM.moe_apply(params_from_numpy(p, "cpu"), torch.tensor(x), tc)
    _close(ty, ry)
    _close(taux, raux)


def test_ssm_apply_matches_reference_and_recurrence():
    rc, tc = _cfgs("mamba2-370m")
    p = _np(RS.ssm_init(jax.random.PRNGKey(9), rc))
    # the reference's init leaves A_log, D, dt_bias constant: vary them
    r = np.random.default_rng(10)
    for name in ("A_log", "D", "dt_bias"):
        p[name] = (p[name] + 0.3 * r.standard_normal(p[name].shape)).astype(
            np.float32)
    p["conv_b"] = _x(p["conv_b"].shape, 11, 0.1)
    x = _x((2, 64, rc.d_model), 12)          # two chunks of 32
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    want = RS.ssm_apply(pj, jnp.asarray(x), rc)
    got = TS.ssm_apply(pt, torch.tensor(x), tc)
    _close(got, want)
    _close(TS.ssm_reference(pt, torch.tensor(x), tc), got, RECURRENCE)
    # decode: five steps, outputs and both parts of the state
    rstate = RS.ssm_init_state(rc, 2, jnp.float32)
    tstate = TS.ssm_init_state(tc, 2, torch.float32)
    for t in range(5):
        ry, rstate = RS.ssm_decode(pj, jnp.asarray(x[:, t:t + 1]), rstate, rc)
        ty, tstate = TS.ssm_decode(pt, torch.tensor(x[:, t:t + 1]), tstate,
                                   tc)
        _close(ty, ry, msg=f"step {t}")
        _close(tstate.s, rstate.s, msg=f"s at step {t}")
        _close(tstate.conv, rstate.conv, msg=f"conv at step {t}")


def test_softplus_has_no_threshold():
    x = np.array([-30.0, -3.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0], np.float32)
    got = TS._softplus(torch.tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches(masked):
    r = np.random.default_rng(13)
    logits = r.standard_normal((2, 6, 40)).astype(np.float32)
    labels = r.integers(0, 40, (2, 6)).astype(np.int32)
    mask = (r.random((2, 6)) > 0.3) if masked else None
    want = RT.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask))
    got = TT.lm_loss(torch.tensor(logits), torch.tensor(labels),
                     None if mask is None else torch.tensor(mask))
    _close(got, want)


def test_rope_tables_shared_by_q_and_k_keep_the_bits():
    """q and k take one (sin, cos) table and the inverse frequencies are
    kept: the same operations on the same values as computing them for
    each call, so the transformer payload's bits do not move."""
    from repro_torch.models import layers as TL
    r = np.random.default_rng(14)
    x = torch.tensor(r.standard_normal((3, 8, 4, 16)).astype(np.float32))
    pos = torch.arange(8)
    exps = torch.arange(0, 16, 2, dtype=torch.float32) / 16
    ang = pos[..., :, None, None].float() * (1.0 / (1e4 ** exps))
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    assert torch.equal(TL.apply_rope(x, pos, 1e4), want)
    assert torch.equal(TL.rotate(x, *TL.rope_tables(pos, 16, 1e4, "cpu")),
                       want)
    with torch.inference_mode():          # a table kept from inference
        TL.rope_frequencies(16, 1e3)
    assert not TL.rope_frequencies(16, 1e3).is_inference()
