"""The zoo's three last families in the port against `repro.models` on
the CPU, in float32, through `reduced()` configs: the RG-LRU block
(recurrentgemma) against the reference and against the port's own
token-by-token recurrence, its log-depth scan, its decode; whisper's
encoder attention, `cross_kv` and cross-attention (prefill and decode);
the recurrent, cross and enc blocks; and `forward` (with the prefill
step) for recurrentgemma, a hybrid recurrentgemma with a local layer,
whisper and phi-3-vision. Parameters come from the reference's
initialisers, carried across as numpy arrays; inputs are made with numpy
from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import StageSpec as RStage
from repro.configs.base import get_config as rget
from repro.launch import steps as RS
from repro.models import attention as RA
from repro.models import rglru as RR
from repro.models import transformer as RT
from repro_torch.configs.base import StageSpec as TStage
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.weights import params_from_numpy, zoo_params_from_numpy

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# one float32 block or a two-layer model in either framework: the same
# products summed in another order, exp/rsqrt/tanh of another library
# (the serve tests' logits tolerance); the scans reassociate the same
# products (the reference's odd-even tree, the port's doubling)
F32 = dict(rtol=1e-5, atol=2e-5)
# the log-depth scan against the step-by-step recurrence within the
# port: one product tree against a left fold over up to 64 steps
RECURRENCE = dict(rtol=1e-5, atol=2e-5)

# reduced configs: recurrentgemma keeps its two recurrent layers; the
# hybrid has the registered pattern (two recurrent, one local) with a
# window of 8, so that the sequences below pass it
CASES = {
    "recurrentgemma-9b": {},
    "recurrentgemma-9b/hybrid": {"stages": "recurrent,recurrent,local",
                                 "window_size": 8},
    "whisper-base": {},
    "phi-3-vision-4.2b": {},
}


def cfgs(case):
    """(reference config, port config) of a case of `CASES`."""
    arch = case.split("/")[0]
    over = dict(CASES.get(case, {}))
    rover, tover = dict(over), dict(over)
    if "stages" in over:
        pattern = tuple(over["stages"].split(","))
        rover["stages"] = (RStage(pattern, 1),)
        tover["stages"] = (TStage(pattern, 1),)
        rover["num_layers"] = tover["num_layers"] = len(pattern)
    return rget(arch).reduced(**rover), tget(arch).reduced(**tover)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=F32, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def _rglru_params(seed=1):
    """The reference's RG-LRU parameters, the constant ones varied: gate
    biases up to +-3 (recurrence gates near 1, so a reaches e^-21 a
    step), a conv bias, lam over a wider range."""
    rc, tc = cfgs("recurrentgemma-9b")
    p = _np(RR.rglru_init(jax.random.PRNGKey(seed), rc))
    r = np.random.default_rng(seed + 100)
    for name in ("b_a", "b_i"):
        b = 1.5 * r.standard_normal(p[name].shape)
        p[name] = b.clip(-3, 3).astype(np.float32)
    p["conv_b"] = _x(p["conv_b"].shape, seed + 101, 0.1)
    p["lam"] = (p["lam"] + 0.3 * r.standard_normal(p["lam"].shape)).astype(
        np.float32)
    return rc, tc, p


@pytest.mark.parametrize("S", [64, 37])
def test_rglru_apply_matches_the_reference(S):
    rc, tc, p = _rglru_params()
    x = _x((2, S, rc.d_model), 2)
    want = RR.rglru_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rc)
    got = TR.rglru_apply(params_from_numpy(p, "cpu"), torch.tensor(x), tc)
    _close(got, want)


def test_rglru_scan_matches_the_step_by_step_recurrence():
    """The port's log-depth scan against its own token-by-token oracle,
    and that oracle against the reference's."""
    rc, tc, p = _rglru_params(seed=3)
    x = _x((2, 64, rc.d_model), 4)
    pt = params_from_numpy(p, "cpu")
    oracle = TR.rglru_reference(pt, torch.tensor(x), tc)
    _close(TR.rglru_apply(pt, torch.tensor(x), tc), oracle, RECURRENCE)
    _close(oracle, RR.rglru_reference(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), rc))


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_scan_is_the_recurrence_where_products_underflow(S):
    """`_scan` against h_t = a_t h_{t-1} + u_t folded left, with decays
    from e^-21 (the largest softplus(lam) times 8: a product of two
    underflows float32's normal range within a few steps) to 1."""
    r = np.random.default_rng(S)
    a = np.exp(-21.0 * r.random((3, S, 16)) ** 2).astype(np.float32)
    u = r.standard_normal((3, S, 16)).astype(np.float32)
    h, want = np.zeros((3, 16), np.float32), []
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    got = TR._scan(torch.tensor(a), torch.tensor(u))
    _close(got, np.stack(want, axis=1), RECURRENCE)


def test_rglru_decode_steps_match_with_their_state():
    rc, tc, p = _rglru_params(seed=5)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    rstate = RR.rglru_init_state(None, rc, 2, jnp.float32)
    tstate = TR.rglru_init_state(None, tc, 2, torch.float32)
    assert tstate.h.dtype == torch.float32
    xs = _x((6, 2, 1, rc.d_model), 6)
    for t in range(6):
        ry, rstate = RR.rglru_decode(pj, jnp.asarray(xs[t]), rstate, rc)
        ty, tstate = TR.rglru_decode(pt, torch.tensor(xs[t]), tstate, tc)
        _close(ty, ry, msg=f"step {t}")
        _close(tstate.h, rstate.h, msg=f"h at step {t}")
        _close(tstate.conv, rstate.conv, msg=f"conv at step {t}")


def test_rglru_keeps_its_float32_leaves_in_bfloat16():
    """lam, b_a and b_i stay float32 in a bf16 model, as the
    reference's; the state's h is float32, its conv tail the model's."""
    tc = tget("recurrentgemma-9b").reduced(param_dtype="bfloat16")
    p = TR.rglru_init(torch.Generator().manual_seed(0), tc)
    f32 = {k for k, v in p.items() if not isinstance(v, dict)
           and v.dtype == torch.float32}
    assert f32 == {"lam", "b_a", "b_i"}
    x = torch.tensor(_x((1, 9, tc.d_model), 7)).to(torch.bfloat16)
    assert TR.rglru_apply(p, x, tc).dtype == torch.bfloat16
    st = TR.rglru_init_state(p, tc, 1, torch.bfloat16)
    _, st = TR.rglru_decode(p, x[:, :1], st, tc)
    assert (st.h.dtype, st.conv.dtype) == (torch.float32, torch.bfloat16)


def _attn(kind, qk_norm, seed):
    rc, tc = cfgs("whisper-base")
    if qk_norm:
        rc, tc = (rget("whisper-base").reduced(qk_norm=True),
                  tget("whisper-base").reduced(qk_norm=True))
    p = _np(RA.attention_init(jax.random.PRNGKey(seed), rc, kind))
    return rc, tc, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv_matches(qk_norm):
    rc, tc, pj, pt = _attn("global", qk_norm, 8)
    enc = _x((2, 20, rc.d_model), 9)
    rk, rv = RA.cross_kv(pj, jnp.asarray(enc), rc)
    tk, tv = TA.cross_kv(pt, torch.tensor(enc), tc)
    assert tuple(tk.shape) == rk.shape == (2, 20, rc.num_kv_heads,
                                           rc.resolved_head_dim)
    _close(tk, rk)
    _close(tv, rv)


def test_enc_attention_apply_matches():
    """The encoder's kind: RoPE over 0..S-1, no mask."""
    rc, tc, pj, pt = _attn("enc", False, 10)
    x = _x((2, 24, rc.d_model), 11)
    want = RA.attention_apply(pj, jnp.asarray(x), rc, "enc", q_chunk=8)
    got = TA.attention_apply(pt, torch.tensor(x), tc, "enc", q_chunk=8)
    _close(got, want)
    # not the causal layer's result
    causal = TA.attention_apply(pt, torch.tensor(x), tc, "global")
    assert not torch.allclose(got, causal, atol=1e-3)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_apply_matches(qk_norm):
    """16 decoder positions over 20 encoder positions, no mask."""
    rc, tc, pj, pt = _attn("global", qk_norm, 12)
    enc, x = _x((2, 20, rc.d_model), 13), _x((2, 16, rc.d_model), 14)
    rk, rv = RA.cross_kv(pj, jnp.asarray(enc), rc)
    tk, tv = TA.cross_kv(pt, torch.tensor(enc), tc)
    want = RA.attention_apply(pj, jnp.asarray(x), rc, "global",
                              kv_override=(rk, rv, False))
    got = TA.attention_apply(pt, torch.tensor(x), tc, "global",
                             kv_override=(tk, tv, False))
    _close(got, want)


def test_cross_attention_decode_matches_and_writes_nothing():
    rc, tc, pj, pt = _attn("global", False, 15)
    enc = _x((2, 20, rc.d_model), 16)
    rk, rv = RA.cross_kv(pj, jnp.asarray(enc), rc)
    tk, tv = TA.cross_kv(pt, torch.tensor(enc), tc)
    keep = (tk.clone(), tv.clone())
    xs = _x((3, 2, 1, rc.d_model), 17)
    marker = object()
    for i in range(3):
        ry, _ = RA.attention_decode(pj, jnp.asarray(xs[i]), None,
                                    jnp.int32(i), rc, "global",
                                    kv_override=(rk, rv))
        ty, back = TA.attention_decode(pt, torch.tensor(xs[i]), marker, i,
                                       tc, "global", kv_override=(tk, tv))
        assert back is marker
        _close(ty, ry, msg=f"step {i}")
    assert torch.equal(tk, keep[0]) and torch.equal(tv, keep[1])


@pytest.mark.parametrize("kind", ["recurrent", "cross", "enc"])
def test_block_apply_matches(kind):
    arch = "recurrentgemma-9b" if kind == "recurrent" else "whisper-base"
    rc, tc = cfgs(arch)
    p = _np(RT.block_init(jax.random.PRNGKey(18), rc, kind))
    x = _x((2, 16, rc.d_model), 19)
    enc = _x((2, 20, rc.d_model), 20)
    want, _ = RT.block_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             rc, kind, enc_out=jnp.asarray(enc), q_chunk=8)
    got, aux = TT.block_apply(params_from_numpy(p, "cpu"), torch.tensor(x),
                              tc, kind, enc_out=torch.tensor(enc), q_chunk=8)
    assert aux == 0.0
    _close(got, want)


@functools.lru_cache(maxsize=None)
def load_case(case):
    """(reference config, port config, reference params, port params)
    from the reference's `init_params`."""
    rc, tc = cfgs(case)
    rp = RT.init_params(jax.random.PRNGKey(0), rc)
    tp = zoo_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, tc, rp, tp


def batch_np(cfg, B, S, seed, frames=24):
    """A numpy batch: tokens (B, S), and the family's image embeddings or
    encoder frames."""
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = r.standard_normal(
            (B, cfg.num_image_tokens, TT.VISION_DIM)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = r.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_prefill_match(case):
    rc, tc, rp, tp = load_case(case)
    b = batch_np(rc, 2, 16, 21)
    rl, _ = RT.forward(rp, {k: jnp.asarray(v) for k, v in b.items()}, rc,
                       q_chunk=8)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    with torch.inference_mode():
        tl, aux = TT.forward(tp, tb, tc, q_chunk=8)
    # logits on the text positions only, with images
    assert tuple(tl.shape) == rl.shape == (2, 16, rc.vocab_size)
    assert aux == 0.0
    _close(tl, rl)
    pre = TS.make_prefill_step(tc)(tp, tb)
    _close(pre, RS.make_prefill_step(rc)(
        rp, {k: jnp.asarray(v) for k, v in b.items()}), F32)


def test_the_stack_knows_every_zoo_kind_but_cnn():
    """Every layer kind of the transformer configs builds; densenet-fl's
    `cnn` raises, naming the model that has it."""
    from repro_torch.configs.base import list_configs
    for arch in list_configs():
        cfg = tget(arch).reduced()
        if arch == "densenet-fl":
            with pytest.raises(NotImplementedError,
                               match="models.densenet"):
                TT.init_params(0, cfg, device="cpu")
        else:
            TT.init_params(0, cfg, device="cpu")
