"""The model zoo's serving path in the port (`repro_torch.models.
transformer`, `repro_torch.launch.steps`) against `repro.models.
transformer` and `repro.launch.steps` on the CPU, in float32, through
`reduced()` configs: forward logits, eight decode steps with their
caches, prefill against decode at every position, and the greedy serve
loop of examples/serve_decode.py. Parameters come from the reference's
`init_params`, carried across with `weights.zoo_params_from_numpy`;
decode states cross both ways with `weights.decode_state_*`; prompts
are made with numpy from a seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import StageSpec as RStage
from repro.configs.base import get_config as rget
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro_torch.configs.base import StageSpec as TStage
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.weights import (decode_state_from_numpy,
                                 decode_state_to_numpy, zoo_params_from_numpy)

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# a two-layer float32 model in either framework: the blocks' 1e-5 through
# two residual layers, the final norm and the unembedding (logits up to ~5)
LOGITS = dict(rtol=1e-5, atol=2e-5)
# caches hold one projection each: the blocks' tolerance
CACHE = dict(rtol=1e-5, atol=1e-5)
# prefill against decode within the port: the reference's own tolerance
# for its forward against its decode (tests/test_model_blocks.py)
PREFILL_DECODE = dict(rtol=1e-3, atol=5e-4)
# a near tie of the greedy pick: two logits (|logit| <= 5) each within
# LOGITS of the reference's can swap order when their gap is under twice
# that tolerance
TIE = 2 * (LOGITS["atol"] + 5.0 * LOGITS["rtol"])

CASES = {
    "qwen3-8b": {},
    "gemma3-12b": {},
    # gemma3's local:global interleave in one stage of two layers
    "gemma3-12b/interleave": {"stages": "local,global"},
    "mamba2-370m": {},
    "mixtral-8x7b": {},
    # a window shorter than the sequences below
    "h2o-danube-1.8b/w8": {"window_size": 8},
}


@functools.lru_cache(maxsize=None)
def _setup(case):
    arch = case.split("/")[0]
    over = dict(CASES[case])
    rover, tover = dict(over), dict(over)
    if "stages" in over:
        pattern = tuple(over["stages"].split(","))
        rover["stages"] = (RStage(pattern, 1),)
        tover["stages"] = (TStage(pattern, 1),)
    rc, tc = rget(arch).reduced(**rover), tget(arch).reduced(**tover)
    rp = RT.init_params(jax.random.PRNGKey(0), rc)
    tp = zoo_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rc, tc, rp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def _same_caches(tstate, rstate, msg):
    port = decode_state_to_numpy(tstate)
    ref = jax.tree.map(np.asarray, rstate)
    assert port["index"] == ref["index"]
    pl, rl = jax.tree.leaves(port["caches"]), jax.tree.leaves(ref["caches"])
    assert [a.shape for a in pl] == [b.shape for b in rl]
    for a, b in zip(pl, rl):
        _close(a, b, CACHE, msg)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match(case):
    rc, tc, rp, tp = _setup(case)
    toks = _tokens(rc, (2, 16), 1)
    rl, raux = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    with torch.inference_mode():
        tl, taux = TT.forward(tp, {"tokens": torch.tensor(toks)}, tc)
    assert tuple(tl.shape) == rl.shape == (2, 16, rc.vocab_size)
    _close(tl, rl, LOGITS)
    _close(np.float32(taux), raux, CACHE)
    # the prefill step is the last position's logits
    pre = TS.make_prefill_step(tc)(tp, {"tokens": torch.tensor(toks)})
    _close(pre, RS.make_prefill_step(rc)(rp, {"tokens": jnp.asarray(toks)}),
           LOGITS)


@pytest.mark.parametrize("case", list(CASES))
def test_eight_decode_steps_match_with_caches(case):
    """Logits and every cache after each of eight steps; midway the
    reference's state is carried into the port and both go on from it."""
    rc, tc, rp, tp = _setup(case)
    toks = _tokens(rc, (2, 8), 2)
    rstate = RT.init_decode_state(rp, rc, 2, 16, jnp.float32)
    tstate = TT.init_decode_state(tp, tc, 2, 16, torch.float32)
    step = jax.jit(lambda p, t, s: RT.decode_step(p, t, s, rc))
    for t in range(8):
        if t == 4:
            tstate = decode_state_from_numpy(
                jax.tree.map(np.asarray, rstate), "cpu")
        rl, rstate = step(rp, jnp.asarray(toks[:, t:t + 1]), rstate)
        with torch.inference_mode():
            tl, tstate = TT.decode_step(tp, torch.tensor(toks[:, t:t + 1]),
                                        tstate, tc)
        assert tuple(tl.shape) == rl.shape == (2, 1, rc.vocab_size)
        _close(tl, rl, LOGITS, f"logits at step {t}")
        _same_caches(tstate, rstate, f"caches after step {t}")


@pytest.mark.parametrize("case", ["qwen3-8b", "gemma3-12b/interleave",
                                  "mamba2-370m", "h2o-danube-1.8b/w8"])
def test_prefill_matches_decode_at_each_position(case):
    """The port's forward against its own decode over 48 positions (the
    reference's test_train_decode_consistency, on the port): the KV
    caches, the local ring (window 8 < 48) and the SSD recurrence."""
    _, tc, _, tp = _setup(case)
    toks = torch.tensor(_tokens(tc, (2, 48), 3))
    with torch.inference_mode():
        full, _ = TT.forward(tp, {"tokens": toks}, tc, q_chunk=16)
        state = TT.init_decode_state(tp, tc, 2, 48, torch.float32)
        outs = []
        for t in range(48):
            lg, state = TT.decode_step(tp, toks[:, t:t + 1], state, tc)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full, PREFILL_DECODE)


def _ref_serve(rc, rp, prompt, gen, cache_len):
    step = jax.jit(RS.make_serve_step(rc))
    state = RT.init_decode_state(rp, rc, prompt.shape[0], cache_len,
                                 jnp.float32)
    prompt = jnp.asarray(prompt)
    for t in range(prompt.shape[1] - 1):
        _, state = step(rp, state, prompt[:, t:t + 1])
    tok, out = prompt[:, -1:], []
    for _ in range(gen):
        tok, state = step(rp, state, tok)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _port_serve(tc, tp, prompt, gen, cache_len):
    step = TS.make_serve_step(tc)
    state = TT.init_decode_state(tp, tc, prompt.shape[0], cache_len,
                                 torch.float32)
    prompt = torch.tensor(prompt)
    for t in range(prompt.shape[1] - 1):
        _, state = step(tp, state, prompt[:, t:t + 1])
    tok, out = prompt[:, -1:], []
    for _ in range(gen):
        tok, state = step(tp, state, tok)
        assert tok.dtype == torch.int32 and tuple(tok.shape) == (
            prompt.shape[0], 1)
        out.append(tok.numpy())
    return np.concatenate(out, axis=1), state


@pytest.mark.parametrize("case", ["gemma3-12b", "mamba2-370m",
                                  "mixtral-8x7b", "qwen3-8b"])
def test_serve_loop_greedy_tokens_match(case):
    """examples/serve_decode.py's loop (batch 4, an 8-token prompt
    stepped, 24 tokens generated, a 64-slot cache): the greedy tokens
    equal the reference's. Where a row parts, the reference's top-2
    logits at that step are within the logits' tolerance of each other
    (a near tie), and the row is not compared further."""
    rc, tc, rp, tp = _setup(case)
    prompt = _tokens(rc, (4, 8), 4)
    want = _ref_serve(rc, rp, prompt, 24, 64)
    got, state = _port_serve(tc, tp, prompt, 24, 64)
    assert state["index"] == 8 - 1 + 24
    for b in range(4):
        parted = np.nonzero(got[b] != want[b])[0]
        if parted.size:
            t = int(parted[0])
            margin = _ref_margin(rc, rp, prompt[b:b + 1], want[b:b + 1, :t])
            assert margin < TIE, (b, t, margin)


def _ref_margin(rc, rp, prompt, generated):
    """The reference's top-2 logit gap at the step after `generated`."""
    toks = np.concatenate([prompt, generated], axis=1)
    logits, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])
