"""The zoo's three last families served by the port against `repro.
models.transformer` and `repro.launch.steps` on the CPU, in float32,
through `reduced()` configs (`test_torch_zoo_families.CASES`): whisper's
decode state from its encoder's frames, eight decode steps with every
cache (the RG-LRU state, a local layer's ring wrapping, the cross
block's dict), prefill against decode at every position within the
port, the greedy serve loop, the abstract decode state of every
transformer config, and the decode state's round trips through numpy.
Parameters come from the reference's `init_params`, carried across with
`weights.zoo_params_from_numpy`; inputs are made with numpy from a seed.
The port's decode writes its state in place, so no test steps twice from
one state (ROADMAP C19)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as R_SHAPES
from repro.configs.base import get_config as rget
from repro.configs.base import list_configs
from repro.launch import steps as RS
from repro.models import transformer as RT
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import LRUState
from repro_torch.tree import tree_leaves
from repro_torch.weights import decode_state_from_numpy, decode_state_to_numpy
from test_torch_zoo_families import CASES, F32, batch_np, load_case

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# caches hold one projection each (the blocks' tolerance); an RG-LRU
# state's h is a sum over the steps so far, the logits' tolerance
CACHE = F32
# prefill against decode within the port: the reference's own tolerance
# for its forward against its decode (tests/test_model_blocks.py)
PREFILL_DECODE = dict(rtol=1e-3, atol=5e-4)
# a near tie of the greedy pick: two logits (|logit| <= 5) each within
# F32 of the reference's can swap order when their gap is under twice
# that tolerance
TIE = 2 * (F32["atol"] + 5.0 * F32["rtol"])
FRAMES = 24                   # encoder frames of the reduced whisper


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=msg, **tol)


def _frames(cfg, B, seed):
    return batch_np(cfg, B, 1, seed, FRAMES).get("frames")


def _states(case, B, cache_len, seed=5):
    """The reference's and the port's initial decode states, whisper's
    from the same frames."""
    rc, tc, rp, tp = load_case(case)
    f = _frames(rc, B, seed)
    rkw = {} if f is None else {"enc_frames": jnp.asarray(f)}
    tkw = {} if f is None else {"enc_frames": torch.tensor(f)}
    rstate = RT.init_decode_state(rp, rc, B, cache_len, jnp.float32, **rkw)
    tstate = TT.init_decode_state(tp, tc, B, cache_len, torch.float32, **tkw)
    return rstate, tstate


def _same_caches(tstate, rstate, msg):
    port = decode_state_to_numpy(tstate)
    ref = jax.tree.map(np.asarray, rstate)
    assert port["index"] == ref["index"]
    pl, rl = jax.tree.leaves(port["caches"]), jax.tree.leaves(ref["caches"])
    assert [(a.shape, a.dtype) for a in pl] == [(b.shape, b.dtype)
                                                for b in rl]
    for a, b in zip(pl, rl):
        _close(a, b, CACHE, msg)


def test_whisper_decode_state_from_frames_matches():
    """init_decode_state(enc_frames=): each cross block keeps the cross
    k and v of the encoder's output, stacked on the repeat axis; the self
    cache is zeros."""
    rstate, tstate = _states("whisper-base", 2, 16)
    node = tstate["caches"][0]["pos0"]
    assert set(node) == {"self", "cross_k", "cross_v"}
    assert isinstance(node["self"], KVCache)
    assert tuple(node["cross_k"].shape) == (1, 2, FRAMES, 2, 64)
    assert not node["self"].k.any()
    _same_caches(tstate, rstate, "whisper's initial state")
    with pytest.raises(ValueError, match="enc_frames"):
        TT.init_decode_state(load_case("whisper-base")[3],
                             tget("whisper-base").reduced(), 2, 16,
                             torch.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_eight_decode_steps_match_with_caches(case):
    """Logits and every cache after each of eight steps; midway the
    reference's state is carried into the port (its LRUState and cross
    dicts through `decode_state_from_numpy`) and both go on from it."""
    rc, tc, rp, tp = load_case(case)
    toks = batch_np(rc, 2, 8, 2)["tokens"]
    rstate, tstate = _states(case, 2, 16)
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
        _close(tl, rl, F32, f"logits at step {t}")
        _same_caches(tstate, rstate, f"caches after step {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_decode_at_each_position(case):
    """The port's forward against its own decode over 24 positions (past
    the hybrid's window of 8: its ring wraps). phi-3-vision's decode takes
    no image, as the reference's, so its forward here has none either
    (zero image embeddings)."""
    _, tc, _, tp = load_case(case)
    b = batch_np(tc, 2, 24, 3, FRAMES)
    if tc.frontend == "vision":
        b["image_embeds"] = b["image_embeds"][:, :0]
    tb = {k: torch.tensor(v) for k, v in b.items()}
    toks = tb["tokens"]
    with torch.inference_mode():
        full, _ = TT.forward(tp, tb, tc, q_chunk=8)
        state = TT.init_decode_state(tp, tc, 2, 24, torch.float32,
                                     enc_frames=tb.get("frames"))
        outs = []
        for t in range(24):
            lg, state = TT.decode_step(tp, toks[:, t:t + 1], state, tc)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full, PREFILL_DECODE)


def _ref_serve(rc, rp, prompt, gen, cache_len, frames):
    step = jax.jit(RS.make_serve_step(rc))
    kw = {} if frames is None else {"enc_frames": jnp.asarray(frames)}
    state = RT.init_decode_state(rp, rc, prompt.shape[0], cache_len,
                                 jnp.float32, **kw)
    prompt = jnp.asarray(prompt)
    for t in range(prompt.shape[1] - 1):
        _, state = step(rp, state, prompt[:, t:t + 1])
    tok, out = prompt[:, -1:], []
    for _ in range(gen):
        tok, state = step(rp, state, tok)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _port_serve(tc, tp, prompt, gen, cache_len, frames):
    step = TS.make_serve_step(tc)
    state = TT.init_decode_state(
        tp, tc, prompt.shape[0], cache_len, torch.float32,
        enc_frames=None if frames is None else torch.tensor(frames))
    prompt = torch.tensor(prompt)
    for t in range(prompt.shape[1] - 1):
        _, state = step(tp, state, prompt[:, t:t + 1])
    tok, out = prompt[:, -1:], []
    for _ in range(gen):
        tok, state = step(tp, state, tok)
        assert tok.dtype == torch.int32
        out.append(tok.numpy())
    return np.concatenate(out, axis=1), state


def _ref_margin(rc, rp, prompt, generated, frames):
    """The reference's top-2 logit gap at the step after `generated`."""
    toks = np.concatenate([prompt, generated], axis=1)
    b = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        b["frames"] = jnp.asarray(frames)
    if rc.frontend == "vision":
        b["image_embeds"] = jnp.zeros((1, 0, TT.VISION_DIM), jnp.float32)
    logits, _ = RT.forward(rp, b, rc)
    top = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("case", list(CASES))
def test_serve_loop_greedy_tokens_match(case):
    """examples/serve_decode.py's loop (batch 4, an 8-token prompt
    stepped, 24 tokens generated, a 64-slot cache; the hybrid's ring of 8
    wraps): the greedy tokens equal the reference's. Where a row parts,
    the reference's top-2 logits at that step are within the logits'
    tolerance of each other (a near tie), and the row is not compared
    further."""
    rc, tc, rp, tp = load_case(case)
    prompt = batch_np(rc, 4, 8, 4)["tokens"]
    frames = _frames(rc, 4, 6)
    want = _ref_serve(rc, rp, prompt, 24, 64, frames)
    got, state = _port_serve(tc, tp, prompt, 24, 64, frames)
    assert state["index"] == 8 - 1 + 24
    for b in range(4):
        parted = np.nonzero(got[b] != want[b])[0]
        if parted.size:
            t = int(parted[0])
            margin = _ref_margin(
                rc, rp, prompt[b:b + 1], want[b:b + 1, :t],
                None if frames is None else frames[b:b + 1])
            assert margin < TIE, (b, t, margin)


TRANSFORMER_ARCHS = [a for a in list_configs() if a != "densenet-fl"]


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_decode_state_shape_matches_the_reference(arch):
    """Every transformer config as registered, at decode_32k (B 128,
    32,768 slots): the meta-device state has the reference's abstract
    state's shapes and dtypes, leaf for leaf, and holds no memory."""
    assert len(TRANSFORMER_ARCHS) == 11
    rstate, _ = RS.make_decode_state_shape(rget(arch),
                                           R_SHAPES["decode_32k"])
    tstate = TS.make_decode_state_shape(tget(arch), T_SHAPES["decode_32k"])
    assert tstate["index"] == 0
    rleaves = jax.tree.leaves(rstate["caches"])
    tleaves = tree_leaves(tstate["caches"])
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tleaves] == [(tuple(r.shape), str(r.dtype))
                                  for r in rleaves]
    assert all(t.device.type == "meta" for t in tleaves)


@pytest.mark.parametrize("case", ["recurrentgemma-9b/hybrid",
                                  "whisper-base"])
def test_decode_state_round_trips_through_numpy(case):
    """to_numpy then from_numpy gives the same nodes (LRUState, KVCache,
    the cross block's dict) and bits, on copies: stepping the copy leaves
    the original as it was."""
    _, tc, _, tp = load_case(case)
    _, state = _states(case, 2, 16)
    with torch.inference_mode():
        _, state = TT.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                                  state, tc)
    back = decode_state_from_numpy(decode_state_to_numpy(state), "cpu")
    assert back["index"] == state["index"] == 1
    kinds = [type(n) for c in back["caches"] for n in c.values()]
    assert kinds == [type(n) for c in state["caches"] for n in c.values()]
    if case.startswith("whisper"):
        assert kinds == [dict]
    else:
        assert kinds == [LRUState, LRUState, KVCache]
    before = [t.clone() for t in tree_leaves(state["caches"])]
    for a, b in zip(tree_leaves(back["caches"]),
                    tree_leaves(state["caches"])):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with torch.inference_mode():
        TT.decode_step(tp, torch.ones((2, 1), dtype=torch.int32), back, tc)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(state["caches"])))
