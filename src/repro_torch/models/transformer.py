"""Composable decoder stack (the port of `repro.models.transformer`): the
dense or MoE FFN, attention and SSM blocks, stages, the full-sequence
forward, the decode state and the single-token decode step.

A model is a sequence of *stages* (``StageSpec``); each stage is a pattern
of block kinds repeated N times. The reference `vmap`s the block
initialiser over the repeats and `scan`s over them; here every leaf of a
stage carries the same leading repeat axis and the stage loops over it in
Python, taking repeat r with `leaf[r]` (a view).

Block kinds:
  global / local  -> attention (+ dense or MoE FFN)
  ssm             -> Mamba-2 SSD (self-contained, no FFN)
The reference's `recurrent` (RG-LRU), `cross` and `enc` blocks (whisper)
and the vision frontend raise `NotImplementedError` (ROADMAP A.11 part 2).

Serving (prefill and decode) runs under `torch.inference_mode()`, the
train step under autograd (`repro_torch.launch.steps`). `forward(...,
remat=True)` recomputes one repeat of a stage's pattern in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` over its scan
body) and keeps only the repeat's input. The decode state is the caches,
on the params' device, and `index`, a host int, so a step reads nothing
back from the device; `decode_step` writes the caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, SSM,
                                      ModelConfig, StageSpec)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)

_SERVED = (GLOBAL_ATTN, LOCAL_ATTN, SSM)     # the block kinds ported
VISION_DIM = 1024  # stub CLIP/SigLIP patch-embedding width


def _unported(what: str):
    return NotImplementedError(f"{what} comes with ROADMAP A.11 part 2")


# ---------------------------------------------------------------------------
# Block init / apply / decode


def _ffn_init(generator: torch.Generator, cfg: ModelConfig):
    if cfg.num_experts:
        return {"moe": M.moe_init(generator, cfg)}
    return {"norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg),
                                   generator.device),
            "mlp": L.mlp_init(generator, cfg)}


def _ffn_apply(params, x, cfg: ModelConfig, moe_groups: int = 1):
    if cfg.num_experts:
        return M.moe_apply(params["moe"], x, cfg, groups=moe_groups)
    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_act), 0.0


def _check_kind(kind: str):
    if kind not in _SERVED:
        raise _unported(f"the {kind!r} block")


def block_init(generator: torch.Generator, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    if kind == SSM:
        return {"ssm": S.ssm_init(generator, cfg)}
    return {"attn": A.attention_init(generator, cfg, kind),
            "ffn": _ffn_init(generator, cfg)}


def block_apply(params, x, cfg: ModelConfig, kind: str, *, positions=None,
                q_chunk=512, moe_groups=1):
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_apply(params["ssm"], x, cfg), 0.0
    x = A.attention_apply(params["attn"], x, cfg, kind, q_chunk=q_chunk,
                          positions=positions)
    return _ffn_apply(params["ffn"], x, cfg, moe_groups)


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype, device=None):
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_init_state(cfg, batch, dtype, device)
    return A.init_cache(cfg, kind, batch, seq_len, dtype, device)


def block_decode(params, x, cache, index: int, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_decode(params["ssm"], x, cache, cfg)
    x, cache = A.attention_decode(params["attn"], x, cache, index, cfg, kind)
    x, _ = _ffn_apply(params["ffn"], x, cfg)
    return x, cache


# ---------------------------------------------------------------------------
# Stage (repeats of a pattern, stacked on a leading axis)


def stage_init(generator: torch.Generator, cfg: ModelConfig,
               spec: StageSpec):
    """One tree per repeat ({"pos<j>": block}), stacked leafwise on a
    leading repeat axis. Each repeat is drawn and copied into the stack
    before the next is drawn, so the stack and one repeat are all that
    is held at once."""
    def one_rep():
        return {f"pos{j}": block_init(generator, cfg, kind)
                for j, kind in enumerate(spec.pattern)}
    first = one_rep()
    stack = tree_map(lambda a: a.new_empty((spec.repeats, *a.shape)), first)
    tree_map(lambda s, a: s[0].copy_(a), stack, first)
    del first
    for r in range(1, spec.repeats):
        tree_map(lambda s, a: s[r].copy_(a), stack, one_rep())
    return stack


def _reps(stage_params, repeats: int):
    """Every repeat of a stage's stacked leaves, as views from one
    `unbind` a leaf: its gradient is one stack of the repeats' gradients,
    where `a[r]` would add a zero-padded leaf per repeat."""
    leaves, structure = tree_flatten(stage_params)
    pieces = [a.unbind(0) for a in leaves]
    return [tree_unflatten(structure, [p[r] for p in pieces])
            for r in range(repeats)]


def stage_apply(stage_params, x, cfg: ModelConfig, spec: StageSpec, *,
                positions=None, q_chunk=512, remat=True, moe_groups=1):
    """The stage's repeats in order. With `remat` (and autograd
    recording), each repeat's blocks run under a checkpoint: their
    activations are recomputed in the backward."""
    def body(rep, h):
        aux = 0.0
        for j, kind in enumerate(spec.pattern):
            h, a = block_apply(rep[f"pos{j}"], h, cfg, kind,
                               positions=positions, q_chunk=q_chunk,
                               moe_groups=moe_groups)
            aux = aux + a
        return h, aux

    recompute = remat and torch.is_grad_enabled()
    aux = 0.0
    for rep in _reps(stage_params, spec.repeats):
        if recompute:
            x, a = checkpoint(body, rep, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(rep, x)
        aux = aux + a
    return x, aux


def stage_init_cache(cfg: ModelConfig, spec: StageSpec, batch: int,
                     seq_len: int, dtype, device=None):
    """{"pos<j>": a KVCache or SSMState}, each tensor zeros stacked on a
    leading repeat axis, as the stage's parameters."""
    out = {}
    for j, kind in enumerate(spec.pattern):
        c = block_init_cache(cfg, kind, batch, seq_len, dtype, device)
        out[f"pos{j}"] = type(c)(*(t.new_zeros((spec.repeats, *t.shape))
                                   for t in c))
    return out


def stage_decode(stage_params, caches, x, index: int, cfg: ModelConfig,
                 spec: StageSpec):
    """One token through the stage; the stacked caches are written in
    place (an attention block writes its slot, an SSM block's new state is
    copied into its repeat's rows)."""
    for r, rep in enumerate(_reps(stage_params, spec.repeats)):
        for j, kind in enumerate(spec.pattern):
            stacked = caches[f"pos{j}"]
            cache = type(stacked)(*(t[r] for t in stacked))
            x, new = block_decode(rep[f"pos{j}"], x, cache, index, cfg, kind)
            if kind == SSM:
                for dst, src in zip(cache, new):
                    dst.copy_(src)
    return x, caches


# ---------------------------------------------------------------------------
# Full model


def _check_model(cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        raise _unported("the encoder-decoder stack (whisper)")
    if cfg.frontend == "vision":
        raise _unported("the vision frontend (phi-3-vision)")
    for kind in set(cfg.layer_kinds):
        _check_kind(kind)


def init_params(seed: int, cfg: ModelConfig, *,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree: {"emb", "stages" (a
    list, one stacked tree per stage), "final_norm"}, drawn on `device`
    (default the card) from a generator seeded with `seed`. The same
    keys and shapes as `repro.models.transformer.init_params`, other
    numbers: carry the reference's parameters across with
    `repro_torch.weights.zoo_params_from_numpy`."""
    _check_model(cfg)
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(int(seed))
    return {
        "emb": L.embedding_init(generator, cfg),
        "stages": [stage_init(generator, cfg, spec) for spec in cfg.stages],
        "final_norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg),
                                     generator.device),
    }


def forward(params, batch, cfg: ModelConfig, *, q_chunk=512, remat=True,
            moe_groups=1):
    """Full-sequence forward. batch: {"tokens": (B, S) int}. Returns
    (logits (B, S, V), aux loss). `remat` matters only where autograd
    records (`stage_apply`)."""
    _check_model(cfg)
    x = L.embed(params["emb"], batch["tokens"], cfg)
    aux = 0.0
    for spec, sp in zip(cfg.stages, params["stages"]):
        x, a = stage_apply(sp, x, cfg, spec, q_chunk=q_chunk, remat=remat,
                           moe_groups=moe_groups)
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["emb"], x, cfg), aux


def init_decode_state(params: Optional[dict], cfg: ModelConfig, batch: int,
                      seq_len: int, dtype, *, device=None):
    """Decode state: {"caches": one stacked tree per stage, "index": 0}.
    The caches go on the params' device (or `device` where params is
    None: "meta" gives the shapes alone)."""
    _check_model(cfg)
    if params is not None:
        device = tree_leaves(params)[0].device
    caches = [stage_init_cache(cfg, spec, batch, seq_len, dtype, device)
              for spec in cfg.stages]
    return {"caches": caches, "index": 0}


def decode_step(params, token, state, cfg: ModelConfig):
    """token: (B, 1) int. Returns (logits (B, 1, V), new state); the
    caches are written in place and `index` advances by one."""
    x = L.embed(params["emb"], token, cfg)
    index = state["index"]
    for spec, sp, cache in zip(cfg.stages, params["stages"],
                               state["caches"]):
        x, _ = stage_decode(sp, cache, x, index, cfg, spec)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["emb"], x, cfg)
    return logits, {"caches": state["caches"], "index": index + 1}


# ---------------------------------------------------------------------------
# Loss


def lm_loss(logits, labels, mask=None):
    """Cross-entropy in float32 with an optional validity mask."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
