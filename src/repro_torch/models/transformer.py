"""Composable decoder stack (the port of `repro.models.transformer`): the
dense or MoE FFN, attention, RG-LRU and SSM blocks, the encoder and
cross-attention blocks, stages, the vision frontend, the full-sequence
forward, the decode state and the single-token decode step.

A model is a sequence of *stages* (``StageSpec``); each stage is a pattern
of block kinds repeated N times. The reference `vmap`s the block
initialiser over the repeats and `scan`s over them; here every leaf of a
stage carries the same leading repeat axis and the stage loops over it in
Python, taking repeat r with `leaf[r]` (a view).

Block kinds:
  global / local  -> attention (+ dense or MoE FFN)
  enc             -> bidirectional attention (+ FFN)   [whisper encoder]
  cross           -> causal self-attn + cross-attn + FFN [whisper decoder]
  recurrent       -> RG-LRU (+ FFN)
  ssm             -> Mamba-2 SSD (self-contained, no FFN)
The `cnn` kind (densenet-fl) is `repro_torch.models.densenet`'s model,
not this stack's, and raises here.

Serving (prefill and decode) runs under `torch.inference_mode()`, the
train step under autograd (`repro_torch.launch.steps`). `forward(...,
remat=True)` recomputes one repeat of a stage's pattern in the backward
(`torch.utils.checkpoint`, the reference's `jax.checkpoint` over its scan
body) and keeps only the repeat's input. The decode state is the caches,
on the params' device, and `index`, a host int, so a step reads nothing
back from the device; `decode_step` writes the caches in place.

`tp` (a `layers.TensorParallel`, None by default) runs a rank's part of a
tensor-parallel program over the model axis: `forward`, `decode_step`,
`init_decode_state` and `lm_loss` take it, and it reaches every block
beside `moe_ep`/`moe_group`. The params are then the rank's pieces
(`repro_torch.sharding.shard_params`), the logits the rank's vocab
columns, the caches its kv heads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (CROSS_ATTN, ENC_ATTN, GLOBAL_ATTN,
                                      LOCAL_ATTN, RECURRENT, SSM,
                                      ModelConfig, StageSpec)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)

_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, ENC_ATTN, CROSS_ATTN, RECURRENT, SSM)
_STATEFUL = (RECURRENT, SSM)    # a decode step returns a new state
VISION_DIM = 1024  # stub CLIP/SigLIP patch-embedding width


# ---------------------------------------------------------------------------
# Block init / apply / decode


def _ffn_init(generator: torch.Generator, cfg: ModelConfig):
    if cfg.num_experts:
        return {"moe": M.moe_init(generator, cfg)}
    return {"norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg),
                                   generator.device),
            "mlp": L.mlp_init(generator, cfg)}


def _ffn_apply(params, x, cfg: ModelConfig, moe_groups: int = 1,
               moe_ep=None, moe_group=None, tp=None):
    """The FFN: dense, or MoE. `moe_ep=(mesh, data_axes)` takes the
    expert-parallel path (`moe.moe_apply_ep`) where the mesh's model axis
    divides the experts, else the grouped one, as the reference does
    (mixtral at model 16); `moe_group` is the data-parallel group whose
    tokens the grouped path's balance loss covers (`moe.moe_apply`).
    `tp`: the MLP's d_ff pieces (`TensorParallel.mlp`), or the router
    gathered whole and the rank's experts over the model group."""
    if cfg.num_experts:
        p = params["moe"]
        if tp is not None:
            p = dict(p, router=tp.whole(p["router"], -1, cfg.num_experts))
        if moe_ep is not None:
            mesh, data_axes = moe_ep
            if cfg.num_experts % mesh.size(
                    mesh.mesh_dim_names.index("model")) == 0:
                return M.moe_apply_ep(p, x, cfg, mesh, data_axes=data_axes)
        return M.moe_apply(p, x, cfg, groups=moe_groups,
                           data_group=moe_group,
                           model_group=None if tp is None else tp.group)
    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    if tp is not None:
        return x + tp.mlp(params["mlp"], h, cfg.mlp_act), 0.0
    return x + L.mlp_apply(params["mlp"], h, cfg.mlp_act), 0.0


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise NotImplementedError(
            f"the {kind!r} block is not a block of the transformer stack "
            f"(densenet-fl's model is repro_torch.models.densenet)")


def block_init(generator: torch.Generator, cfg: ModelConfig, kind: str):
    _check_kind(kind)
    if kind == SSM:
        return {"ssm": S.ssm_init(generator, cfg)}
    if kind == RECURRENT:
        return {"rec": R.rglru_init(generator, cfg),
                "ffn": _ffn_init(generator, cfg)}
    if kind == CROSS_ATTN:
        return {"attn": A.attention_init(generator, cfg, GLOBAL_ATTN),
                "xattn": A.attention_init(generator, cfg, GLOBAL_ATTN),
                "ffn": _ffn_init(generator, cfg)}
    return {"attn": A.attention_init(generator, cfg, kind),
            "ffn": _ffn_init(generator, cfg)}


def block_apply(params, x, cfg: ModelConfig, kind: str, *, positions=None,
                enc_out=None, q_chunk=512, moe_groups=1, moe_ep=None,
                moe_group=None, tp=None):
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_apply(params["ssm"], x, cfg), 0.0
    if kind == RECURRENT:
        x = R.rglru_apply(params["rec"], x, cfg)
    elif kind == CROSS_ATTN:
        x = A.attention_apply(params["attn"], x, cfg, GLOBAL_ATTN,
                              q_chunk=q_chunk, positions=positions)
        k, v = A.cross_kv(params["xattn"], enc_out, cfg)
        x = A.attention_apply(params["xattn"], x, cfg, GLOBAL_ATTN,
                              q_chunk=q_chunk, kv_override=(k, v, False))
    else:
        x = A.attention_apply(params["attn"], x, cfg, kind, q_chunk=q_chunk,
                              positions=positions, tp=tp)
    return _ffn_apply(params["ffn"], x, cfg, moe_groups, moe_ep, moe_group,
                      tp)


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     dtype, device=None, enc_out=None, params=None,
                     kv_heads=None):
    """One block's decode state: a KVCache, an SSMState, an LRUState, or
    for a cross block {"self": KVCache, "cross_k", "cross_v"}, the latter
    `cross_kv` of `enc_out` ((B, T, D)) with `params`, or zeros of their
    shape where `params` is None (the meta device's shapes). `kv_heads`:
    a tensor-parallel rank's attention cache."""
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_init_state(cfg, batch, dtype, device)
    if kind == RECURRENT:
        return R.rglru_init_state(None if params is None else params["rec"],
                                  cfg, batch, dtype, device)
    if kind == CROSS_ATTN:
        if params is None:
            shape = (batch, enc_out.shape[1], cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            ck = torch.zeros(shape, dtype=enc_out.dtype, device=device)
            cv = torch.zeros_like(ck)
        else:
            ck, cv = A.cross_kv(params["xattn"], enc_out, cfg)
        return {"self": A.init_cache(cfg, GLOBAL_ATTN, batch, seq_len, dtype,
                                     device),
                "cross_k": ck, "cross_v": cv}
    return A.init_cache(cfg, kind, batch, seq_len, dtype, device, kv_heads)


def block_decode(params, x, cache, index: int, cfg: ModelConfig, kind: str,
                 tp=None):
    _check_kind(kind)
    if kind == SSM:
        return S.ssm_decode(params["ssm"], x, cache, cfg)
    if kind == RECURRENT:
        x, cache = R.rglru_decode(params["rec"], x, cache, cfg)
    elif kind == CROSS_ATTN:
        x, self_c = A.attention_decode(params["attn"], x, cache["self"],
                                       index, cfg, GLOBAL_ATTN)
        x, _ = A.attention_decode(
            params["xattn"], x, None, index, cfg, GLOBAL_ATTN,
            kv_override=(cache["cross_k"], cache["cross_v"]))
        cache = dict(cache, self=self_c)
    else:
        x, cache = A.attention_decode(params["attn"], x, cache, index, cfg,
                                      kind, tp=tp)
    x, _ = _ffn_apply(params["ffn"], x, cfg, tp=tp)
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
                positions=None, enc_out=None, q_chunk=512, remat=True,
                moe_groups=1, moe_ep=None, moe_group=None, tp=None):
    """The stage's repeats in order. With `remat` (and autograd
    recording), each repeat's blocks run under a checkpoint: their
    activations are recomputed in the backward."""
    def body(rep, h, enc):
        aux = 0.0
        for j, kind in enumerate(spec.pattern):
            h, a = block_apply(rep[f"pos{j}"], h, cfg, kind,
                               positions=positions, enc_out=enc,
                               q_chunk=q_chunk, moe_groups=moe_groups,
                               moe_ep=moe_ep, moe_group=moe_group, tp=tp)
            aux = aux + a
        return h, aux

    recompute = remat and torch.is_grad_enabled()
    aux = 0.0
    for rep in _reps(stage_params, spec.repeats):
        if recompute:
            x, a = checkpoint(body, rep, x, enc_out, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(rep, x, enc_out)
        aux = aux + a
    return x, aux


def _stack(nodes):
    """Nodes of one structure (a tensor, a NamedTuple or a dict of them)
    stacked leafwise on a new leading axis."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_stack(list(ts)) for ts in zip(*nodes)))
    return torch.stack(nodes)


def _rep_of(node, r: int):
    """Repeat r of a stacked state node: views of each tensor's row r."""
    if isinstance(node, dict):
        return {k: _rep_of(v, r) for k, v in node.items()}
    if isinstance(node, tuple):
        return type(node)(*(t[r] for t in node))
    return node[r]


def stage_init_cache(cfg: ModelConfig, spec: StageSpec, batch: int,
                     seq_len: int, dtype, device=None, enc_out=None,
                     stage_params=None, kv_heads=None):
    """{"pos<j>": a block's state (`block_init_cache`)}, each tensor
    stacked on a leading repeat axis, as the stage's parameters. A cross
    block's "cross_k" and "cross_v" are each repeat's `cross_kv` of
    `enc_out` with `stage_params`; without them (the meta device), zeros
    of their shape."""
    reps = (_reps(stage_params, spec.repeats) if stage_params is not None
            else [None] * spec.repeats)
    out = {}
    for j, kind in enumerate(spec.pattern):
        if kind == CROSS_ATTN:
            out[f"pos{j}"] = _stack([block_init_cache(
                cfg, kind, batch, seq_len, dtype, device, enc_out,
                None if rep is None else rep[f"pos{j}"]) for rep in reps])
            continue
        c = block_init_cache(cfg, kind, batch, seq_len, dtype, device,
                             kv_heads=kv_heads)
        out[f"pos{j}"] = type(c)(*(t.new_zeros((spec.repeats, *t.shape))
                                   for t in c))
    return out


def stage_decode(stage_params, caches, x, index: int, cfg: ModelConfig,
                 spec: StageSpec, tp=None):
    """One token through the stage; the stacked caches are written in
    place (an attention block writes its slot, a cross block its self
    cache's slot; an SSM or RG-LRU block's new state is copied into its
    repeat's rows)."""
    for r, rep in enumerate(_reps(stage_params, spec.repeats)):
        for j, kind in enumerate(spec.pattern):
            cache = _rep_of(caches[f"pos{j}"], r)
            x, new = block_decode(rep[f"pos{j}"], x, cache, index, cfg, kind,
                                  tp)
            if kind in _STATEFUL:
                for dst, src in zip(cache, new):
                    dst.copy_(src)
    return x, caches


# ---------------------------------------------------------------------------
# Full model


def _check_model(cfg: ModelConfig):
    for kind in set(cfg.layer_kinds):
        _check_kind(kind)


def _enc_spec(cfg: ModelConfig) -> StageSpec:
    return StageSpec((ENC_ATTN,), cfg.encoder_layers)


def init_params(seed: int, cfg: ModelConfig, *,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's tree: {"emb", "stages" (a
    list, one stacked tree per stage), "final_norm"}, and for an
    encoder-decoder {"enc_stage", "enc_norm"}, for the vision frontend
    {"vis_proj"}; drawn on `device` (default the card) from a generator
    seeded with `seed`; on the meta device the tree's shapes and dtypes
    alone. The same keys and shapes as
    `repro.models.transformer.init_params`, other numbers: carry the
    reference's parameters across with
    `repro_torch.weights.zoo_params_from_numpy`."""
    _check_model(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        generator = L.MetaGenerator()
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    dt = L.dtype_of(cfg)
    p = {
        "emb": L.embedding_init(generator, cfg),
        "stages": [stage_init(generator, cfg, spec) for spec in cfg.stages],
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, generator.device),
    }
    if cfg.is_encoder_decoder:
        p["enc_stage"] = stage_init(generator, cfg, _enc_spec(cfg))
        p["enc_norm"] = L.rmsnorm_init(cfg.d_model, dt, generator.device)
    if cfg.frontend == "vision":
        p["vis_proj"] = L.dense_init(generator, VISION_DIM, cfg.d_model, dt)
    return p


def _encode(params, frames, cfg: ModelConfig, q_chunk=512, remat=True):
    """The encoder's stage over frames (B, T, D) in the model's dtype,
    then its norm."""
    h, _ = stage_apply(params["enc_stage"], frames, cfg, _enc_spec(cfg),
                       q_chunk=q_chunk, remat=remat)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig, *, q_chunk=512, remat=True,
            moe_groups=1, moe_ep=None, moe_group=None, tp=None):
    """Full-sequence forward. batch: {"tokens": (B, S) int}, with
    "image_embeds" (B, N, VISION_DIM) float32 for the vision frontend or
    "frames" (B, T, D) for an encoder-decoder. Returns (logits (B, S, V),
    aux loss): with images, logits on the text positions only. `remat`
    matters only where autograd records (`stage_apply`). `moe_ep` and
    `moe_group` reach the MoE blocks (`_ffn_apply`): a rank's batch under
    expert or data parallelism; `tp` the rank's part of a tensor-parallel
    program (its vocab columns of the logits)."""
    _check_model(cfg)
    dt = L.dtype_of(cfg)
    enc_out = None
    x = L.embed(params["emb"], batch["tokens"], cfg, tp)
    if cfg.frontend == "vision":
        # the reference's image_embeds (f32) @ vis_proj promotes to f32
        img = (batch["image_embeds"].float() @ params["vis_proj"].float()
               ).to(dt)
        x = torch.cat([img, x], dim=1)
    elif cfg.is_encoder_decoder:
        enc_out = _encode(params, batch["frames"].to(dt), cfg, q_chunk,
                          remat)
    aux = 0.0
    for spec, sp in zip(cfg.stages, params["stages"]):
        x, a = stage_apply(sp, x, cfg, spec, enc_out=enc_out,
                           q_chunk=q_chunk, remat=remat,
                           moe_groups=moe_groups, moe_ep=moe_ep,
                           moe_group=moe_group, tp=tp)
        aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.frontend == "vision":
        x = x[:, batch["image_embeds"].shape[1]:]   # the text positions
    return L.unembed(params["emb"], x, cfg, tp), aux


def init_decode_state(params: Optional[dict], cfg: ModelConfig, batch: int,
                      seq_len: int, dtype, *, enc_frames=None, device=None,
                      tp=None):
    """Decode state: {"caches": one stacked tree per stage, "index": 0}.
    The caches go on the params' device (or `device` where params is
    None: "meta" gives the shapes alone). An encoder-decoder takes its
    frames (B, T, D): the encoder runs on them once (without autograd)
    and each cross block keeps its `cross_kv`; on the meta device only
    their shape is read. `tp`: a tensor-parallel rank's state, its
    caches holding its kv heads alone (ROADMAP C30)."""
    _check_model(cfg)
    enc_out = None
    if cfg.is_encoder_decoder:
        if enc_frames is None:
            raise ValueError(f"{cfg.name}'s decode state needs enc_frames "
                             f"(B, T, d_model)")
        enc_out = enc_frames
    if params is not None:
        device = tree_leaves(params)[0].device
        if enc_out is not None:
            with torch.no_grad():
                enc_out = _encode(params, enc_frames.to(L.dtype_of(cfg)),
                                  cfg)
    elif enc_out is not None:
        enc_out = torch.empty(enc_out.shape, dtype=L.dtype_of(cfg),
                              device="meta")
    stages = ([None] * len(cfg.stages) if params is None
              else params["stages"])
    caches = [stage_init_cache(cfg, spec, batch, seq_len, dtype, device,
                               enc_out, sp,
                               None if tp is None else tp.kv_heads)
              for spec, sp in zip(cfg.stages, stages)]
    return {"caches": caches, "index": 0}


def decode_step(params, token, state, cfg: ModelConfig, tp=None):
    """token: (B, 1) int. Returns (logits (B, 1, V), new state); the
    caches (KV, SSM and RG-LRU states, a cross block's self cache) are
    written in place and `index` advances by one (ROADMAP C19: stepping
    twice from one state is no replay; copy it first). `tp`: the rank's
    part, its vocab columns of the logits."""
    x = L.embed(params["emb"], token, cfg, tp)
    index = state["index"]
    for spec, sp, cache in zip(cfg.stages, params["stages"],
                               state["caches"]):
        x, _ = stage_decode(sp, cache, x, index, cfg, spec, tp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["emb"], x, cfg, tp)
    return logits, {"caches": state["caches"], "index": index + 1}


# ---------------------------------------------------------------------------
# Loss


def lm_loss(logits, labels, mask=None, tp=None):
    """Cross-entropy in float32 with an optional validity mask. Under
    `tp`, logits that are the rank's vocab columns take the
    vocab-parallel form (`TensorParallel.nll`); every rank gets the
    global loss."""
    logits = logits.float()
    if tp is not None and logits.shape[-1] != tp.cfg.vocab_size:
        nll = tp.nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
