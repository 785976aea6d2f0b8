"""Step functions of the model zoo and their abstract arguments (the port
of `repro.launch.steps`): the train step (AdamW, clipping by the global
norm, microbatches, remat), prefill, the greedy serve step, the decode
state's shapes, the paper's eq.-4 aggregation step over a zoo model's tree
(`make_agg_step`, and `make_agg_step_opt`'s bf16 product), the FL round
(M buffered clients' local SGD, eq. 3, then eq. 4: `make_fl_round_step`),
the five `*_shardings` functions and `build`, the dispatcher the dry run
(`launch/dryrun.py`) calls.

The steps run on the device their params are on (`transformer.
init_params(seed, cfg)` draws them on the card by default; on the meta
device, as the `*_shardings` functions make them, a step checks every
shape and allocates nothing). Prefill and the serve step run under
`torch.inference_mode()`; the train step runs autograd on the parameter
leaves and writes the params and the AdamW state in place (ROADMAP C20),
every leaf of the tree: the encoder's, the vision projection's and the
RG-LRU's too. The serve step writes the decode state in place (C19): KV
caches, SSM and RG-LRU states and a cross block's self cache. The
aggregation steps return new params and write nothing given.

One device has no mesh: the `*_shardings` functions take `mesh=None` and
return `(args, None, None)`, and a mesh, expert parallelism
(`moe_groups=-2`) or a sharded buffer raises, naming ROADMAP A.10.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.aggregation import apply_aggregation
from repro_torch.core.staleness import staleness_compensation
from repro_torch.kernels.agg.ops import flat_tree
from repro_torch.launch import input_specs as IS
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_apply, adamw_init, clip_by_global_norm
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def _no_mesh(mesh, moe_groups: int = 1):
    if mesh is not None or moe_groups == -2:
        raise NotImplementedError(
            "meshes, shardings and expert parallelism (moe_groups=-2) come "
            "with ROADMAP A.10; the port's steps run on one device")


def default_num_micro(cfg: ModelConfig, shape: ShapeConfig,
                      mesh=None) -> int:
    """A microbatch count that gives each data shard ~1 sequence a
    microbatch (bounds activation memory at long sequences); one device
    is one data shard."""
    _no_mesh(mesh)
    return min(max(1, shape.global_batch), 16)


# ---------------------------------------------------------------------------
# Train


def make_loss_and_grad(cfg: ModelConfig, *, num_micro: int = 1,
                       q_chunk: int = 512, aux_weight: float = 0.01,
                       moe_groups: int = 1):
    """loss_and_grad(params, batch) -> (loss, grads): the loss
    `lm_loss + aux_weight * aux` (remat on, as in the reference's step)
    and its gradient in the params' tree, both device tensors. With
    `num_micro` > 1 the batch is split into that many microbatches along
    its first dim; their gradients are added in order into float32 sums,
    and the sums and the loss are divided by `num_micro`, as the
    reference's scan does. With one, the gradients are in the params'
    dtypes."""
    def loss_fn(params, mb):
        logits, aux = T.forward(params, mb, cfg, q_chunk=q_chunk,
                                moe_groups=moe_groups)
        return T.lm_loss(logits, mb["labels"]) + aux_weight * aux

    def loss_and_grad(params, batch):
        leaves, structure = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        tree = tree_unflatten(structure, live)
        if num_micro == 1:
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, live)
            return loss.detach(), tree_unflatten(structure, list(grads))
        micro = {k: v.reshape(num_micro, v.shape[0] // num_micro,
                              *v.shape[1:]) for k, v in batch.items()}
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(num_micro):
            l_i = loss_fn(tree, {k: v[i] for k, v in micro.items()})
            for acc, g in zip(sums, torch.autograd.grad(l_i, live)):
                acc.add_(g)
            loss = loss + l_i.detach()
        for acc in sums:
            acc.div_(num_micro)
        return loss / num_micro, tree_unflatten(structure, sums)

    return loss_and_grad


def make_train_step(cfg: ModelConfig, mesh=None, *, num_micro: int = 1,
                    lr: float = 3e-4, q_chunk: int = 512,
                    aux_weight: float = 0.01, clip_norm: float = 1.0,
                    moe_groups: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradient of `make_loss_and_grad`,
    then `update`: the gradient clipped to `clip_norm` by its global norm,
    one AdamW step at `lr`. params and opt_state (`optim.adamw_init`) are
    written in place and returned; the metrics are device tensors, so a
    step reads nothing back. `q_chunk` is accepted and, as in prefill,
    changes nothing (`models/attention.py`). The step's two halves are its
    attributes `loss_and_grad(params, batch)` and `update(params,
    opt_state, grads) -> (opt_state, grad_norm)`, for a profiler that
    times them apart."""
    _no_mesh(mesh, moe_groups)
    loss_and_grad = make_loss_and_grad(
        cfg, num_micro=num_micro, q_chunk=q_chunk, aux_weight=aux_weight,
        moe_groups=max(moe_groups, 1))

    def update(params, opt_state, grads):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        return adamw_apply(grads, opt_state, params, lr), gnorm

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grad(params, batch)
        opt_state, gnorm = update(params, opt_state, grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    train_step.loss_and_grad, train_step.update = loss_and_grad, update
    return train_step


# ---------------------------------------------------------------------------
# Prefill and decode


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 512,
                      moe_groups: int = 1):
    """prefill_step(params, batch) -> next-token logits (B, V)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, _ = T.forward(params, batch, cfg, q_chunk=q_chunk,
                                  moe_groups=moe_groups)
            return logits[:, -1, :]

    return prefill_step


def make_decode_state_shape(cfg: ModelConfig, shape: ShapeConfig):
    """The decode state at `shape` (batch, cache length) on the meta
    device: its tensors carry shapes and dtypes and hold no memory. An
    encoder-decoder's comes from frames (batch, encoder_seq, d_model), as
    the reference's."""
    B = shape.global_batch
    frames = (torch.empty((B, cfg.encoder_seq, cfg.d_model), device="meta")
              if cfg.is_encoder_decoder else None)
    return T.init_decode_state(None, cfg, B, shape.seq_len,
                               getattr(torch, cfg.param_dtype),
                               enc_frames=frames, device="meta")


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, token (B, 1)) -> (greedy next token
    (B, 1) int32, new state)."""
    def serve_step(params, state, token):
        with torch.inference_mode():
            logits, state = T.decode_step(params, token, state, cfg)
            next_token = torch.argmax(logits[:, -1, :], dim=-1)
            return next_token.to(torch.int32)[:, None], state

    return serve_step


# ---------------------------------------------------------------------------
# Abstract arguments (meta tensors: shapes and dtypes, no memory)


def _meta(spec):
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _meta_params(cfg: ModelConfig):
    return T.init_params(0, cfg, device="meta")


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, None, None) of the train step: (params, AdamW state, batch)
    on the meta device."""
    _no_mesh(mesh)
    params = _meta_params(cfg)
    batch = {k: _meta(v) for k, v in IS.train_batch_specs(cfg, shape).items()}
    return (params, adamw_init(params), batch), None, None


def prefill_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, None, None) of the prefill step: (params, batch) on the meta
    device."""
    _no_mesh(mesh)
    batch = {k: _meta(v)
             for k, v in IS.prefill_batch_specs(cfg, shape).items()}
    return (_meta_params(cfg), batch), None, None


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, None, None) of the serve step: (params, decode state, token)
    on the meta device; the state's `index` is the host int 0."""
    _no_mesh(mesh)
    return (_meta_params(cfg), make_decode_state_shape(cfg, shape),
            _meta(IS.decode_token_spec(cfg, shape))), None, None


# ---------------------------------------------------------------------------
# FedSpace aggregation step (the paper's eq. 4 at datacenter scale)


def make_agg_step(cfg: ModelConfig, *, alpha: float = 0.5):
    """agg_step(params, update_stack, staleness (M,) int) -> new params:
    `apply_aggregation`, one kernel launch per (params, updates) dtype
    pair of the tree. The params and the stack are read in place where
    their leaves are views of one buffer a dtype (`flat_tree`), else
    copied into one."""
    def agg_step(params, update_stack, staleness):
        return apply_aggregation(params, update_stack, staleness,
                                 alpha=alpha)

    return agg_step


def make_agg_step_opt(cfg: ModelConfig, mesh=None, *, alpha: float = 0.5,
                      reduce_dtype=torch.bfloat16):
    """The reference's hand-scheduled eq. 4 on one shard: per leaf, the
    staleness weights' product with the M updates in `reduce_dtype`
    (`torch.tensordot`, a plain product outside the kernel as in the
    reference, where it runs outside Pallas), then the float32 add to the
    params, cast to their dtype. The reference's psum over the data axis
    is the identity on one device; a mesh raises (ROADMAP A.10)."""
    _no_mesh(mesh)

    def agg_step(params, update_stack, staleness):
        c = staleness_compensation(staleness, alpha)
        w = (c / c.sum().clamp(min=1e-12)).to(reduce_dtype)

        def one(p, u):
            delta = torch.tensordot(w, u.to(reduce_dtype), dims=1)
            return (p.float() + delta.float()).to(p.dtype)

        return tree_map(one, params, update_stack)

    return agg_step


def agg_shardings(cfg: ModelConfig, mesh=None, *, buffer_m: int = 96):
    """(args, None, None) of the agg step: (params, a buffer of `buffer_m`
    updates in the params' dtypes, staleness (M,) int32) on the meta
    device, the params and the updates laid out as views of one buffer a
    dtype (`flat_tree`), as the agg step reads them in place."""
    _no_mesh(mesh)
    params = flat_tree(_meta_params(cfg))
    updates = flat_tree(params, lead=(buffer_m,))
    staleness = torch.empty((buffer_m,), dtype=torch.int32, device="meta")
    return (params, updates, staleness), None, None


# ---------------------------------------------------------------------------
# Full FL round step: M buffered clients' local SGD (eq. 3), then eq. 4
# — the paper's technique as one datacenter step (used when the ground
# station replays buffered client rounds, e.g. for utility samples at
# scale).


def make_fl_round_step(cfg: ModelConfig, *, local_steps: int = 4,
                       client_lr: float = 0.05, alpha: float = 0.5,
                       q_chunk: int = 512):
    """fl_round_step(params, client_batches {"tokens", "labels": (M,
    local_steps, B, S)}, staleness (M,) int) -> new params. The clients
    run one after another (the kernels' autograd functions do not batch,
    and one card cannot hold M copies of a large model): each takes
    `local_steps` SGD steps from `params` through `make_loss_and_grad`
    (the loss `lm_loss + 0.01 * aux`, remat on), each leaf updated as
    `(w.f32 - client_lr * g.f32)` cast back to w's dtype, and writes its
    update `final.f32 - params.f32` into row m of one (M, size) float32
    buffer a params dtype (`flat_tree`). Then `apply_aggregation` reads
    those rows in place: one kernel launch per params dtype (one for a
    model of one dtype)."""
    loss_and_grad = make_loss_and_grad(cfg, q_chunk=q_chunk)

    def sgd(w, g):
        return (w.float() - client_lr * g.float()).to(w.dtype)

    def delta(row, final, start):
        torch.sub(final.float(), start.float(), out=row)

    def fl_round_step(params, client_batches, staleness):
        updates = flat_tree(params, lead=(staleness.shape[0],),
                            dtype=torch.float32)
        for m in range(staleness.shape[0]):
            p = params
            for s in range(local_steps):
                _, grads = loss_and_grad(
                    p, {k: v[m, s] for k, v in client_batches.items()})
                p = tree_map(sgd, p, grads)
            tree_map(delta, tree_map(lambda u: u[m], updates), p, params)
        return apply_aggregation(params, updates, staleness, alpha=alpha)

    return fl_round_step


def fl_round_shardings(cfg: ModelConfig, mesh=None, *, buffer_m: int = 16,
                       local_steps: int = 4, batch: int = 8,
                       seq: int = 512):
    """(args, None, None) of the FL round: (params, the clients' batches
    (M, local_steps, batch, seq) int32, staleness (M,) int32) on the meta
    device."""
    _no_mesh(mesh)
    size = (buffer_m, local_steps, batch, seq)
    cb = {k: torch.empty(size, dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    staleness = torch.empty((buffer_m,), dtype=torch.int32, device="meta")
    return (_meta_params(cfg), cb, staleness), None, None


# ---------------------------------------------------------------------------
# Dispatcher used by the dry run


def build(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
          num_micro: int = None, q_chunk: int = 512, moe_groups: int = 1):
    """Returns (fn, abstract_args, None, None): the step of `shape.kind`
    and its arguments on the meta device. `moe_groups` carries the
    reference's flags: -3 on an agg shape takes `make_agg_step_opt`; -1
    means one routing group per microbatch sequence (train) or per
    sequence (prefill); -2 (expert parallelism) raises, naming A.10."""
    _no_mesh(mesh, moe_groups)
    if shape.kind == "agg":
        fn = (make_agg_step_opt(cfg) if moe_groups == -3
              else make_agg_step(cfg))
        args, i, o = agg_shardings(cfg, buffer_m=shape.global_batch)
        return fn, args, i, o
    if shape.kind == "flround":
        fn = make_fl_round_step(cfg)
        args, i, o = fl_round_shardings(cfg, buffer_m=shape.global_batch,
                                        seq=shape.seq_len)
        return fn, args, i, o
    if shape.kind == "train":
        nm = num_micro if num_micro is not None else \
            default_num_micro(cfg, shape)
        if moe_groups == -1:   # one routing group per microbatch sequence
            moe_groups = max(1, shape.global_batch // nm)
        fn = make_train_step(cfg, num_micro=nm, q_chunk=q_chunk,
                             moe_groups=moe_groups)
        args, i, o = train_shardings(cfg, shape)
    elif shape.kind == "prefill":
        if moe_groups == -1:
            moe_groups = shape.global_batch
        fn = make_prefill_step(cfg, q_chunk=q_chunk, moe_groups=moe_groups)
        args, i, o = prefill_shardings(cfg, shape)
    else:
        fn = make_serve_step(cfg)
        args, i, o = decode_shardings(cfg, shape)
    return fn, args, i, o
