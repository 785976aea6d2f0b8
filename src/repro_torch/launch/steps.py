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

On a mesh (`launch/mesh.py`; `sharding.py`'s specs):
  * the `*_shardings` functions return `(args, in shardings, out
    shardings)`: the whole arguments on the meta device and trees of
    `sharding.NamedSharding` (the reference's specs and their DTensor
    placements); with `mesh=None`, `(args, None, None)`;
  * `make_train_step(cfg, mesh)` on a live mesh is data parallel over
    the data axes with ZeRO-1 and, where the model axis is above 1, tensor
    parallel over it (`_make_mesh_train_step`); `moe_groups=-2` takes
    expert parallelism (`moe.moe_apply_ep`) where the model axis is not
    tensor parallel;
  * `make_agg_step_opt(cfg, mesh)` runs the reference's collective
    schedule: each rank's rows of the buffer and model shards of the
    leaves, a local bf16 product, one bf16 all-reduce over the data axes;
  * on a `MeshShape` (no ranks) `build` returns the steps of one device,
    for the dry run's single execution on meta tensors, with the
    placements;
  * `make_prefill_step(cfg, mesh=)` and `make_serve_step(cfg, mesh=)`
    split the batch over the data axes where it divides and, on a model
    axis above 1, run the rank's part of the tensor-parallel program;
    `init_serve_state` makes the rank's decode state;
  * `make_agg_step` and the FL round take no mesh, as in the reference,
    where GSPMD partitions them by their shardings; on a live host mesh
    each rank runs them whole.
A model axis above 1 is GSPMD's tensor parallelism in the reference,
which has no code of its own for it: here `layers.TensorParallel` over
the rank's pieces of the params (`sharding.shard_params`), for the
decoder-only attention families, dense or MoE. The other families and the
FL round raise there, naming the ROADMAP item (`_refuse_model_axis`).
"""
from __future__ import annotations

import torch

import torch.distributed as dist

from repro_torch import sharding as Sh
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import mesh as Mesh
from repro_torch.core.aggregation import apply_aggregation
from repro_torch.core.staleness import staleness_compensation
from repro_torch.kernels.agg.ops import flat_tree
from repro_torch.launch import input_specs as IS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import (adamw_apply, adamw_apply_zero1, adamw_init,
                               clip_by_global_norm)
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

PART_4 = ("ROADMAP A.10 part 4 (the model axis of mamba2-370m, "
          "recurrentgemma-9b, whisper-base and phi-3-vision-4.2b)")
PART_5 = ("ROADMAP A.10 part 5 (the FL round and make_agg_step on a model "
          "axis above 1)")
PART_8 = ("ROADMAP A.10 part 8 (expert parallelism, moe_groups=-2, beside "
          "a tensor-parallel model axis)")


def _model_size(mesh) -> int:
    return Mesh.axis_sizes(mesh)["model"]


def _tensor_parallel(mesh) -> bool:
    return Mesh.is_live(mesh) and _model_size(mesh) > 1


def _refuse_model_axis(cfg: ModelConfig, mesh, what: str, kind: str):
    """On a live mesh whose model axis is above 1, the FL round and the
    families with no tensor-parallel partition (`layers.tp_unsupported`)
    raise, naming their ROADMAP item."""
    if not _tensor_parallel(mesh):
        return
    n = _model_size(mesh)
    if kind == "flround":
        raise NotImplementedError(
            f"{what} on a live mesh with a model axis of {n}: {PART_5}")
    other = L.tp_unsupported(cfg)
    if other:
        raise NotImplementedError(
            f"{what} of {cfg.name} on a live mesh with a model axis of {n}:"
            f" no tensor-parallel partition of its {', '.join(other)}; "
            f"{PART_4}")


def _tp(cfg: ModelConfig, mesh, what: str, kind: str):
    """The `layers.TensorParallel` of a live mesh whose model axis is
    above 1 (after `_refuse_model_axis`), else None."""
    _refuse_model_axis(cfg, mesh, what, kind)
    if not _tensor_parallel(mesh):
        return None
    return L.TensorParallel(cfg, mesh.get_group("model"))


def _row_shard(mesh, batch: int):
    """(index, count, group) of the rank's rows of a batch of `batch` over
    the data axes of a live mesh, or None without one or where the rows
    do not divide (every data rank then runs them all)."""
    if not Mesh.is_live(mesh):
        return None
    n = Sh.data_size(mesh)
    if batch % n:
        return None
    group = Mesh.axes_group(mesh, Sh.data_axes(mesh))
    return dist.get_rank(group), n, group


def _rows(batch: dict, shard):
    """The rank's rows of each tensor of `batch` (`_row_shard`)."""
    if shard is None:
        return batch
    index, count, _ = shard
    return {k: v.narrow(0, index * (v.shape[0] // count),
                        v.shape[0] // count) for k, v in batch.items()}


def default_num_micro(cfg: ModelConfig, shape: ShapeConfig,
                      mesh=None) -> int:
    """Pick a microbatch count so each data shard sees ~1 sequence per
    microbatch (bounds activation memory at long seq); no mesh is one
    data shard."""
    dp = 1 if mesh is None else Sh.data_size(mesh)
    m = max(1, shape.global_batch // dp)
    return min(m, 16)


# ---------------------------------------------------------------------------
# Train


def make_loss_and_grad(cfg: ModelConfig, *, num_micro: int = 1,
                       q_chunk: int = 512, aux_weight: float = 0.01,
                       moe_groups: int = 1, shard=None, moe_ep=None,
                       moe_group=None, tp=None):
    """loss_and_grad(params, batch) -> (loss, grads): the loss
    `lm_loss + aux_weight * aux` (remat on, as in the reference's step)
    and its gradient in the params' tree, both device tensors. With
    `num_micro` > 1 the batch is split into that many microbatches along
    its first dim; their gradients are added in order into float32 sums,
    and the sums and the loss are divided by `num_micro`, as the
    reference's scan does. With one, the gradients are in the params'
    dtypes.

    `shard=(index, count)`: this rank's rows of each microbatch, part
    `index` of `count` equal parts (microbatch first, then shard, as the
    reference's scan constrains each microbatch to the data axes); with
    microbatches the sums and the loss are divided by `num_micro * count`,
    the rank's share of the global mean, which a sum over the ranks
    completes. `moe_ep`, `moe_group` and `tp` (the rank's part of a
    tensor-parallel program, its params its pieces) reach
    `transformer.forward`; the gradients are then the rank's pieces."""
    def loss_fn(params, mb):
        logits, aux = T.forward(params, mb, cfg, q_chunk=q_chunk,
                                moe_groups=moe_groups, moe_ep=moe_ep,
                                moe_group=moe_group, tp=tp)
        return T.lm_loss(logits, mb["labels"], tp=tp) + aux_weight * aux

    def rows(mb):
        if shard is None:
            return mb
        index, count = shard
        out = {}
        for k, v in mb.items():
            if v.shape[0] % count:
                raise ValueError(
                    f"a microbatch of {v.shape[0]} rows does not split "
                    f"over {count} data shards")
            n = v.shape[0] // count
            out[k] = v.narrow(0, index * n, n)
        return out

    def loss_and_grad(params, batch):
        leaves, structure = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        tree = tree_unflatten(structure, live)
        if num_micro == 1:
            loss = loss_fn(tree, rows(batch))
            grads = torch.autograd.grad(loss, live)
            return loss.detach(), tree_unflatten(structure, list(grads))
        micro = {k: v.reshape(num_micro, v.shape[0] // num_micro,
                              *v.shape[1:]) for k, v in batch.items()}
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(num_micro):
            l_i = loss_fn(tree, rows({k: v[i] for k, v in micro.items()}))
            for acc, g in zip(sums, torch.autograd.grad(l_i, live)):
                acc.add_(g)
            loss = loss + l_i.detach()
        share = num_micro * (1 if shard is None else shard[1])
        for acc in sums:
            acc.div_(share)
        return loss / share, tree_unflatten(structure, sums)

    return loss_and_grad


def make_train_step(cfg: ModelConfig, mesh=None, *, num_micro: int = 1,
                    lr: float = 3e-4, q_chunk: int = 512,
                    aux_weight: float = 0.01, clip_norm: float = 1.0,
                    moe_groups: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradient of `make_loss_and_grad`,
    then `update`: the gradient clipped to `clip_norm` by its global norm,
    one AdamW step at `lr`. params and opt_state (`init_opt_state`) are
    written in place and returned; the metrics are device tensors, so a
    step reads nothing back. `q_chunk` is accepted and, as in prefill,
    changes nothing (`models/attention.py`). The step's two halves are its
    attributes `loss_and_grad(params, batch)` and `update(params,
    opt_state, grads) -> (opt_state, grad_norm)`, for a profiler that
    times them apart.

    `mesh`: None or a `MeshShape` gives the step of one device (on a
    `MeshShape`, `moe_groups=-2` routes the MoE tokens in one group a data
    shard, the expert-parallel program's groups); a live mesh gives the
    data- and tensor-parallel ZeRO-1 step (`_make_mesh_train_step`), whose
    params are the rank's pieces (`sharding.shard_params`)."""
    if Mesh.is_live(mesh):
        return _make_mesh_train_step(
            cfg, mesh, num_micro=num_micro, lr=lr, q_chunk=q_chunk,
            aux_weight=aux_weight, clip_norm=clip_norm,
            moe_groups=moe_groups)
    if moe_groups == -2:
        if mesh is None:
            raise ValueError("moe_groups=-2 is expert parallelism over a "
                             "mesh's model axis; give the step a mesh")
        moe_groups = Sh.data_size(mesh)
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


def zero1_dims(params, cfg: ModelConfig, mesh) -> list:
    """Per leaf (in `tree_leaves` order), the dim its AdamW moments are
    split on over the mesh's 'data' axis (`sharding.opt_spec_from_param`,
    ZeRO-1), or None where no dim divides."""
    pspecs = tree_leaves(Sh.param_specs(params, cfg, mesh),
                         is_leaf=Sh.is_spec)
    out = []
    for p, ps in zip(tree_leaves(params), pspecs):
        spec = Sh.opt_spec_from_param(ps, p.shape, mesh)
        out.append(spec.index("data") if "data" in spec else None)
    return out


def init_opt_state(params, cfg: ModelConfig, mesh=None):
    """The AdamW state the train step of `mesh` takes: `adamw_init`'s
    whole moments, or on a live mesh this rank's ZeRO-1 pieces of them
    (float32 zeros of each leaf's piece along its `zero1_dims` dim, the
    piece of the rank's index on the 'data' axis). `params` are the
    rank's (its model pieces on a model axis above 1); the dims are read
    from the whole leaves' specs."""
    if not Mesh.is_live(mesh):
        return adamw_init(params)
    n = Mesh.axis_sizes(mesh)["data"]
    leaves, structure = tree_flatten(params)
    state = {"step": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}

    def piece(p, d):
        shape = list(p.shape)
        if d is not None:
            shape[d] //= n
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    dims = zero1_dims(_meta_params(cfg), cfg, mesh)
    for key in ("m", "v"):
        state[key] = tree_unflatten(structure, [piece(p, d) for p, d in
                                                zip(leaves, dims)])
    return state


def _make_mesh_train_step(cfg: ModelConfig, mesh, *, num_micro, lr,
                          q_chunk, aux_weight, clip_norm, moe_groups):
    """The train step on a live mesh: data parallel over its data axes
    with ZeRO-1 and, where its model axis is above 1, tensor parallel over
    that (`layers.TensorParallel`; the params, the gradients and the
    moments are the rank's pieces):
      * every rank is given the whole batch and takes its rows of each
        microbatch (`make_loss_and_grad(shard=)`);
      * a MoE model's routing groups fall within a rank (`moe_groups`, the
        global count, must be a multiple of the data shards, so that
        capacity and drops are the global program's); the balance loss
        sums its statistics over the data axes (`moe.moe_apply`), or with
        `moe_groups=-2` it is expert parallel (`moe.moe_apply_ep`, the
        rank's tokens one routing group), at a model axis of 1 only
        (above 1 it raises, ROADMAP A.10 part 8);
      * each rank's float32 gradient sums and loss, its share of the
        global means, are summed over the data axes (one microbatch: the
        gradients go over in float32, are divided by the shards and come
        back in the params' dtypes), so the global-norm clip is the same
        on every rank;
      * on a model axis above 1 the global-norm clip sums the squares of
        the cut leaves' pieces over the model group and counts the whole
        leaves once (`optim.global_norm(sharded=)`);
      * AdamW runs on the rank's ZeRO-1 pieces of m and v
        (`init_opt_state`) and gathers the updated pieces back into the
        params' own storage (`optim.adamw_apply_zero1`).
    At a world of one every collective still runs, and the step gives the
    one-device step's bits; at a model axis of 1 it is the data-parallel
    step alone."""
    if moe_groups == -2 and cfg.num_experts and _tensor_parallel(mesh):
        raise NotImplementedError(
            f"the train step of {cfg.name} with moe_groups=-2 on a live "
            f"mesh with a model axis of {_model_size(mesh)}: {PART_8}")
    tp = _tp(cfg, mesh, "the train step", "train")
    dp_axes = Sh.data_axes(mesh)
    dp_group = Mesh.axes_group(mesh, dp_axes)
    n, r = dist.get_world_size(dp_group), dist.get_rank(dp_group)
    zero_group = mesh.get_group("data")
    moe_ep = moe_group = None
    groups = max(moe_groups, 1)
    if moe_groups == -2:
        moe_ep = (mesh, dp_axes)
    elif cfg.num_experts:
        if groups % n:
            raise ValueError(
                f"{groups} MoE routing groups do not fall within {n} data "
                f"shards: capacity and drops would differ from the global "
                f"program's (moe_groups=-1 gives one group a sequence)")
        groups, moe_group = groups // n, dp_group
    local = make_loss_and_grad(
        cfg, num_micro=num_micro, q_chunk=q_chunk, aux_weight=aux_weight,
        moe_groups=groups, shard=(r, n), moe_ep=moe_ep, moe_group=moe_group,
        tp=tp)
    meta = _meta_params(cfg)                             # shapes alone
    dims = zero1_dims(meta, cfg, mesh)
    clip = {}
    if tp is not None:
        clip = {"group": tp.group, "sharded": [
            Sh.model_sharded(spec) for spec in tree_leaves(
                Sh.param_specs(meta, cfg, mesh), is_leaf=Sh.is_spec)]}

    def loss_and_grad(params, batch):
        loss, grads = local(params, batch)
        leaves, structure = tree_flatten(grads)
        loss = Mesh.all_reduce_(loss.clone(), dp_group)
        if num_micro > 1:          # the ranks' shares of the means
            for g in leaves:
                Mesh.all_reduce_(g, dp_group)
            return loss, grads
        sums = [Mesh.all_reduce_(g.float(), dp_group).div_(n).to(g.dtype)
                for g in leaves]
        return loss / n, tree_unflatten(structure, sums)

    def update(params, opt_state, grads):
        grads, gnorm = clip_by_global_norm(grads, clip_norm, **clip)
        state = adamw_apply_zero1(
            grads, opt_state, params, lr, dims=dims,
            index=dist.get_rank(zero_group),
            count=dist.get_world_size(zero_group), group=zero_group)
        return state, gnorm

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grad(params, batch)
        opt_state, gnorm = update(params, opt_state, grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    train_step.loss_and_grad, train_step.update = loss_and_grad, update
    return train_step


# ---------------------------------------------------------------------------
# Prefill and decode


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 512,
                      moe_groups: int = 1, mesh=None):
    """prefill_step(params, batch) -> next-token logits (B, V).

    `mesh`: on a live mesh every rank is given the whole batch and takes
    its rows over the data axes where B divides them and, for a MoE
    model, its routing groups (`moe_groups` of the whole batch) fall
    within the rank; else it runs every row. On a model axis above 1 it
    runs its part of the tensor-parallel forward on its pieces of the
    params. It returns its piece of the logits, (rows, V / model) where
    the vocab divides, as `prefill_shardings`'s out spec lays them out
    where the rows split."""
    tp = _tp(cfg, mesh, "the prefill step", "prefill")

    def prefill_step(params, batch):
        with torch.inference_mode():
            shard = _row_shard(mesh, batch["tokens"].shape[0])
            groups = moe_groups
            if shard is not None and cfg.num_experts:
                if groups % shard[1]:
                    shard = None       # every rank routes the whole batch
                else:
                    groups //= shard[1]
            logits, _ = T.forward(params, _rows(batch, shard), cfg,
                                  q_chunk=q_chunk, moe_groups=groups, tp=tp)
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


def init_serve_state(params, cfg: ModelConfig, batch: int, seq_len: int,
                     mesh=None, *, enc_frames=None):
    """The decode state the serve step of `mesh` takes, on the params'
    device: `transformer.init_decode_state` of the whole batch, or on a
    live mesh of the rank's rows (`_row_shard`) and, on a model axis above
    1, of the kv heads its query heads read (ROADMAP C30). An
    encoder-decoder's `enc_frames` are the whole batch's; the rank
    encodes its rows of them."""
    tp = _tp(cfg, mesh, "the serve step", "decode")
    shard = _row_shard(mesh, batch)
    rows = batch if shard is None else batch // shard[1]
    if enc_frames is not None:
        enc_frames = _rows({"frames": enc_frames}, shard)["frames"]
    return T.init_decode_state(params, cfg, rows, seq_len, L.dtype_of(cfg),
                               enc_frames=enc_frames, tp=tp)


def make_serve_step(cfg: ModelConfig, mesh=None):
    """serve_step(params, state, token (B, 1)) -> (greedy next token
    (B, 1) int32, new state). `serve_step.logits_spec()` is the spec the
    reference constrains the logits to under `sharding.DECODE_OPT`
    (vocab-sharded, the argmax reducing over the sharded vocab dim), None
    without it; on one device or a host mesh the logits are whole.

    `mesh`: on a live mesh every rank is given the whole token and the
    state of `init_serve_state`; it steps its rows, on a model axis above
    1 its part of the tensor-parallel program, whose greedy pick reduces
    over the vocab pieces (`TensorParallel.argmax`, the lowest index on a
    tie). Every rank returns the whole (B, 1) token (the rows gathered
    over the data axes)."""
    tp = _tp(cfg, mesh, "the serve step", "decode")

    def serve_step(params, state, token):
        with torch.inference_mode():
            if not Mesh.is_live(mesh):
                logits, state = T.decode_step(params, token, state, cfg)
                next_token = torch.argmax(logits[:, -1, :], dim=-1)
                return next_token.to(torch.int32)[:, None], state
            shard = _row_shard(mesh, token.shape[0])
            logits, state = T.decode_step(
                params, _rows({"t": token}, shard)["t"], state, cfg, tp)
            last = logits[:, -1, :]
            pick = (torch.argmax(last, dim=-1) if tp is None
                    else tp.argmax(last)).to(torch.int32)
            if shard is not None:
                pick = Mesh.all_gather(pick, shard[2])
            return pick[:, None], state

    serve_step.logits_spec = lambda: ((None, None, "model")
                                      if Sh.DECODE_OPT else None)
    return serve_step


# ---------------------------------------------------------------------------
# Abstract arguments (meta tensors: shapes and dtypes, no memory) and, on a
# mesh, their shardings


def _meta(spec):
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _meta_params(cfg: ModelConfig):
    return T.init_params(0, cfg, device="meta")


def _named(mesh, *spec_trees):
    return tuple(Sh.to_named(t, mesh) for t in spec_trees)


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, in, out) of the train step: args (params, AdamW state,
    batch) on the meta device; on a mesh, in = the shardings of (params,
    opt state, batch) and out those of (params, opt state, metrics),
    else None, None."""
    params = _meta_params(cfg)
    opt = adamw_init(params)
    batch = {k: _meta(v) for k, v in IS.train_batch_specs(cfg, shape).items()}
    args = (params, opt, batch)
    if mesh is None:
        return args, None, None
    pspecs = Sh.param_specs(params, cfg, mesh)
    ospecs = Sh.opt_state_specs(opt, pspecs, cfg, mesh)
    bspecs = Sh.batch_specs(batch, mesh)
    metric_specs = {"loss": (), "grad_norm": ()}
    return (args, _named(mesh, pspecs, ospecs, bspecs),
            _named(mesh, pspecs, ospecs, metric_specs))


def prefill_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, in, out) of the prefill step: args (params, batch) on the
    meta device; on a mesh the shardings of (params, batch) and of the
    logits (B, V), else None, None."""
    params = _meta_params(cfg)
    batch = {k: _meta(v)
             for k, v in IS.prefill_batch_specs(cfg, shape).items()}
    args = (params, batch)
    if mesh is None:
        return args, None, None
    pspecs = Sh.param_specs(params, cfg, mesh)
    bspecs = Sh.batch_specs(batch, mesh)
    bspec = (Sh.data_axes(mesh)
             if shape.global_batch % Sh.data_size(mesh) == 0 else None)
    vspec = ("model" if cfg.vocab_size % _model_size(mesh) == 0
             else None)
    return (args, _named(mesh, pspecs, bspecs),
            Sh.to_named(Sh.spec_of(bspec, vspec), mesh))


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """(args, in, out) of the serve step: args (params, decode state,
    token) on the meta device, the state's `index` the host int 0; on a
    mesh the shardings of (params, state, token) and of (token, state),
    else None, None."""
    params = _meta_params(cfg)
    state = make_decode_state_shape(cfg, shape)
    token = _meta(IS.decode_token_spec(cfg, shape))
    args = (params, state, token)
    if mesh is None:
        return args, None, None
    pspecs = Sh.param_specs(params, cfg, mesh)
    sspecs = Sh.decode_state_specs(state, cfg, mesh, shape)
    tspecs = Sh.batch_specs({"token": token}, mesh)["token"]
    return (args, _named(mesh, pspecs, sspecs, tspecs),
            _named(mesh, tspecs, sspecs))


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
    """The reference's hand-scheduled eq. 4: per leaf, the staleness
    weights' product with the M updates in `reduce_dtype`
    (`torch.tensordot`, a plain product outside the kernel as in the
    reference, where it runs outside Pallas), then the float32 add to the
    params, cast to their dtype.

    On a live mesh (any (data, model) shape) each rank is given its
    pieces, as `agg_shardings` lays them out: each leaf's model shard
    (its `sharding.param_spec`), the buffer's rows of its index on the
    data axes (all of "pod" and "data") with the same model shard, and the
    whole staleness (M,). It takes its rows of the weights, the local
    product in `reduce_dtype`, one all-reduce of that product over the
    data axes in `reduce_dtype` (bf16 on the wire: the reference's
    collective bytes), then the float32 add; it returns its model shards
    of the new params. On one device, or a `MeshShape`, the product is
    over all M rows and nothing is reduced."""
    live = Mesh.is_live(mesh)
    if live:
        dp_axes = Sh.data_axes(mesh)
        group = Mesh.axes_group(mesh, dp_axes)
        sizes, coords = Mesh.axis_sizes(mesh), Sh.coordinate(mesh)

    def agg_step(params, update_stack, staleness):
        c = staleness_compensation(staleness, alpha)
        w = (c / c.sum().clamp(min=1e-12)).to(reduce_dtype)
        if live:
            start, length = Sh.shard_range(w.shape[0], dp_axes, sizes,
                                           coords)
            w = w.narrow(0, start, length)

        def one(p, u):
            if u.shape[0] != w.shape[0]:
                raise ValueError(f"{u.shape[0]} update rows for {w.shape[0]}"
                                 f" weights of this rank")
            delta = torch.tensordot(w, u.to(reduce_dtype), dims=1)
            if live:
                Mesh.all_reduce_(delta, group)
            return (p.float() + delta.float()).to(p.dtype)

        return tree_map(one, params, update_stack)

    return agg_step


def agg_shardings(cfg: ModelConfig, mesh=None, *, buffer_m: int = 96,
                  shard_buffer: bool = True):
    """(args, in, out) of the agg step: args (params, a buffer of
    `buffer_m` updates in the params' dtypes, staleness (M,) int32) on the
    meta device, the params and the updates laid out as views of one
    buffer a dtype (`flat_tree`), as the agg step reads them in place. On
    a mesh: the buffer's rows over 'data' where it divides them (and
    `shard_buffer`), each leaf's model dims as its param's; else None,
    None."""
    params = flat_tree(_meta_params(cfg))
    updates = flat_tree(params, lead=(buffer_m,))
    staleness = torch.empty((buffer_m,), dtype=torch.int32, device="meta")
    args = (params, updates, staleness)
    if mesh is None:
        return args, None, None
    pspecs = Sh.param_specs(params, cfg, mesh)
    mspec = ("data" if shard_buffer
             and buffer_m % Mesh.axis_sizes(mesh)["data"] == 0 else None)
    uspecs = Sh.map_specs(lambda ps: Sh.spec_of(mspec, *ps), pspecs)
    return (args, _named(mesh, pspecs, uspecs, ()),
            Sh.to_named(pspecs, mesh))


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
    """(args, in, out) of the FL round: args (params, the clients' batches
    (M, local_steps, batch, seq) int32, staleness (M,) int32) on the meta
    device; on a mesh the clients over 'data' where it divides M, else
    None, None."""
    size = (buffer_m, local_steps, batch, seq)
    cb = {k: torch.empty(size, dtype=torch.int32, device="meta")
          for k in ("tokens", "labels")}
    staleness = torch.empty((buffer_m,), dtype=torch.int32, device="meta")
    params = _meta_params(cfg)
    args = (params, cb, staleness)
    if mesh is None:
        return args, None, None
    pspecs = Sh.param_specs(params, cfg, mesh)
    mspec = ("data" if buffer_m % Mesh.axis_sizes(mesh)["data"] == 0
             else None)
    cbspecs = tree_map(lambda _: Sh.spec_of(mspec), cb)
    return (args, _named(mesh, pspecs, cbspecs, ()),
            Sh.to_named(pspecs, mesh))


# ---------------------------------------------------------------------------
# Dispatcher used by the dry run


def build(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
          num_micro: int = None, q_chunk: int = 512, moe_groups: int = 1):
    """Returns (fn, abstract_args, in shardings, out shardings): the step
    of `shape.kind` for `mesh` and its arguments on the meta device (the
    shardings None without a mesh). `moe_groups` carries the reference's
    flags: -3 on an agg shape takes `make_agg_step_opt`; -1 means one
    routing group per microbatch sequence (train) or per sequence
    (prefill); -2 is expert parallelism (`make_train_step`). On a live
    mesh the train, prefill and serve steps are the mesh's
    (`make_train_step`, `make_prefill_step(mesh=)`,
    `make_serve_step(mesh=)`); with a model axis above 1 the FL round and
    the families without a tensor-parallel partition raise
    (`_refuse_model_axis`)."""
    if shape.kind == "agg":
        fn = (make_agg_step_opt(cfg, mesh) if moe_groups == -3
              else make_agg_step(cfg))
        args, i, o = agg_shardings(cfg, mesh, buffer_m=shape.global_batch)
        return fn, args, i, o
    _refuse_model_axis(cfg, mesh, f"the {shape.kind} step", shape.kind)
    if shape.kind == "flround":
        fn = make_fl_round_step(cfg)
        args, i, o = fl_round_shardings(cfg, mesh,
                                        buffer_m=shape.global_batch,
                                        seq=shape.seq_len)
        return fn, args, i, o
    if shape.kind == "train":
        nm = num_micro if num_micro is not None else \
            default_num_micro(cfg, shape, mesh)
        if moe_groups == -1:   # one routing group per microbatch sequence
            moe_groups = max(1, shape.global_batch // nm)
        fn = make_train_step(cfg, mesh, num_micro=nm, q_chunk=q_chunk,
                             moe_groups=moe_groups)
        args, i, o = train_shardings(cfg, shape, mesh)
    elif shape.kind == "prefill":
        if moe_groups == -1:
            moe_groups = shape.global_batch
        fn = make_prefill_step(cfg, q_chunk=q_chunk,
                               moe_groups=max(moe_groups, 1),
                               mesh=mesh if Mesh.is_live(mesh) else None)
        args, i, o = prefill_shardings(cfg, shape, mesh)
    else:
        fn = make_serve_step(cfg, mesh if Mesh.is_live(mesh) else None)
        args, i, o = decode_shardings(cfg, shape, mesh)
    return fn, args, i, o
