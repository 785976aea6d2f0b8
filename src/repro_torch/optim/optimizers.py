"""Functional optimizers on trees of tensors (the port of
`repro.optim.optimizers`): SGD with momentum, and AdamW with clipping by
the global norm.

The same names and the reference's order of operations: moments in
float32, AdamW's bias corrections from the step count, updates
`-lr·((m/c1)/(sqrt(v/c2)+eps) + wd·p)` and `(p.float() + u).to(p.dtype)`.
`sgd_update`, `adamw_update` and `apply_updates` are functional, as the
reference's. The train step's two work in place (ROADMAP C20):
`clip_by_global_norm` scales the grads it is given, and `adamw_apply`
(`adamw_update` then `apply_updates`, a leaf at a time) advances the
state's `step`, `m` and `v` and writes the params. A model of 2.8 B
parameters has 22.3 GB of float32 moments, which the card holds once,
not twice. The step stays a device tensor, so an update reads nothing
back to the host.

`adamw_apply_zero1` is the data-parallel step's AdamW under ZeRO-1: each
rank holds m and v only for its piece of a leaf, updates that piece of
the param and gathers the group's pieces back into the param's own
storage."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def global_norm(tree, *, sharded=None, group=None):
    """sqrt of the sum of every leaf's squares, in float32.

    `sharded` (one bool a leaf, in `tree_leaves` order) with `group`: the
    leaves marked are a rank's pieces of leaves cut over the group (a
    tensor-parallel step's), whose squares are summed over it; the others
    are whole and alike on every rank, and count once."""
    if sharded is None:
        total = 0
        for x in tree_leaves(tree):
            total = total + torch.sum(torch.square(x.float()))
        return torch.sqrt(total)
    from repro_torch.core.mesh import all_reduce_
    leaves = tree_leaves(tree)
    own = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    whole = torch.zeros_like(own)
    for x, cut in zip(leaves, sharded):
        sq = torch.sum(torch.square(x.float()))
        if cut:
            own = own + sq
        else:
            whole = whole + sq
    return torch.sqrt(all_reduce_(own, group) + whole)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, *, sharded=None, group=None):
    """Scale every leaf by min(1, max_norm / norm), in place (in float32,
    then back to the leaf's dtype). Returns (grads, norm). `sharded` and
    `group` as `global_norm`'s."""
    norm = global_norm(grads, sharded=sharded, group=group)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, norm


# ---------------------------------------------------------------------------
# SGD (the paper's satellite-side local optimizer, eq. 3)


def sgd_init(params, momentum: float = 0.0):
    device = tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if momentum != 0.0:
        state["mu"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


@torch.no_grad()
def sgd_update(grads, state, params, lr, momentum: float = 0.0,
               weight_decay: float = 0.0, trainable_mask=None):
    """-> (updates, new state), as the reference: neither argument is
    written."""
    if trainable_mask is not None:
        grads = tree_map(lambda g, m: g * m, grads, trainable_mask)
    if momentum == 0.0:
        updates = tree_map(lambda g: -lr * g.float(), grads)
        new_state = {"step": state["step"] + 1}
    else:
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        updates = tree_map(lambda m: -lr * m, mu)
        new_state = {"step": state["step"] + 1, "mu": mu}
    if weight_decay:
        updates = tree_map(lambda u, p: u - lr * weight_decay * p.float(),
                           updates, params)
    return updates, new_state


# ---------------------------------------------------------------------------
# AdamW (datacenter-side training)


def adamw_init(params):
    """{"step": 0 (int32), "m", "v": float32 zeros like the params}, on the
    params' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def _corrections(step, b1, b2):
    """The bias corrections (c1, c2) of step `step`, float32 device
    tensors."""
    t = step.float()
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def _adamw_leaf(g, m, v, p, c1, c2, lr, b1, b2, eps, weight_decay):
    """One leaf: m and v advanced in place; returns its float32 update."""
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
    return u.add_(weight_decay * p.float()).mul_(-lr)


@torch.no_grad()
def adamw_update(grads, state, params, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """-> (updates, new state), as the reference: neither argument is
    written."""
    step = state["step"] + 1
    c1, c2 = _corrections(step, b1, b2)
    m, v = tree_map(torch.clone, state["m"]), tree_map(torch.clone,
                                                       state["v"])
    g_leaves, structure = tree_flatten(grads)
    updates = [_adamw_leaf(g, mi, vi, p, c1, c2, lr, b1, b2, eps,
                           weight_decay)
               for g, mi, vi, p in zip(g_leaves, tree_leaves(m),
                                       tree_leaves(v), tree_leaves(params))]
    return tree_unflatten(structure, updates), {"step": step, "m": m,
                                                "v": v}


@torch.no_grad()
def apply_updates(params, updates):
    """-> new params (p.float() + u).to(p.dtype)."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


@torch.no_grad()
def adamw_apply(grads, state, params, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1):
    """`adamw_update` then `apply_updates` in place, a leaf at a time, so
    that one leaf's update is held at once. Returns the state."""
    state["step"].add_(1)
    c1, c2 = _corrections(state["step"], b1, b2)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        u = _adamw_leaf(g, m, v, p, c1, c2, lr, b1, b2, eps, weight_decay)
        p.copy_(u.add_(p.float()))
    return state


def _gather_into(p, piece, dim: int, count: int, group):
    """Every rank's `piece` of `p` along `dim` (rank k's the k-th of
    `count`) written into `p`: straight into its storage where the pieces
    are slabs of dim 0, else a leaf at a time through one list of the
    pieces."""
    from repro_torch.core.mesh import collective_counts
    collective_counts["gather_params"] += 1
    if dim == 0 and p.is_contiguous():
        # torch 2.13 renamed all_gather_into_tensor to all_gather_single
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(p, piece.contiguous(), group=group)
        return
    parts = [torch.empty_like(piece) for _ in range(count)]
    dist.all_gather(parts, piece.contiguous(), group=group)
    n = piece.shape[dim]
    for k, part in enumerate(parts):
        p.narrow(dim, k * n, n).copy_(part)


@torch.no_grad()
def adamw_apply_zero1(grads, state, params, lr, *, dims, index: int,
                      count: int, group, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1):
    """`adamw_apply` under ZeRO-1 over `group` (`count` ranks, this one
    `index`): a leaf whose `dims` entry is d has in the state m and v of
    its piece `index` of `count` along d alone; the rank updates that
    piece of the param from the same piece of the (whole, already
    summed) gradient, then the pieces are gathered back into the param
    (`_gather_into`). A leaf whose entry is None has whole moments and is
    updated whole on every rank, as `adamw_apply` does. Returns the
    state."""
    state["step"].add_(1)
    c1, c2 = _corrections(state["step"], b1, b2)
    for g, m, v, p, d in zip(tree_leaves(grads), tree_leaves(state["m"]),
                             tree_leaves(state["v"]), tree_leaves(params),
                             dims):
        if d is None:
            u = _adamw_leaf(g, m, v, p, c1, c2, lr, b1, b2, eps,
                            weight_decay)
            p.copy_(u.add_(p.float()))
            continue
        n = p.shape[d] // count
        gs, ps = g.narrow(d, index * n, n), p.narrow(d, index * n, n)
        if m.shape != gs.shape:
            raise ValueError(f"moments of shape {tuple(m.shape)} for the "
                             f"piece {tuple(gs.shape)} of a leaf: ZeRO-1 "
                             f"takes each rank's pieces "
                             f"(launch.steps.init_opt_state)")
        u = _adamw_leaf(gs, m, v, ps, c1, c2, lr, b1, b2, eps, weight_decay)
        _gather_into(p, u.add_(ps.float()).to(p.dtype), d, count, group)
    return state
