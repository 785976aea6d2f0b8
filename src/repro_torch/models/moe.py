"""Mixture-of-Experts FFN with sort-based capacity dispatch (the port of
`repro.models.moe`).

Routing is data movement (a stable sort, a scatter and a gather) and the
expert computation is a batched product over an (E, C, D) buffer, so the
products cost only the active experts' work. Token overflow beyond the
per-expert capacity C = ceil8(k·T/E · cf) is dropped (capacity-factor
semantics); with no drop the block equals the dense oracle
`moe_apply_dense`.

Order, so that the card repeats the CPU's routing:
  - top-k is a stable descending sort: values in descending order, ties
    to the lower expert index, as `jax.lax.top_k`;
  - the assignments are sorted by expert with a stable argsort, as
    `jnp.argsort`, so rank-in-expert (who is dropped) is the reference's;
  - the combine adds a token's k expert outputs one after another in
    ascending expert order (the reference's scatter-add order over its
    sorted assignments) instead of `index_add_`, whose atomics add in
    any order on the card.
The dispatch writes each kept assignment to its own row of the buffer
(`index_copy_` into distinct rows, dropped ones into one spare row that
is cut off), so it reads nothing back to the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as Mesh
from repro_torch.models import layers as L


def moe_init(generator: torch.Generator, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = L.dtype_of(cfg)
    return {
        "norm": L.rmsnorm_init(d, dt, generator.device),
        "router": L.normal(generator, (d, e), d ** -0.5, dt),
        "w_gate": L.normal(generator, (e, d, f), d ** -0.5, dt),
        "w_up": L.normal(generator, (e, d, f), d ** -0.5, dt),
        "w_down": L.normal(generator, (e, f, d), f ** -0.5, dt),
    }


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.experts_per_token * num_tokens / cfg.num_experts
            * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _top_k(probs, k: int):
    """probs (..., T, E) -> (probs, normalised gates, expert ids (..., T,
    k)) in `jax.lax.top_k`'s order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def _route(xt, router, k: int):
    """xt (..., T, D) -> probs (..., T, E) float32, normalised gates and
    expert ids (..., T, k) in `jax.lax.top_k`'s order."""
    return _top_k(torch.softmax((xt @ router).float(), dim=-1), k)


def _experts(buf, params):
    """buf (E, R, D) -> the experts' SwiGLU outputs (E, R, D)."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    act = F.silu(g.float()).to(u.dtype) * u
    return torch.bmm(act, params["w_down"])


def _dispatch_combine(xg, gate_vals, expert_idx, experts, E: int, C: int,
                      lo: int = 0, El: int = None):
    """The experts [lo, lo + El) (all of them where El is None) of each
    group's routed tokens: xg (G, Tg, D), gates and expert ids (G, Tg, k),
    `experts` a tree holding their "w_gate", "w_up" and "w_down" (El
    stacked). Each group has capacity C an expert; returns the gated outputs (G, Tg, D), a token's
    k slots added in ascending expert order (0 for an expert outside the
    window or a dropped assignment), and the tokens an expert (G, E)."""
    G, Tg, D = xg.shape
    k = expert_idx.shape[-1]
    El = E if El is None else El
    dev = xg.device

    # the Tg*k assignments of each group, sorted by expert (stable)
    flat_e = expert_idx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = order // k                                   # token of each
    counts = F.one_hot(flat_e, E).sum(dim=1)          # (G, E)
    offsets = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(Tg * k, device=dev) - torch.gather(offsets, 1, se)
    le = se - lo                                      # expert in window
    mine = (rank < C) & (le >= 0) & (le < El)

    # scatter the kept assignments into (G, El, C) rows of one buffer;
    # the dropped ones go to one spare row past the end
    gidx = torch.arange(G, device=dev)[:, None]
    rows = torch.where(mine, (gidx * El + le) * C + rank, G * El * C)
    buf = xg.new_zeros((G * El * C + 1, D))
    buf.index_copy_(0, rows.reshape(-1),
                    xg[gidx, st].reshape(G * Tg * k, D))
    y = _experts(buf[:-1].reshape(G, El, C, D).transpose(0, 1)
                 .reshape(El, G * C, D), experts)
    y = y.reshape(El, G, C, D).transpose(0, 1).reshape(G * El * C, D)

    # combine: each assignment's gated output back in (token, slot)
    # order, then a token's k outputs added in ascending expert order
    w = torch.where(mine, torch.gather(
        gate_vals.reshape(G, Tg * k), 1, order), 0.0)
    rows_c = torch.where(mine, rows, 0)
    per_assign = y[rows_c] * w.to(y.dtype)[..., None]       # (G, Tg*k, D)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tg * k, device=dev).expand(G, -1))
    by_expert = torch.argsort(expert_idx, dim=-1)            # (G, Tg, k)
    slots = torch.gather(inv.reshape(G, Tg, k), 2, by_expert)
    parts = per_assign[gidx, slots.reshape(G, Tg * k)].reshape(G, Tg, k, D)
    out = parts[:, :, 0]
    for i in range(1, k):
        out = out + parts[:, :, i]
    return out, counts


def _balance_loss(cfg: ModelConfig, counts, prob_sums, T: int):
    """Switch's load-balancing loss E·Σ_e frac_tokens·frac_probs from the
    tokens an expert (E,) and the probabilities' sums (E,) over T
    tokens."""
    frac_tokens = counts.float() / (T * cfg.experts_per_token)
    frac_probs = prob_sums / T
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)


def _dispatch_over_model(xg, probs, params, cfg: ModelConfig, C: int,
                         model_group):
    """The expert layer over `model_group`, whose every rank holds the
    same tokens xg (G, Tg, D) and their probabilities (G, Tg, E): each
    routes them all and runs the experts it holds, its E/n where the spec
    cut the expert dim, all E (their d_ff pieces, or whole) where it did
    not. The tokens and the probabilities the gates come from go through
    `grad_psum` (every rank uses them for its part of the output), the
    partial outputs through `psum_partial`. Returns the outputs (G, Tg, D)
    and the tokens an expert (G, E)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    El = params["w_gate"].shape[0]
    lo = 0 if El == E else dist.get_rank(model_group) * El
    _, gate_vals, expert_idx = _top_k(Mesh.grad_psum(probs, model_group), k)
    out, counts = _dispatch_combine(
        Mesh.grad_psum(xg, model_group), gate_vals, expert_idx, params, E, C,
        lo=lo, El=El)
    return Mesh.psum_partial(out, model_group), counts


def moe_apply(params, x, cfg: ModelConfig, *, groups: int = 1,
              data_group=None, model_group=None):
    """x: (B, S, D) -> (x + MoE(x), aux loss). `groups` > 1 splits the
    tokens into that many independent routing groups, each with its own
    capacity (the reference's `_moe_apply_grouped`, its data-parallel
    dispatch); one group is the reference's `moe_apply`.

    `data_group`: x is this rank's share of a data-parallel batch (its
    routing groups whole). The balance loss is the reference's over every
    rank's tokens: the tokens an expert and the probabilities' sums are
    summed over the group (`core.mesh.psum`, `psum_shared`) before their
    product, so every rank has the global program's aux.

    `model_group`: tensor parallelism (`layers.TensorParallel`). Every
    rank of the group holds the same tokens and the whole router
    (gathered) and runs its experts (`_dispatch_over_model`, as
    `moe_apply_ep` does). Experts the spec leaves whole run whole, with
    no collective."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    assert T % groups == 0, (T, groups)
    G, Tg = groups, T // groups
    C = _capacity(cfg, Tg)
    if model_group is not None and params["w_gate"].shape[0] == E and \
            params["w_gate"].shape[-1] == cfg.d_ff:
        model_group = None                   # whole experts on every rank

    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xg = h.reshape(G, Tg, D)
    probs, gate_vals, expert_idx = _route(xg, params["router"], k)
    if model_group is None:
        out, counts = _dispatch_combine(xg, gate_vals, expert_idx, params,
                                        E, C)
    else:
        out, counts = _dispatch_over_model(xg, probs, params, cfg, C,
                                           model_group)

    counts, prob_sums = counts.sum(dim=0), probs.reshape(T, E).sum(dim=0)
    if data_group is not None:
        counts = Mesh.psum(counts, data_group)
        prob_sums = Mesh.psum_shared(prob_sums, data_group)
        T = T * dist.get_world_size(data_group)
    return x + out.reshape(B, S, D), _balance_loss(cfg, counts, prob_sums,
                                                   T)


def moe_apply_ep(params, x, cfg: ModelConfig, mesh, *,
                 data_axes=("data",), model_axis: str = "model"):
    """Expert parallelism over the live `mesh` (the reference's
    `shard_map` schedule, written with the collectives of
    `repro_torch.core.mesh`):

      * x (B_l, S, D) is this rank's tokens: sharded over the data axes,
        replicated over `model_axis`; they form one routing group;
      * params hold the norm and the router whole and this rank's
        E / n_model experts (w_* sliced on the expert dim, as
        `sharding.param_spec` shards them); the rank takes the experts
        [m·El, (m+1)·El) for its model index m;
      * dispatch, the grouped products and the partial combine are local
        to the rank's experts, then one sum over the model group
        (`_dispatch_over_model`: `psum_partial` on the outputs, whose
        gradient passes to every rank's partial unchanged, and
        `grad_psum` on the tokens and the probabilities that every model
        rank uses alike); the balance loss reads the probabilities
        directly and counts once;
      * aux is the mean over the data axes of each shard's aux
        (`psum_shared` / n_data), the reference's definition, not the
        global aux.

    With these, a rank's gradients summed over the data axes are the dense
    program's (never n_model times them). Requires num_experts % n_model
    == 0 (qwen3-moe; mixtral falls back to the grouped path in
    `transformer._ffn_apply`)."""
    from repro_torch.core.mesh import axes_group
    model_group = mesh.get_group(model_axis)
    data_group = axes_group(mesh, data_axes)
    n_model = dist.get_world_size(model_group)
    n_data = dist.get_world_size(data_group)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    assert E % n_model == 0, (E, n_model)
    El = E // n_model
    if params["w_gate"].shape[0] != El:
        raise ValueError(f"moe_apply_ep takes the rank's {El} experts, "
                         f"not {params['w_gate'].shape[0]}")
    Tg = B * S
    C = _capacity(cfg, Tg)

    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xt = h.reshape(1, Tg, D)
    probs, _, _ = _route(xt, params["router"], k)
    out, counts = _dispatch_over_model(xt, probs, params, cfg, C,
                                       model_group)
    aux = _balance_loss(cfg, counts.sum(dim=0),
                        probs.reshape(Tg, E).sum(dim=0), Tg)
    aux = Mesh.psum_shared(aux, data_group) / n_data
    return x + out.reshape(B, S, D), aux


def moe_apply_dense(params, x, cfg: ModelConfig):
    """Dense (all-experts) oracle for tests: every expert for every token,
    combined with the same top-k gates. O(T·E) work: tiny shapes only."""
    B, S, D = x.shape
    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xt = h.reshape(B * S, D)
    probs, gate_vals, expert_idx = _route(xt, params["router"],
                                          cfg.experts_per_token)
    gates = torch.zeros_like(probs).scatter_(1, expert_idx, gate_vals)
    E = cfg.num_experts
    y = _experts(xt.expand(E, -1, -1), params)               # (E, T, D)
    out = torch.einsum("etd,te->td", y, gates.to(y.dtype))
    return x + out.reshape(B, S, D)
