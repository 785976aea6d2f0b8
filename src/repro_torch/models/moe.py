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
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def _route(xt, router, k: int):
    """xt (..., T, D) -> probs (..., T, E) float32, normalised gates and
    expert ids (..., T, k) in `jax.lax.top_k`'s order."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), expert_idx


def _experts(buf, params):
    """buf (E, R, D) -> the experts' SwiGLU outputs (E, R, D)."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    act = F.silu(g.float()).to(u.dtype) * u
    return torch.bmm(act, params["w_down"])


def moe_apply(params, x, cfg: ModelConfig, *, groups: int = 1):
    """x: (B, S, D) -> (x + MoE(x), aux loss). `groups` > 1 splits the
    tokens into that many independent routing groups, each with its own
    capacity (the reference's `_moe_apply_grouped`, its data-parallel
    dispatch); one group is the reference's `moe_apply`."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    assert T % groups == 0, (T, groups)
    G, Tg = groups, T // groups
    C = _capacity(cfg, Tg)
    dev = x.device

    h = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xg = h.reshape(G, Tg, D)
    probs, gate_vals, expert_idx = _route(xg, params["router"], k)

    # the Tg*k assignments of each group, sorted by expert (stable)
    flat_e = expert_idx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = order // k                                   # token of each
    counts = F.one_hot(flat_e, E).sum(dim=1)          # (G, E)
    offsets = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(Tg * k, device=dev) - torch.gather(offsets, 1, se)
    keep = rank < C

    # scatter the kept assignments into (G, E, C) rows of one buffer; the
    # dropped ones go to one spare row past the end
    gidx = torch.arange(G, device=dev)[:, None]
    rows = torch.where(keep, (gidx * E + se) * C + rank, G * E * C)
    buf = xg.new_zeros((G * E * C + 1, D))
    buf.index_copy_(0, rows.reshape(-1),
                    xg[gidx, st].reshape(G * Tg * k, D))
    y = _experts(buf[:-1].reshape(G, E, C, D).transpose(0, 1)
                 .reshape(E, G * C, D), params)
    y = y.reshape(E, G, C, D).transpose(0, 1).reshape(G * E * C, D)

    # combine: each assignment's gated output back in (token, slot)
    # order, then a token's k outputs added in ascending expert order
    w = torch.where(keep, torch.gather(
        gate_vals.reshape(G, Tg * k), 1, order), 0.0)
    rows_c = torch.where(keep, rows, 0)
    per_assign = y[rows_c] * w.to(y.dtype)[..., None]       # (G, Tg*k, D)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tg * k, device=dev).expand(G, -1))
    by_expert = torch.argsort(expert_idx, dim=-1)            # (G, Tg, k)
    slots = torch.gather(inv.reshape(G, Tg, k), 2, by_expert)
    parts = per_assign[gidx, slots.reshape(G, Tg * k)].reshape(G, Tg, k, D)
    out = parts[:, :, 0]
    for i in range(1, k):
        out = out + parts[:, :, i]

    frac_tokens = counts.sum(dim=0).float() / (T * k)
    frac_probs = probs.reshape(T, E).mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
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
