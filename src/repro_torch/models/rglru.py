"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]
(the port of `repro.models.rglru`).

Block: norm -> {x-branch: linear -> causal conv -> RG-LRU} * gelu(gate-branch)
-> out projection, with residual.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a h_in + b_a)            (recurrence gate)
    i_t = sigmoid(W_x h_in + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence takes a log-depth scan in float32 (`_scan`: the
reference's `jax.lax.associative_scan` combine, in Hillis-Steele
doubling); decode carries (h, conv tail). The norm runs in the RMSNorm
kernel; the conv, the gates and the scan are plain PyTorch, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import _softplus

_C = 8.0
_CONV_W = 4


class LRUState(NamedTuple):
    h: torch.Tensor       # (B, lru_width) float32
    conv: torch.Tensor    # (B, CONV_W-1, lru_width)


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_init(generator: torch.Generator, cfg: ModelConfig):
    """The reference's tree; `lam`, `b_a` and `b_i` float32 in any model
    dtype, `conv_w` drawn in float32, scaled by 0.2, then cast."""
    d, w = cfg.d_model, _width(cfg)
    dt = L.dtype_of(cfg)
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": L.rmsnorm_init(d, dt, dev),
        "w_x": L.dense_init(generator, d, w, dt),
        "w_gate": L.dense_init(generator, d, w, dt),
        "conv_w": L.normal(generator, (_CONV_W, w), 0.2, dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "w_a": L.dense_init(generator, w, w, dt),
        "b_a": torch.zeros((w,), **f32),
        "w_i": L.dense_init(generator, w, w, dt),
        "b_i": torch.zeros((w,), **f32),
        # Lambda init so that a ~ U(0.9, 0.999) at r = 0.5
        "lam": torch.linspace(0.7, 2.5, w, **f32),
        "out_proj": L.dense_init(generator, w, d, dt),
    }


def _gates(params, xc):
    """(a_t, u_t), float32: h = a h- + u."""
    r = torch.sigmoid((xc @ params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid((xc @ params["w_i"]).float() + params["b_i"])
    a = torch.exp(-_C * _softplus(params["lam"]) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * xc.float()


def _gate_branch(params, hin):
    """gelu (tanh approximation, `jax.nn.gelu`'s default) of the gate
    branch, float32."""
    return F.gelu((hin @ params["w_gate"]).float(), approximate="tanh")


def _scan(a, u):
    """h_t = a_t h_{t-1} + u_t over dim 1 from h_{-1} = 0, in ceil(log2 S)
    passes: after the pass at distance d each element holds the combine
    of the 2d elements ending at it, with the reference's combine
    (a1, u1), (a2, u2) -> (a1 a2, a2 u1 + u2). A product of a's that
    underflows to 0 is a decay past float32's range, which the sum does
    not see; no cumulative product is divided out."""
    S, d = a.shape[1], 1
    while d < S:
        u = torch.cat([u[:, :d], a[:, d:] * u[:, :-d] + u[:, d:]], dim=1)
        if 2 * d < S:           # the last pass needs no products
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return u


def rglru_apply(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D) with residual."""
    S = x.shape[1]
    hin = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xb = hin @ params["w_x"]
    gate = _gate_branch(params, hin)
    xp = F.pad(xb, (0, 0, _CONV_W - 1, 0))
    xc = sum(xp[:, i:i + S, :] * params["conv_w"][i] for i in range(_CONV_W))
    xc = xc + params["conv_b"]
    a, u = _gates(params, xc)                      # (B, S, W) float32
    y = (_scan(a, u) * gate).to(x.dtype)
    return x + y @ params["out_proj"]


def rglru_init_state(params, cfg: ModelConfig, batch: int, dtype,
                     device=None) -> LRUState:
    """Zeros; `params` is unused, as in the reference."""
    w = _width(cfg)
    return LRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                         device=device))


def rglru_decode(params, x, state: LRUState, cfg: ModelConfig):
    """x: (B, 1, D) -> (y, new_state)."""
    hin = L.rmsnorm(params["norm"], x, cfg.norm_eps)[:, 0]
    xb = hin @ params["w_x"]
    gate = _gate_branch(params, hin)
    window = torch.cat([state.conv, xb[:, None, :]], dim=1)
    xc = torch.einsum("bwc,wc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    a, u = _gates(params, xc)
    h_new = a * state.h + u
    y = (h_new * gate).to(x.dtype)
    out = x + (y @ params["out_proj"])[:, None, :]
    return out, LRUState(h=h_new, conv=window[:, 1:, :])


def rglru_reference(params, x, cfg: ModelConfig):
    """Step-by-step oracle for tests: `rglru_decode` over the sequence."""
    state = rglru_init_state(params, cfg, x.shape[0], x.dtype, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, state = rglru_decode(params, x[:, t:t + 1], state, cfg)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
