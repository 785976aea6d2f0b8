"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (the port of
`repro.models.ssm`).

Prefill uses the chunked SSD algorithm: a quadratic attention-like product
inside fixed-size chunks and a linear recurrence across the chunks'
states. Decode carries the (H, N, P) recurrent state and a causal-conv
tail. Both norms (`norm` over d_model, `out_norm` over the inner width)
run in the RMSNorm kernel.

Dims: B batch, S seq, D d_model, Di = expand·D inner, P = head_dim,
H = Di/P heads, N = ssm_state_dim. The B/C projections are shared across
heads (ngroups = 1, as in the 370M model).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class SSMState(NamedTuple):
    s: torch.Tensor       # (B, H, N, P) recurrent state
    conv: torch.Tensor    # (B, W-1, Di + 2N) conv tail


def _dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    h = di // p
    n = cfg.ssm_state_dim
    return di, p, h, n


def ssm_init(generator: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    di, p, h, n = _dims(cfg)
    dt = L.dtype_of(cfg)
    dev = generator.device
    conv_ch = di + 2 * n
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": L.rmsnorm_init(d, dt, dev),
        # order of proj outputs: [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": L.dense_init(generator, d, 2 * di + 2 * n + h, dt),
        "conv_w": L.normal(generator, (cfg.ssm_conv_width, conv_ch), 0.2, dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "A_log": torch.zeros((h,), **f32),           # A = -exp(A_log) = -1
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.full((h,), -2.0, **f32),    # softplus ≈ 0.12
        "out_norm": L.rmsnorm_init(di, dt, dev),
        "out_proj": L.dense_init(generator, di, d, dt),
    }


def _split_proj(cfg, proj):
    di, p, h, n = _dims(cfg)
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _softplus(x):
    """log(1 + e^x) with no threshold, as `jax.nn.softplus` (F.softplus
    returns x itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over the sequence axis. xbc: (B,S,C), w: (W,C)."""
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    S = xbc.shape[1]
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def _segsum_decay(dta):
    """dta: (..., Q, H) per-step log-decay. Returns L: (..., t, s, H) with
    L[t,s] = exp(sum_{s<τ<=t} dta_τ) for s<=t else 0."""
    cs = torch.cumsum(dta, dim=-2)                        # (..., Q, H)
    diff = cs[..., :, None, :] - cs[..., None, :, :]      # (..., t, s, H)
    Q = dta.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dta.device))
    diff = torch.where(mask[..., None], diff, float("-inf"))
    return torch.exp(diff)


def _gated_out(params, y, z, cfg, x):
    """out_norm(y * silu(z)) @ out_proj, added to the residual x."""
    g = y * F.silu(z.float()).to(y.dtype)
    return x + L.rmsnorm(params["out_norm"], g, cfg.norm_eps) \
        @ params["out_proj"]


def ssm_apply(params, x, cfg: ModelConfig):
    """Full-sequence SSD. x: (B, S, D) -> (B, S, D) with residual."""
    Bsz, S, D = x.shape
    di, p, h, n = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    while S % Q:          # largest divisor of S not exceeding ssm_chunk
        Q -= 1
    nc = S // Q

    hin = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    proj = hin @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"],
                              params["conv_b"]).float()).to(x.dtype)
    xs = xbc[..., :di].reshape(Bsz, S, h, p)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                      # (h,)
    dta = dt * A                                         # (B,S,h) log decay

    # chunk views
    xc = xs.reshape(Bsz, nc, Q, h, p)
    bc = Bm.reshape(Bsz, nc, Q, n)
    cc = Cm.reshape(Bsz, nc, Q, n)
    dtc = dt.reshape(Bsz, nc, Q, h)
    dtac = dta.reshape(Bsz, nc, Q, h)

    dtx = xc * dtc[..., None].to(xc.dtype)               # (B,nc,Q,h,p)

    # --- intra-chunk (diagonal blocks) ---
    Lm = _segsum_decay(dtac)                             # (B,nc,t,s,h)
    cb = torch.einsum("bctn,bcsn->bcts", cc.float(), bc.float())
    scores = (cb[..., None] * Lm).to(xc.dtype)           # (B,nc,t,s,h)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, dtx)

    # --- chunk states and inter-chunk recurrence ---
    cum = torch.cumsum(dtac, dim=2)                      # (B,nc,Q,h)
    total = cum[:, :, -1, :]                             # (B,nc,h)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,h)
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp",
                          decay_to_end.to(xc.dtype), bc.to(xc.dtype),
                          dtx)                           # (B,nc,h,n,p)

    s_prev = torch.zeros((Bsz, h, n, p), dtype=xc.dtype, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * torch.exp(total[:, c])[..., None, None].to(
            s_prev.dtype) + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                # (B,nc,h,n,p)

    y_inter = torch.einsum("bctn,bchnp->bcthp", cc.to(xc.dtype), s_prevs)
    y_inter = y_inter * torch.exp(cum)[..., None].to(xc.dtype)

    y = (y_intra + y_inter).reshape(Bsz, S, h, p)
    y = y + xs * params["D"].to(xs.dtype)[None, None, :, None]
    return _gated_out(params, y.reshape(Bsz, S, di), z, cfg, x)


# ---------------------------------------------------------------------------
# Decode


def ssm_init_state(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> SSMState:
    di, p, h, n = _dims(cfg)
    return SSMState(
        s=torch.zeros((batch, h, n, p), dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n),
                         dtype=dtype, device=device),
    )


def ssm_decode(params, x, state: SSMState, cfg: ModelConfig):
    """x: (B, 1, D) -> (y, new_state)."""
    Bsz = x.shape[0]
    di, p, h, n = _dims(cfg)
    hin = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    proj = (hin @ params["in_proj"])[:, 0]               # (B, ·)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    window = torch.cat([state.conv, xbc[:, None, :]], dim=1)  # (B,W,C)
    conv_out = (window * params["conv_w"]).sum(dim=1) + params["conv_b"]
    xbc_t = F.silu(conv_out.float()).to(x.dtype)
    xt = xbc_t[:, :di].reshape(Bsz, h, p)
    Bt = xbc_t[:, di:di + n]
    Ct = xbc_t[:, di + n:]
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                            # (B,h)
    upd = Bt[:, None, :, None] * (xt * dt[..., None].to(xt.dtype))[
        :, :, None, :]                                   # (B,h,n,p)
    s_new = state.s * decay[..., None, None].to(state.s.dtype) + upd
    y = torch.einsum("bn,bhnp->bhp", Ct, s_new) \
        + xt * params["D"].to(xt.dtype)[None, :, None]
    out = _gated_out(params, y.reshape(Bsz, 1, di), z[:, None, :], cfg, x)
    return out, SSMState(s=s_new, conv=window[:, 1:, :])


def ssm_reference(params, x, cfg: ModelConfig):
    """Sequential recurrence oracle for tests: `ssm_decode` over the
    sequence, one step at a time."""
    Bsz, S, D = x.shape
    state = ssm_init_state(cfg, Bsz, x.dtype, x.device)
    ys = []
    for t in range(S):
        y, state = ssm_decode(params, x[:, t:t + 1], state, cfg)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
