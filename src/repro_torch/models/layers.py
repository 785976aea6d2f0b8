"""Shared layers: RMSNorm, RoPE, MLPs, embeddings and initialisers (the
port of `repro.models.layers`).

Layers are plain functions over parameter trees (dicts of tensors); init
functions return one layer's tree, drawn from a `torch.Generator` on the
generator's device (a CUDA generator draws on the card, a CPU one on the
host). Dense layers go through `linear`, which also takes a leading
satellite axis on the weights: the batched client update trains a stack
of satellites as one batched product. Every RMSNorm goes through the
kernel (`repro_torch.kernels.rmsnorm.ops`).

`TensorParallel` is the partition of a decoder-only attention model over
a mesh's 'model' axis (the port of what GSPMD does to the reference's
jitted steps, by `repro.sharding`'s specs, written as Megatron's
explicit collectives of `repro_torch.core.mesh`). Each rank holds its
pieces of the params (`repro_torch.sharding.shard_params`), and a
layer's partition follows the shapes of the pieces it is given, so the
spec of each leaf decides it: a column leaf cut over 'model' computes
the rank's output columns from the input behind `grad_psum` (Megatron's
f), a row leaf's partial product goes through `psum_partial` (g), and a
leaf the spec leaves whole computes whole with no collective.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.core import mesh as Mesh
from repro_torch.kernels.rmsnorm import ops as rms_ops


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class MetaGenerator:
    """Stands in for a `torch.Generator` on the meta device, which has
    none: the init functions given it return the tree's shapes and dtypes
    on the meta device, with no numbers and no memory."""
    device = torch.device("meta")


def normal(generator: torch.Generator, shape, scale: float, dtype):
    """N(0, scale^2) of `shape` in `dtype`, drawn in float32 on the
    generator's device."""
    meta = generator.device.type == "meta"
    w = torch.randn(shape, generator=None if meta else generator,
                    dtype=torch.float32, device=generator.device)
    return w.mul_(scale).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype, scale: float = None):
    scale = scale if scale is not None else in_dim ** -0.5
    return normal(generator, (in_dim, out_dim), scale, dtype)


def linear(x, w):
    """x @ w, where w may carry leading batch axes (*lead, d_in, d_out)
    that x (*lead, ..., d_in) shares: the middle axes of x are folded into
    one so that the product is a single batched matmul."""
    lead = w.dim() - 2
    if lead == 0:
        return x @ w
    y = x.reshape(*x.shape[:lead], -1, x.shape[-1]) @ w
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# RMSNorm


def rmsnorm_init(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm over the last dim through the kernel (its plain version on
    the CPU). The kernel applies the scale in float32 before it casts; the
    reference casts first: the same in float32, one rounding apart in
    bfloat16 (ROADMAP C4)."""
    return rms_ops.rmsnorm(x, params["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device=None):
    """(head_dim//2,) inverse frequencies, computed once per head dim,
    theta and device and kept (made outside inference mode, so training
    can use them too)."""
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        return 1.0 / (theta ** exps)


def rope_tables(positions, head_dim: int, theta: float, device):
    """(sin, cos) of positions (broadcastable to (..., S)), each
    (..., S, 1, head_dim//2) float32: computed once for q and k."""
    inv = rope_frequencies(head_dim, theta, device)
    ang = positions[..., :, None, None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def rotate(x, sin, cos):
    """x: (..., S, H, hd) rotated by `rope_tables`' angles, in float32 as
    the reference does, then cast back."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)


def mlp_init(generator: torch.Generator, cfg: ModelConfig, d_ff: int = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": dense_init(generator, d, f, dt),
            "w_up": dense_init(generator, d, f, dt),
            "w_down": dense_init(generator, f, d, dt),
        }
    return {
        "w_up": dense_init(generator, d, f, dt),
        "w_down": dense_init(generator, f, d, dt),
    }


def mlp_apply(params, x, act: str):
    """SwiGLU or GELU MLP, the activation taken in float32."""
    if act == "swiglu":
        g = linear(x, params["w_gate"])
        u = linear(x, params["w_up"])
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, params["w_up"]).float(),
                   approximate="tanh").to(x.dtype)
    return linear(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head


def embedding_init(generator: torch.Generator, cfg: ModelConfig):
    dt = dtype_of(cfg)
    p = {"embed": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt)
    return p


def embed(params, tokens, cfg: ModelConfig, tp=None):
    """Rows of the table. `F.embedding`, not `table[tokens]`: its gradient
    adds a row's contributions in a fixed order on the CPU and on the
    card, where indexing's (an accumulating `index_put_`) adds them in
    whatever order the CPU's threads take (ROADMAP C21). Under `tp` the
    table may be the rank's rows (`TensorParallel.embed`)."""
    if tp is not None:
        return tp.embed(params["embed"], tokens)
    return F.embedding(tokens, params["embed"])


def unembed(params, x, cfg: ModelConfig, tp=None):
    """The logits; under `tp`, the rank's vocab columns where the table
    is cut over the vocab."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if tp is not None and w.shape[-1] != cfg.vocab_size:
        return tp.enter(x) @ w
    return x @ w


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis


def tp_unsupported(cfg: ModelConfig) -> list:
    """What of `cfg` has no tensor-parallel partition: its block kinds
    other than global and local attention, and a vision frontend."""
    out = sorted(set(cfg.layer_kinds) - {GLOBAL_ATTN, LOCAL_ATTN})
    if cfg.is_encoder_decoder:
        out.append("encoder")
    if cfg.frontend == "vision":
        out.append("vision frontend")
    return out


class TensorParallel:
    """The partition of a decoder-only attention model (dense or MoE) over
    the model axis's process group `group` of n ranks, rank r:

      * query heads: the rank's H/n, a contiguous range (H % n must be 0,
        else it raises, naming the arch: GSPMD would reshard there,
        ROADMAP C29); its kv heads are those its query heads read,
        [`kv_lo`, `kv_lo + kv_heads`): its own where K % n == 0, else
        the columns of other ranks' `wk`/`wv` pieces gathered
        (Megatron's kv replication, `kv_columns`), so GQA's grouping is
        kept in the kernel's call;
      * `enter` (`grad_psum`) before a column leaf, and on a whole leaf
        that each rank applies to its part only (q- and k-norm, the kv
        columns a rank slices), so its gradient is summed to the whole;
        `leave` (`psum_partial`) after a row leaf;
      * the embedding's and the LM head's vocab rows/columns, the
        vocab-parallel loss (`nll`) and greedy pick (`argmax`);
      * the MoE router gathered whole (`whole`) and the experts of the
        rank (`repro_torch.models.moe`).
    Every gradient of a leaf the rank holds is then its piece of the
    global program's: the whole leaves' alike on every rank, the cut
    leaves' the rank's piece. The families with other blocks
    (`tp_unsupported`) are refused before one is made
    (`repro_torch.launch.steps`)."""

    def __init__(self, cfg: ModelConfig, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        H, K = cfg.num_heads, cfg.num_kv_heads
        if H % n:
            raise ValueError(
                f"{cfg.name}: {H} query heads do not split over a model "
                f"axis of {n} (GSPMD would reshard the heads; ROADMAP C29)")
        self.cfg, self.group, self.size, self.rank = cfg, group, n, r
        self.heads = H // n
        G, lo = H // K, r * self.heads
        self.kv_lo = lo // G
        self.kv_heads = (lo + self.heads - 1) // G - self.kv_lo + 1
        per = self.heads // self.kv_heads
        if self.heads % self.kv_heads or any(
                (lo + j) // G - self.kv_lo != j // per
                for j in range(self.heads)):
            raise ValueError(
                f"{cfg.name}: the {self.heads} query heads of model rank "
                f"{r} of {n} read their {K} kv heads unevenly")

    def enter(self, x):
        """Megatron's f: x itself; its gradient summed over the group (the
        ranks' partial cotangents of a column leaf's input, or of a whole
        leaf each applies to its part)."""
        return Mesh.grad_psum(x, self.group)

    def leave(self, y):
        """Megatron's g: the sum over the group of the ranks' partial
        y."""
        return Mesh.psum_partial(y, self.group)

    def whole(self, w, dim: int, size: int):
        """`w` whole along `dim` (of `size`): the ranks' pieces gathered
        where the spec cut it, else `w`."""
        if w.shape[dim] == size:
            return w
        return Mesh.gather_shards(w, dim, self.group)

    def kv_columns(self, w):
        """The columns of `wk` or `wv` (d, K·hd, or the rank's piece) for
        the rank's kv heads."""
        hd, K = self.cfg.resolved_head_dim, self.cfg.num_kv_heads
        lo, n = self.kv_lo * hd, self.kv_heads * hd
        if w.shape[-1] == K * hd:                 # whole: slice it
            return self.enter(w).narrow(-1, lo, n)
        if K % self.size == 0:                    # the rank's own heads
            return w
        return self.enter(Mesh.gather_shards(w, -1, self.group)).narrow(
            -1, lo, n)

    def mlp(self, params, x, act: str):
        """The dense MLP: d_ff cut over the group (f, the rank's columns,
        its rows of w_down, g), or whole."""
        if params["w_up"].shape[-1] == self.cfg.d_ff:
            return mlp_apply(params, x, act)
        return self.leave(mlp_apply(params, self.enter(x), act))

    def embed(self, table, tokens):
        """The embedding from the rank's rows of the table: the ids in its
        range looked up (`F.embedding`, C21), zeros elsewhere, summed over
        the group."""
        Vl = table.shape[0]
        if Vl == self.cfg.vocab_size:
            return F.embedding(tokens, table)
        local = tokens - self.rank * Vl
        inside = (local >= 0) & (local < Vl)
        e = F.embedding(torch.where(inside, local, 0), table)
        return self.leave(torch.where(inside[..., None], e, 0.0))

    def nll(self, logits, labels):
        """-log softmax(logits)[label] from the rank's vocab columns
        (float32): the row maximum over the group outside autograd, the
        sums of exp and the label's logit over the group
        (`psum_partial`)."""
        Vl = logits.shape[-1]
        m = Mesh.pmax(logits.detach().amax(dim=-1), self.group)
        sumexp = self.leave(torch.exp(logits - m[..., None]).sum(dim=-1))
        local = labels.long() - self.rank * Vl
        inside = (local >= 0) & (local < Vl)
        ll = torch.gather(logits, -1,
                          torch.where(inside, local, 0)[..., None])[..., 0]
        ll = self.leave(torch.where(inside, ll, 0.0))
        return m + torch.log(sumexp) - ll

    def argmax(self, logits):
        """The greedy token (int64) over the vocab from the rank's columns
        (..., V/n): each rank's maximum and its first index, gathered; the
        largest wins, the lowest index on a tie, as `torch.argmax`."""
        Vl = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1)
        if Vl == self.cfg.vocab_size:
            return idx
        val = torch.gather(logits, -1, idx[..., None])[..., 0]
        pair = torch.stack([val.double(), (idx + self.rank * Vl).double()],
                           dim=-1)
        every = Mesh.all_gather(pair, self.group).reshape(
            *pair.shape[:-1], self.size, 2)
        best = torch.argmax(every[..., 0], dim=-1)
        return torch.gather(every[..., 1], -1, best[..., None])[..., 0].long()
