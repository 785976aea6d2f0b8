"""Compact DenseNet-style CNN, the paper's own FL model family (the port of
`repro.models.densenet`): DenseNet-161 on fMoW with batch norm replaced by
group norm (Hsieh et al. 2020), at reduced width.

The parameter tree is the reference's, key for key and in the same
layouts: convolution weights HWIO (kh, kw, c_in, c_out), group-norm scale
and bias per channel, the head (c, classes); the blocks are a list, each a
dict with a list of layers. `densenet_apply` takes the parameters with or
without a leading satellite axis M (the batched client update's). With
it, satellite m's channels are group m of one grouped `F.conv2d`
(`groups=M`), so one convolution serves the whole stack; the HWIO weights
are permuted to PyTorch's OIHW at the call. Convolutions run at stride 1
with "SAME" padding (1 for 3x3, 0 for 1x1). Group norm, ReLU, the 2x2
average pool of the transitions and the global-mean head are plain tensor
ops. `frozen_mask` marks the stem and the first `frozen_blocks` blocks
frozen, the paper's transfer-learning setup (the client update multiplies
their gradients by 0).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_map

NUM_GROUPS = 8


def _conv_init(generator, kh, kw, cin, cout):
    scale = (kh * kw * cin) ** -0.5
    return torch.randn((kh, kw, cin, cout), generator=generator) * scale


def _conv(h, w):
    """h (B, M, c_in, H, W), w (M, kh, kw, c_in, c_out) -> (B, M, c_out,
    H, W): satellite m's channels convolved with its own weights, as one
    grouped convolution."""
    B, M, _, H, W = h.shape
    _, kh, kw, cin, cout = w.shape
    w = w.permute(0, 4, 3, 1, 2).reshape(M * cout, cin, kh, kw)
    y = F.conv2d(h.reshape(B, M * cin, H, W), w, padding=kh // 2, groups=M)
    return y.view(B, M, cout, H, W)


def _groupnorm(params, h, eps=1e-5):
    """Group norm of h (B, M, C, H, W) over contiguous channel groups: the
    mean and the biased variance over (C/g, H, W) of each sample's group,
    then the satellite's per-channel scale and bias (M, C)."""
    B, M, C, H, W = h.shape
    g = min(NUM_GROUPS, C)
    hg = h.reshape(B, M, g, C // g, H, W).float()
    mu = hg.mean(dim=(3, 4, 5), keepdim=True)
    var = ((hg - mu) ** 2).mean(dim=(3, 4, 5), keepdim=True)
    hn = ((hg - mu) * torch.rsqrt(var + eps)).reshape(B, M, C, H, W)
    return (hn * params["scale"][None, :, :, None, None]
            + params["bias"][None, :, :, None, None])


def _gn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def densenet_init(generator: torch.Generator, *, num_classes=62, growth=12,
                  blocks=(4, 4, 4, 4), stem=24, in_channels=3):
    """The reference's tree (the same keys, shapes and float32 dtypes),
    drawn from `generator` (a CPU generator: the numbers differ from the
    reference's `jax.random` draw; see `repro_torch.weights`)."""
    p = {"stem": _conv_init(generator, 3, 3, in_channels, stem)}
    c = stem
    p["blocks"] = []
    for bi, n in enumerate(blocks):
        layers = []
        for _ in range(n):
            layers.append({"gn": _gn_init(c),
                           "conv": _conv_init(generator, 3, 3, c, growth)})
            c += growth
        blk = {"layers": layers}
        if bi != len(blocks) - 1:
            cout = c // 2
            blk["trans"] = {"gn": _gn_init(c),
                            "conv": _conv_init(generator, 1, 1, c, cout)}
            c = cout
        p["blocks"].append(blk)
    p["head_gn"] = _gn_init(c)
    p["head"] = torch.randn((c, num_classes), generator=generator) \
        * c ** -0.5
    return p


def densenet_apply(params, x):
    """x (B, H, W, C) -> logits (B, num_classes); with a leading satellite
    axis on every leaf of `params`, x (M, B, H, W, C) -> (M, B,
    num_classes)."""
    batched = params["stem"].dim() == 5
    if not batched:
        params = tree_map(lambda t: t.unsqueeze(0), params)
        x = x.unsqueeze(0)
    h = _conv(x.permute(1, 0, 4, 2, 3).contiguous(), params["stem"])
    for blk in params["blocks"]:
        for lyr in blk["layers"]:
            y = _conv(torch.relu(_groupnorm(lyr["gn"], h)), lyr["conv"])
            h = torch.cat([h, y], dim=2)
        if "trans" in blk:
            h = torch.relu(_groupnorm(blk["trans"]["gn"], h))
            h = _conv(h, blk["trans"]["conv"])
            B, M, C, H, W = h.shape
            h = F.avg_pool2d(h.reshape(B, M * C, H, W), 2).view(
                B, M, C, H // 2, W // 2)
    h = torch.relu(_groupnorm(params["head_gn"], h)).mean(dim=(3, 4))
    logits = h.transpose(0, 1) @ params["head"]
    return logits if batched else logits[0]


def frozen_mask(params, frozen_blocks: int):
    """1.0 for trainable leaves, 0.0 for frozen ones (the stem and the
    first `frozen_blocks` blocks), the paper's 'freeze the lower dense
    blocks'."""
    mask = tree_map(lambda _: 1.0, params)
    if frozen_blocks <= 0:
        return mask
    mask["stem"] = tree_map(lambda _: 0.0, mask["stem"])
    for bi in range(min(frozen_blocks, len(params["blocks"]))):
        mask["blocks"][bi] = tree_map(lambda _: 0.0, mask["blocks"][bi])
    return mask
