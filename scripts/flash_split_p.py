#!/usr/bin/env python3
"""Why the tensor-core attention forward splits P into two bf16 parts.

    python3 scripts/flash_split_p.py

`src/repro_torch/kernels/flash_attention/csrc/flash_fwd_tc.cu` computes
O += P V as two products, of P's high and of its low bf16 part. This
script builds a variant of the same source without the low part's
products (P rounded once to bf16) into `build/kernels/` and compares, on
one NVIDIA GPU, the two variants and the CUDA-core forward
(`flash_attention.cu`), at the bfloat16 GQA x mask sweep (hd 64, S 128)
and qwen3-8b's head layout (hd 128, S 2048, causal), on the same inputs:
  - the forward's largest error against the plain version and the share
    of o's elements that differ from the plain version's;
  - the backward (`flash_attention.cu`, fed each forward's o and lse)
    against the plain backward fed the plain forward's o and lse, at the
    bfloat16 tolerance of `chip_smoke.py` (rtol = atol = 1e-2);
  - each forward's time (CUDA events, after a warm-up).
Prints one JSON object per shape and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import _time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_fwd_ref)

LOW_PART = ("        mma_bf16(acc[2 * nn], pl, bf[0], bf[1]);\n",
            "        mma_bf16(acc[2 * nn + 1], pl, bf[2], bf[3]);\n")
SHAPES = [(2, h, kv, 128, 128, 64, causal, window)
          for h, kv in ((4, 4), (4, 2), (8, 1))
          for causal, window in ((True, 0), (True, 32), (False, 0))] + [
    (1, 32, 8, 2048, 2048, 128, True, 0)]


def one_part_variant():
    """The tensor-core forward without the low part's products, built."""
    src = K.SOURCE_TC.read_text()
    for line in LOW_PART:
        if src.count(line) != 1:
            raise RuntimeError(f"{K.SOURCE_TC.name} changed: {line!r}")
        src = src.replace(line, "")
    path = build.BUILD_DIR / "flash_fwd_tc_one_part.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return K._typed(build.load(path).flash_fwd_tc_launch, 5)


def forward(launch, q, k, v, causal, window):
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *K._dims(q, k, causal, window, q.shape[-1]))
    if err:
        raise RuntimeError(f"launch failed with cudaError {err}")
    return o, lse


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_split_p: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    variants = {"split": K._library_tc(), "one_part": one_part_variant(),
                "cuda_core": K._library()[0]}
    g = torch.Generator(device="cuda").manual_seed(2)
    for B, H, KH, sq, sk, hd, causal, window in SHAPES:
        q, do = (torch.randn(B, H, sq, hd, generator=g,
                             device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(B, KH, sk, hd, generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=window)
        o_ref, lse_ref = attention_fwd_ref(q, k, v, **kw)
        grads_ref = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        row = {"B": B, "H": H, "K": KH, "Sq": sq, "Sk": sk, "hd": hd,
               "causal": causal, "window": window}
        for name, launch in variants.items():
            o, lse = forward(launch, q, k, v, causal, window)
            grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            row[name] = {
                "fwd_max_abs_err": (o.float() - o_ref.float()).abs().max()
                .item(),
                "o_differs_share": (o != o_ref).float().mean().item(),
                "bwd_max_abs_err": max((a.float() - b.float()).abs().max()
                                       .item()
                                       for a, b in zip(grads, grads_ref)),
                "bwd_within_tol": all(torch.allclose(
                    a.float(), b.float(), rtol=1e-2, atol=1e-2)
                    for a, b in zip(grads, grads_ref)),
                "fwd_ms": _time_ms(
                    lambda: forward(launch, q, k, v, causal, window),
                    10 if sq > 1000 else 100)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
