"""examples/serve_decode.py on the card: batched autoregressive greedy
decoding through one serve step reused for every token of every request,
with the PyTorch/CUDA port (`src/repro_torch`).

Greedy-decodes a batch of prompts against reduced configs of three
architectures (gemma3 with 5:1 local:global attention, mamba2 with SSM
state, mixtral MoE). The decode state (KV caches, SSM states) stays on
the device across calls and its write position is a host int, so a step
reads nothing back but the token it returns; each step feeds one token
per request. RMSNorm and attention run in the port's CUDA kernels.

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T


def serve(arch: str, batch: int = 4, prompt_len: int = 8,
          gen_tokens: int = 24, cache_len: int = 64, device=None):
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    params = T.init_params(0, cfg, device=dev)
    serve_step = ST.make_serve_step(cfg)
    state = T.init_decode_state(params, cfg, batch, cache_len,
                                torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    # prefill by stepping the prompt (simple serving loop)
    t0 = time.perf_counter()
    for t in range(prompt_len - 1):
        _, state = serve_step(params, state, prompt[:, t:t + 1])
    generated = []
    tok = prompt[:, -1:]
    for _ in range(gen_tokens):
        tok, state = serve_step(params, state, tok)
        generated.append(tok)
    out = torch.cat(generated, dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = batch * (prompt_len - 1 + gen_tokens)
    print(f"{arch:24s} batch={batch} generated {out.shape[1]} tokens/req; "
          f"{total / dt:.0f} tok/s on {dev.type}; cache_index="
          f"{state['index']}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    for arch in ["gemma3-12b", "mamba2-370m", "mixtral-8x7b"]:
        serve(arch, device=args.device)


if __name__ == "__main__":
    main()
