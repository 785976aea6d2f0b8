#!/usr/bin/env python3
"""Does the zoo's gradient repeat bit for bit on one NVIDIA GPU, with
remat and without, and with the embedding as `F.embedding` and as
indexing `table[tokens]`?

    python3 scripts/zoo_grad_repeat.py [--runs 5]

Reduced qwen3-8b in bfloat16 and float32, B 4 x S 128 from
`synthetic_lm_batch` (the inputs of `tests/test_torch_device.py::
test_zoo_remat_changes_no_bit_on_the_card`), the step's
`make_loss_and_grad` at two microbatches, `--runs` times with remat on
and `--runs` times with it off (`transformer.forward(..., remat=False)`),
for each embedding. Indexing's gradient is an accumulating `index_put_`;
`F.embedding`'s sorts the tokens first. Prints one JSON line per dtype
and embedding: the runs whose loss or gradients part from the first
remat run's, by leaf.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("zoo_grad_repeat: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    def indexing(params, tokens, cfg):
        return params["embed"][tokens]

    embeds = {"F.embedding": L.embed, "indexing": indexing}
    forward = T.forward
    for dtype in ("bfloat16", "float32"):
        cfg = get_config("qwen3-8b").reduced(param_dtype=dtype)
        params = T.init_params(0, cfg, device="cuda")
        batch = synthetic_lm_batch(cfg, ShapeConfig(
            "t", seq_len=128, global_batch=4, kind="train"), 0)
        names = [("emb.embed " if p is params["emb"]["embed"] else "")
                 + f"leaf {i} {tuple(p.shape)}"
                 for i, p in enumerate(tree_leaves(params))]
        lg = ST.make_loss_and_grad(cfg, num_micro=2)
        for label, fn in embeds.items():
            runs = []
            L.embed = fn
            try:
                for remat in (True, False):
                    T.forward = functools.partial(forward, remat=remat)
                    runs += [(remat, *lg(params, batch))
                             for _ in range(args.runs)]
            finally:
                L.embed, T.forward = embeds["F.embedding"], forward
            torch.cuda.synchronize()
            first_loss, first = runs[0][1], tree_leaves(runs[0][2])
            parted = []
            for r, (remat, loss, grads) in enumerate(runs[1:], 1):
                leaves = [names[i] for i, (a, b) in enumerate(zip(
                    tree_leaves(grads), first)) if not torch.equal(a, b)]
                if leaves or not torch.equal(loss, first_loss):
                    parted.append({"run": r, "remat": remat, "loss_equal":
                                   torch.equal(loss, first_loss),
                                   "leaves": leaves})
            print(json.dumps({"dtype": dtype, "embed": label,
                              "runs_each": args.runs, "num_micro": 2,
                              "vocab": cfg.vocab_size, "parted": parted}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
