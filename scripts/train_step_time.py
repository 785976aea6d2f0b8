#!/usr/bin/env python3
"""Time a train step of recurrentgemma-9b at full width on one NVIDIA GPU,
for the port in this checkout or in another one.

    python3 scripts/train_step_time.py [--src DIR] [--label NAME]
                                       [--timed N]

The configuration of `chip_smoke.py`'s `train (d)` (`rg_train_config`: 6
of its 38 layers, two of them local attention; bf16; B 2 x S 4096 in 2
microbatches, remat on; AdamW): the params drawn on the card from seed 0,
one untimed step, then N timed steps and two traced
(`chip_smoke.time_train_steps`). Prints one JSON line: ms a step (the
median) and each step's, tokens/s, `mfu`, peak memory, and the trace
(kernels, device us, busy share, the attention backward's share, the
slowest kernels). Run it with `--src` on an unpacked earlier commit (`git
archive`) to compare two versions on one card, in turns (parent, change,
change, parent).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--label", default="")
    ap.add_argument("--timed", type=int, default=chip_smoke.TRAIN_FULL_TIMED)
    args = ap.parse_args()
    chip_smoke.use_port(args.src)
    import torch
    if not torch.cuda.is_available():
        print("train_step_time: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = chip_smoke.rg_train_config()
    step, nm, params, opt, batches = chip_smoke.train_setup(
        torch, cfg, chip_smoke.RG_TRAIN, steps=args.timed + 3)
    params, opt, _ = step(params, opt, batches[0])     # warm: builds, caches
    ms, ms_steps, losses, peak, trace = chip_smoke.time_train_steps(
        torch, step, params, opt, batches, args.timed)
    B, S = chip_smoke.RG_TRAIN
    flops = chip_smoke.rg_train_flops(cfg, params)
    print(json.dumps({
        "label": args.label,
        "src": str(Path(repro_torch.__file__).parent),
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "layers": cfg.num_layers, "batch": B, "seq": S, "num_micro": nm,
        "ms_per_step": ms, "ms_steps": ms_steps,
        "tokens_per_s": B * S / ms * 1e3,
        "mfu": flops / (ms / 1e3) / chip_smoke.cost.BF16_TC_FLOP_PER_S,
        "max_memory_allocated_gb": peak / 1e9, "loss": losses,
        "traced": trace}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
