#!/usr/bin/env python3
"""Run `chip_smoke.py`'s `zoo tp` phase alone on one NVIDIA GPU (tensor
parallelism over the model axis: two gloo ranks spawned on the card, the
mesh (1, 2), qwen3-8b and qwen3-moe-30b-a3b cut in depth against
`mesh=None`), after building the RMSNorm and attention kernels.

    python3 scripts/zoo_tp_phase.py [--controls]

`--controls` first measures how far the MoE part's gradients move on one
device when only the kernels' numerics change: qwen3-moe-30b-a3b's
`mesh=None` loss and gradient (`chip_smoke._tp_program`, part "b") in
bf16 and in float32, each against the same with the kernels' plain
versions swapped in (`chip_smoke.PlainVersions`), with the tokens whose
expert set differs (`chip_smoke.MoeRoutes`). Prints one JSON line a
control, the phase's own lines, and appends the controls to
`chiprun_out/zoo_tp_phase.jsonl`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402


def control(torch, cfg, card):
    """`mesh=None`'s part "b" with the kernels against the plain
    versions: loss, grad norm, routing flips, named leaves' relative L2."""
    ref = C._tp_program(torch, cfg, None, "b")
    with C.PlainVersions():
        plain = C._tp_program(torch, cfg, None, "b")
    return {"control": "moe kernels vs plain versions, mesh=None",
            "arch": cfg.name, "dtype": cfg.param_dtype,
            "loss": abs(ref["loss"] - plain["loss"]) / abs(ref["loss"]),
            "grad_norm": abs(ref["grad_norm_lg"] - plain["grad_norm_lg"])
            / ref["grad_norm_lg"],
            "routing_flips": C._flips(plain["routes"], ref["routes"]),
            "grads": {k: C._rel_l2(plain["grads"][k], ref["grads"][k])
                      for k in ref["grads"]},
            "card": card}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--controls", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("zoo_tp_phase: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.rmsnorm import kernel as R
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}",
          flush=True)
    build.build([R.SOURCE, F.SOURCE, F.SOURCE_TC, F.SOURCE_BWD_TC,
                 F.SOURCE_TC256, F.SOURCE_BWD_TC256])
    if args.controls:
        moe = C.tp_config("qwen3-moe-30b-a3b")[0]
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        for dtype in ("bfloat16", "float32"):
            line = json.dumps(control(
                torch, dataclasses.replace(moe, param_dtype=dtype), card))
            print(line, flush=True)
            with open(out / "zoo_tp_phase.jsonl", "a") as f:
                f.write(line + "\n")
    t0 = time.perf_counter()
    C.run_zoo_tp_path(torch, card)
    print(f"zoo_tp_phase: {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
