#!/usr/bin/env python3
"""Kernels, copies, device time and wall of one SGD step of the
transformer path on one NVIDIA GPU, for the port in this checkout or in
another one.

    python3 scripts/trace_transformer_step.py [--src DIR] [--label NAME]
                                              [--runs N]

Builds the transformer FedBuff world of `chip_smoke.py` on the card with
the port found under DIR (default: this checkout's `src`), then runs
`chip_smoke.trace_attention_call` (one attention call of the path, forward
and backward, traced: the kernels it runs and its copy kernels) and
`chip_smoke.trace_client_update` (one batched client update of 20
satellites: kernels, copy kernels and device microseconds per SGD step,
the step's wall and the busy share). Prints one JSON line. Run it with
`--src` on an unpacked earlier commit (`git archive`) to compare two
versions on one card, in turns (parent, change, change, parent, ...).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds repro_torch")
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=5,
                    help="untraced client updates timed for the wall")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("trace_transformer_step: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.fl.api import Federation
    exp = chip_smoke.transformer_experiment()
    fed = Federation.from_experiment(exp)
    out = {"label": args.label, "src": str(Path(repro_torch.__file__).parent),
           "device": torch.cuda.get_device_name(0),
           "attention_call": chip_smoke.trace_attention_call(torch),
           "client_update": chip_smoke.trace_client_update(
               torch, fed.adapter, exp.train, runs=args.runs)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
