#!/usr/bin/env python3
"""Kernels, copies, device and host time of the aggregations of both main
paths on one NVIDIA GPU, for the port in this checkout or in another one.

    python3 scripts/trace_aggregation.py [--src DIR] [--label NAME]
                                         [--traced N]

Runs `chip_smoke.trace_aggregation` on the quickstart and the transformer
FedBuff worlds of `chip_smoke.py` with the port found under DIR (default:
this checkout's `src`): each federation on the card, stopped after
2 * N + 1 aggregations, every other one traced from the end of its last
batched client update to the new params. Prints one JSON line. Run it
with `--src` on an unpacked earlier commit (`git archive`) to compare two
versions on one card, in turns (parent, change, change, parent).
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
    ap.add_argument("--traced", type=int, default=3,
                    help="aggregations traced (as many more are timed)")
    args = ap.parse_args()
    chip_smoke.use_port(args.src)
    import torch
    if not torch.cuda.is_available():
        print("trace_aggregation: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    out = {"label": args.label, "src": str(Path(repro_torch.__file__).parent),
           "device": torch.cuda.get_device_name(0)}
    for exp in (chip_smoke.quickstart_experiment(),
                chip_smoke.transformer_experiment()):
        out[exp.name] = chip_smoke.trace_aggregation(torch, exp,
                                                     traced=args.traced)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
