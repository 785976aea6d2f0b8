#!/usr/bin/env python3
"""Time `chip_smoke.py`'s `train (c)` (Part B of
examples/satellite_fl_train.py: mamba2-370m's full config through
`repro_torch.launch.train.train`, `chip_smoke.PART_B`) on one NVIDIA GPU,
for the port in this checkout or in another one.

    python3 scripts/part_b_time.py [--src DIR] [--label NAME] [--runs 2]

A world-1 NCCL group is started first, outside every timed wall, as
`chip_smoke.py` starts it before its train phase (a port whose `train`
trains on the host mesh takes it; one that trains without a mesh leaves
it alone). One untimed run warms the kernels' builds and caches, then
`--runs` timed runs, each timed as `train (c)` is (`chip_smoke.part_b`):
the call's wall over its steps, and the median of its steps timed
alone. Prints one JSON line (both for each run; the last run's steps,
loss history, kernel launches and collectives) and appends it to
`chiprun_out/part_b_time.jsonl`. Run it with `--src` on an
unpacked earlier commit (`git archive`) to compare two versions on one
card, in turns (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
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
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    chip_smoke.use_port(args.src)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("part_b_time: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.core.mesh import collective_counts
    from repro_torch.kernels import launch_counts
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        steps = chip_smoke.PART_B["steps"]
        ms, alone, hist = [], [], None
        for i in range(args.runs + 1):
            launch_counts.clear()
            collective_counts.clear()
            hist, wall, ms_steps = chip_smoke.part_b(torch)
            if i:
                ms.append(wall / steps * 1e3)
                alone.append(statistics.median(ms_steps))
    finally:
        dist.destroy_process_group()
    row = {"label": args.label,
           "src": str(Path(repro_torch.__file__).parent),
           "arch": "mamba2-370m", **chip_smoke.PART_B,
           "ms_per_step": ms, "ms_per_step_steps_alone": alone,
           "ms_steps_last_run": ms_steps, "loss_history": hist,
           "launches": dict(launch_counts),
           "collectives": dict(collective_counts), "card": card}
    print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "part_b_time.jsonl", "a") as f:
        f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
