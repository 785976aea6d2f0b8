#!/usr/bin/env python3
"""Whether `chip_smoke.py`'s `mesh` phase leaves a cost behind for the
phases that run after it, on one NVIDIA GPU.

    python3 scripts/mesh_phase_after_cost.py [--rounds 3] [--control]

Builds the aggregation kernel and starts the CPU's thread pool (one
CPU matrix product, as the CPU runs before the phase in `chip_smoke.py`
do), then times the quickstart FedBuff run of `chip_smoke.py` (its fast
loop, then its host loop) `--rounds` times, runs the `mesh` phase
(a world-1 NCCL group started with `core.mesh.init_world`, used inside
CUDA graphs by `chip_smoke.run_mesh_path`, and destroyed), and times the same runs `--rounds` times
again, all in one process on one card. `--control` leaves the phase out,
so that a control process run beside it (ABBA) shows the host's own
drift. It also counts the process's threads by name before and after
the phase (and after a `gc.collect()`). Prints one JSON object per line
and appends them to `chiprun_out/mesh_phase_after_cost.jsonl`.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chip_smoke import (LoopStats, _engine,  # noqa: E402
                        quickstart_experiment, run_mesh_path)
from repro_torch.core.mesh import init_world  # noqa: E402
from repro_torch.fl.api import Federation  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.agg import kernel as agg_kernel  # noqa: E402


def threads() -> Counter:
    """The process's threads by name."""
    names = Counter()
    for tid in os.listdir("/proc/self/task"):
        try:
            comm = Path(f"/proc/self/task/{tid}/comm").read_text()
            names[comm.strip()] += 1
        except OSError:
            pass
    return names


def quickstart_pair(fed):
    """Walls (s) of the quickstart's fast-loop run and host-loop run."""
    out = {}
    for label, fast in (("fast", True), ("host", False)):
        eng = _engine(fed, fast_loop=fast)
        with LoopStats(torch) as st:
            eng.run()
        out[label] = st.wall
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--control", action="store_true",
                    help="leave the mesh phase out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    build.build([agg_kernel.SOURCE])
    fed = Federation.from_experiment(quickstart_experiment())
    rows = []

    def emit(row):
        row = dict(row, run="control" if args.control else "mesh",
                   card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)

    a = torch.randn(2000, 2000)
    (a @ a).sum()                              # the CPU's thread pool
    quickstart_pair(fed)                       # warm-up: graphs, caches
    for when in ("before", "after"):
        if when == "after":
            t_before = threads()
            t0 = time.perf_counter()
            if not args.control:
                init_world("cuda")
                try:
                    run_mesh_path(torch, smi)
                finally:
                    dist.destroy_process_group()
            wall = time.perf_counter() - t0
            t_after = threads()
            gc.collect()
            emit({"mesh_phase_s": wall,
                  "threads_before": sum(t_before.values()),
                  "threads_after": sum(t_after.values()),
                  "threads_after_gc": sum(threads().values()),
                  "new_threads": dict(t_after - t_before),
                  "new_threads_after_gc": dict(threads() - t_before)})
        for i in range(args.rounds):
            emit({"when": when, "round": i, **{
                f"{k}_s": v for k, v in quickstart_pair(fed).items()}})
    out = ROOT / "chiprun_out" / "mesh_phase_after_cost.jsonl"
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
