"""Run the full dry-run sweep: every (arch x input-shape x mesh) combination
in a fresh process (`python -m repro_torch.launch.dryrun`), skipping
combinations already recorded as ok or skipped (the port of
`repro.launch.sweep`). A dry run executes on the meta device and needs no
card. Usage:

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --out results/dryrun_torch.json --jobs 4 [--mesh single multi]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "mamba2-370m", "h2o-danube-1.8b", "phi-3-vision-4.2b",
    "qwen3-moe-30b-a3b", "qwen3-8b", "gemma3-12b", "recurrentgemma-9b",
    "minitron-4b", "whisper-base", "mixtral-8x7b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def existing(out):
    try:
        with open(out) as f:
            return {(r["arch"], r["shape"], r["mesh"]): r["status"]
                    for r in json.load(f)}
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--archs", nargs="+", default=ARCHS)
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    done = {} if args.force else existing(args.out)
    todo = []
    for mesh in args.mesh:
        for arch in args.archs:
            for shape in args.shapes:
                if done.get((arch, shape, mesh)) in ("ok", "skipped"):
                    continue
                todo.append((arch, shape, mesh))
    print(f"{len(todo)} combinations to run", flush=True)

    def run(combo):
        arch, shape, mesh = combo
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", args.out]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           env=dict(os.environ), timeout=1800)
        status = "ok" if r.returncode == 0 else "FAIL"
        print(f"[{status}] {arch} {shape} {mesh}", flush=True)
        if r.returncode != 0:
            print(r.stdout[-1500:], r.stderr[-500:], flush=True)
        return status

    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        results = list(ex.map(run, todo))
    fails = results.count("FAIL")
    print(f"done: {len(results) - fails} ok, {fails} failed", flush=True)


if __name__ == "__main__":
    main()
