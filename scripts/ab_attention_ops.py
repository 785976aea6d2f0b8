#!/usr/bin/env python3
"""The transformer path's client update with the attention of an earlier
checkout against this checkout's, in one process and in turns, on one
NVIDIA GPU.

    python3 scripts/ab_attention_ops.py --parent DIR [--pairs N]

DIR is an earlier checkout's `src` (unpacked with `git archive`). Its
`repro_torch/kernels/flash_attention/kernel.py` and `ops.py` are loaded
beside this checkout's port (they import only `kernels.build`,
`launch_counts` and the plain version, which must be the same in both), so
its kernels are built from its own sources. The transformer adapter's
attention call is then pointed at one or the other for each batched
client update of `chip_smoke.py`'s transformer world (20 satellites,
`local_steps` SGD steps); each timed update follows an untimed one of the
same kind, and the first of each pair alternates. Between processes the
step's wall spreads more than the two differ; in one process both share
the host's state. Prints one JSON line: the wall per SGD step of each
update, the medians, and in how many pairs this checkout's was lower.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def parent_ops(src: Path):
    """The earlier checkout's attention `ops` module, its `kernel` module
    loaded from the same checkout."""
    d = src / "repro_torch" / "kernels" / "flash_attention"
    spec = importlib.util.spec_from_file_location("parent_kernel",
                                                  d / "kernel.py")
    kernel = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kernel)
    ops = types.ModuleType("parent_ops")
    ops.kernel = kernel
    code = (d / "ops.py").read_text().replace(
        "from repro_torch.kernels.flash_attention import kernel\n", "")
    exec(compile(code, str(d / "ops.py"), "exec"), ops.__dict__)
    return ops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the earlier checkout's src directory")
    ap.add_argument("--pairs", type=int, default=16)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ab_attention_ops: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch.fl.adapters as adapters
    from repro_torch.fl.api import Federation
    from repro_torch.fl.client import make_batched_client_update
    from repro_torch.kernels.flash_attention import ops
    ways = {"parent": parent_ops(Path(args.parent).resolve())
            .flash_attention_bshd, "change": ops.flash_attention_bshd}
    exp = chip_smoke.transformer_experiment()
    adapter, train = Federation.from_experiment(exp).adapter, exp.train
    params = adapter.init(torch.Generator().manual_seed(0))
    batch, _ = adapter.client_batch_many(
        list(range(chip_smoke.MAIN_PATH_M)), 0, train.batch_size,
        train.local_steps)
    batch = tuple(batch)
    update = make_batched_client_update(adapter, local_steps=train.local_steps,
                                        lr=train.client_lr)
    walls = {name: [] for name in ways}
    for i in range(args.pairs):
        for name in list(ways)[::1 if i % 2 == 0 else -1]:
            adapters.flash_attention_bshd = ways[name]
            update(params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            update(params, batch)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0)
                               / train.local_steps * 1e3)
    adapters.flash_attention_bshd = ops.flash_attention_bshd
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "pairs": args.pairs,
        "wall_ms_per_step": walls,
        "median_ms": {n: sorted(w)[len(w) // 2] for n, w in walls.items()},
        "change_lower_in": sum(c < p for p, c in zip(walls["parent"],
                                                     walls["change"]))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
