"""Dry run: execute every (arch x shape) step once on PyTorch's meta device
and record its roofline terms (the port of `repro.launch.dryrun`).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single --out results/dryrun_torch.json

Where the reference lowers and compiles the step ahead of time, the port
runs it once on meta tensors, its counterpart: every shape is checked,
nothing is allocated and no card is touched (a dry run needs none). The
step's arguments are `launch.steps.build`'s; a train step runs its
backward and its optimizer too, and a decode step runs at the cache's last
slot, where it reads the whole cache, as the reference's compiled step
does at every slot. The record has the reference's keys, so that
`benchmarks/roofline_report.py` reads the port's file as it reads the
reference's:

  * `hlo_flops` and `hlo_bytes` hold `roofline.OpCounter`'s totals over
    the executed ops (there is no HLO); `xla_cost_flops_unscaled` holds
    its matrix-product FLOPs without the kernels' (there is no XLA);
  * `chips` is 256 (`--mesh single`) or 512 (`multi`), the reference's
    production meshes (`launch.mesh.production_mesh_shape`, passed to
    `build`, which gives the step of one device and the shardings of the
    mesh), over which the terms are spread;
  * `memory`: `argument_bytes` and `output_bytes` a chip, as the
    reference's memory analysis gives them: each leaf's bytes over the
    product of the mesh sizes its spec shards it over (`sharding.
    NamedSharding.shards`); `temp_bytes` and `generated_code_bytes` are
    null, since no compiler plans the step.

`--opt-decode` sets `sharding.DECODE_OPT` for the run (the decode caches'
feature dim over 'model'). `--strict-dtypes` is the reference's XLA flag
that keeps its agg_opt all-reduce in bf16; the port's `make_agg_step_opt`
all-reduces in bf16 already, so the flag is accepted and changes nothing.

Each invocation runs one combination and appends its record to the JSON
file (`append_result`, under a lock, replacing an earlier record of the
same arch, shape and mesh).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import sharding as Sh
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import input_specs as IS
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.tree import tree_leaves

MESH_CHIPS = {"single": 256, "multi": 512}


def chip_bytes(tree, shardings) -> int:
    """Bytes a chip of the tensors of `tree` (leaves in order with the
    `NamedSharding`s of `shardings`): each leaf's over its shard count.
    A host int (the decode state's index) is no tensor and counts 0."""
    leaves = tree_leaves(tree)
    named = tree_leaves(shardings,
                        is_leaf=lambda x: isinstance(x, Sh.NamedSharding))
    if len(leaves) != len(named):
        raise ValueError(f"{len(leaves)} leaves for {len(named)} shardings")
    return sum(t.numel() * t.element_size() // s.shards()
               for t, s in zip(leaves, named)
               if isinstance(t, torch.Tensor))


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            num_micro=None, q_chunk=512, moe_groups=1) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "skipped", "time_s": 0.0}
    if not IS.applicable(cfg, shape):
        rec["reason"] = "long_500k requires sub-quadratic decode (DESIGN.md)"
        return rec
    t0 = time.time()
    chips = MESH_CHIPS[mesh_kind]
    mesh = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    try:
        fn, args, in_sh, out_sh = ST.build(
            cfg, shape, mesh, num_micro=num_micro, q_chunk=q_chunk,
            moe_groups=moe_groups)
        if shape.kind == "decode":
            args[1]["index"] = shape.seq_len - 1
        arg_bytes = chip_bytes(args, in_sh)
        with RL.OpCounter() as counter:
            out = fn(*args)
        terms = RL.analyze(counter, chips)
        terms["xla_cost_flops_unscaled"] = float(
            counter.flops - sum(counter.kernel_flops.values()))
        params_shape = args[0]
        n_total = RL.count_params(params_shape)
        n_active = RL.count_active_params(cfg, params_shape)
        mflops = RL.model_flops(cfg, shape, n_active, n_total)
        rec.update({
            "status": "ok",
            "chips": chips,
            "params_total": n_total,
            "params_active": n_active,
            "model_flops": mflops,
            "useful_flops_ratio": (mflops / terms["hlo_flops"]
                                   if terms["hlo_flops"] else None),
            **terms,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": chip_bytes(out, out_sh),
                       "temp_bytes": None, "generated_code_bytes": None},
            "ops_counted": counter.ops,
            "kernel_calls": dict(counter.kernel_calls),
        })
        dom = max(("compute", "memory", "collective"),
                  key=lambda k: rec[f"t_{k}_s"])
        rec["dominant_term"] = dom
    except Exception as e:  # noqa: BLE001 — a dry-run failure is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def append_result(path: str, rec: dict):
    import fcntl
    lockpath = path + ".lock"
    lock = open(lockpath, "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    try:
        _append_locked(path, rec)
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()


def _append_locked(path: str, rec: dict):
    try:
        with open(path) as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        data = []
    data = [r for r in data
            if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                    and r["mesh"] == rec["mesh"])]
    data.append(rec)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=list(MESH_CHIPS))
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--num-micro", type=int, default=None)
    ap.add_argument("--q-chunk", type=int, default=512,
                    help="accepted; changes nothing (models/attention.py)")
    ap.add_argument("--moe-groups", type=int, default=1,
                    help="-1 = auto (one routing group per sequence); "
                         "-2 = expert parallelism (on the mesh's shape: "
                         "one routing group a data shard); -3 on an agg "
                         "shape = the opt agg step")
    ap.add_argument("--remat-attn", action="store_true",
                    help="accepted; changes nothing (the port's attention "
                         "is one kernel call, not q-chunks)")
    ap.add_argument("--opt-decode", action="store_true",
                    help="sharding.DECODE_OPT: the decode caches' feature "
                         "dim over 'model', vocab-sharded serve logits")
    ap.add_argument("--strict-dtypes", action="store_true",
                    help="the reference's XLA flag keeping agg_opt's "
                         "all-reduce in bf16; accepted and changes "
                         "nothing (the port's is bf16 already)")
    ap.add_argument("--variant", default="",
                    help="tag appended to the record key")
    ap.add_argument("--save-hlo", default=None,
                    help="the reference's HLO dump; the port has none")
    args = ap.parse_args(argv)
    if args.save_hlo:
        raise SystemExit("--save-hlo: the port executes its steps eagerly "
                         "and has no HLO to save")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    decode_opt = Sh.DECODE_OPT
    Sh.DECODE_OPT = decode_opt or args.opt_decode
    try:
        rec = run_one(args.arch, args.shape, args.mesh,
                      num_micro=args.num_micro, q_chunk=args.q_chunk,
                      moe_groups=args.moe_groups)
    finally:
        Sh.DECODE_OPT = decode_opt
    if args.variant:
        rec["shape"] = rec["shape"] + "+" + args.variant
    append_result(args.out, rec)
    drop = {"traceback"}
    print(json.dumps({k: v for k, v in rec.items() if k not in drop},
                     indent=1))
    if rec["status"] == "error":
        print(rec.get("traceback", ""))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
