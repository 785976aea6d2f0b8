"""FL launcher: run the FedSpace protocol (or any registered scheduler)
over the satellite constellation — the paper's system as a deployable
launcher, built entirely through the declarative `repro_torch.fl.api`
layer. The port of `repro.launch.fl_train`, with the same arguments and
defaults, on the card unless `--device cpu` is given.

    PYTHONPATH=src python -m repro_torch.launch.fl_train \\
        --scheduler fedspace --setting noniid --days 10 --target-acc 0.4

Any scheduler registered via `@register_scheduler` is selectable by name;
`--metrics-jsonl` streams eval metrics live to a JSONL file and `--out`
writes the summary and the accuracy curve as JSON.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                DatasetConfig, FLExperiment, Federation,
                                PartitionConfig, SchedulerConfig)
from repro_torch.fl.callbacks import JsonlMetricsCallback, ProgressCallback
from repro_torch.fl.engine import EngineConfig
from repro_torch.fl.registry import ADAPTERS, SCHEDULERS


def build_experiment(args) -> FLExperiment:
    """The launcher's `FLExperiment` from parsed arguments (the
    reference's, field for field)."""
    scheduler = SchedulerConfig(kind=args.scheduler)
    if args.scheduler == "fedbuff":
        scheduler.params["M"] = args.M
    if args.scheduler == "fedspace":
        scheduler.setup = {"local_steps": args.local_steps,
                           "client_lr": args.client_lr}
    return FLExperiment(
        name=f"fl_train-{args.scheduler}-{args.setting}",
        constellation=ConstellationConfig(
            num_satellites=args.satellites, days=min(args.days, 5.0)),
        dataset=DatasetConfig(num_train=args.num_train,
                              num_val=args.num_train // 5, noise=2.2),
        partition=PartitionConfig(kind=args.setting),
        adapter=AdapterConfig(
            kind=args.model,
            params={"hidden": 48} if args.model == "mlp" else {}),
        scheduler=scheduler,
        train=EngineConfig(local_steps=args.local_steps,
                           client_lr=args.client_lr, eval_every=24,
                           target_acc=args.target_acc,
                           max_windows=int(args.days * 96),
                           repeat_connectivity=0),   # auto-tile C
        seed=args.seed,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fl_train",
        description="Run one federated run of the port.")
    ap.add_argument("--scheduler", default="fedspace",
                    choices=SCHEDULERS.names())
    ap.add_argument("--setting", default="noniid",
                    choices=["iid", "noniid"])
    ap.add_argument("--model", default="mlp", choices=ADAPTERS.names())
    ap.add_argument("--satellites", type=int, default=191)
    ap.add_argument("--days", type=float, default=10.0)
    ap.add_argument("--target-acc", type=float, default=0.40)
    ap.add_argument("--client-lr", type=float, default=1.0)
    ap.add_argument("--local-steps", type=int, default=16)
    ap.add_argument("--num-train", type=int, default=9600)
    ap.add_argument("--M", type=int, default=96, help="FedBuff buffer")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream eval metrics to this JSONL file")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse `argv` (default: the command line), build and run the
    experiment, print its summary as JSON; returns the summary."""
    args = parser().parse_args(argv)
    fed = Federation.from_experiment(build_experiment(args),
                                     device=args.device)
    if fed.scheduler_diag:
        print(f"utility regressor: {fed.scheduler_diag}")

    callbacks = [ProgressCallback()]
    if args.metrics_jsonl:
        callbacks.append(JsonlMetricsCallback(args.metrics_jsonl))
    res = fed.run(callbacks=callbacks)

    summary = res.summary()
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "accuracy": res.accuracy,
                       "eval_windows": res.eval_windows}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
