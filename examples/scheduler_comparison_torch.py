"""examples/scheduler_comparison.py on the PyTorch port: one declarative
preset world, every registered policy raced over it via
`Federation.with_scheduler` — constellation, data, adapter and the ISL
topology built once on the card and shared by all runs. The experiment
carries an `ISLConfig`, which only the ISL-aware policies (`intra_plane`,
`isl_async`) act on; the ground-only schedulers run the unmodified
protocol on the very same world. Every aggregation is one launch of the
port's eq.-4 kernel.

Run:  PYTHONPATH=src python examples/scheduler_comparison_torch.py
"""
import time

import torch

from repro_torch.fl.api import (AdapterConfig, ConstellationConfig,
                                DatasetConfig, FLExperiment, Federation,
                                ISLConfig, PartitionConfig, SchedulerConfig)
from repro_torch.fl.engine import EngineConfig


def main():
    exp = FLExperiment(
        name="scheduler_comparison",
        constellation=ConstellationConfig(preset="starlink40", days=4.0),
        dataset=DatasetConfig(num_train=6000, num_val=1200, noise=2.2),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="mlp", params={"hidden": 48}),
        scheduler=SchedulerConfig(kind="sync"),
        train=EngineConfig(local_steps=16, client_lr=1.0, eval_every=24,
                           max_windows=384),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24),
    )
    base = Federation.from_experiment(exp)      # on the card
    scheds = [
        SchedulerConfig("sync"),
        SchedulerConfig("async"),
        SchedulerConfig("fedbuff", params={"M": 20}),
        SchedulerConfig("periodic", params={"period": 4}),
        SchedulerConfig("intra_plane"),
        SchedulerConfig("isl_async"),
        SchedulerConfig("fedspace",
                        params={"I0": 24, "n_min": 4, "n_max": 8,
                                "num_candidates": 800},
                        setup={"pretrain_rounds": 30, "clients_per_round": 16,
                               "utility_samples": 150, "local_steps": 16,
                               "client_lr": 1.0}),
    ]
    # build every policy first (FedSpace phase 1 runs here) so the timed
    # loop below compares simulation time only
    feds = [base.with_scheduler(cfg) for cfg in scheds]
    print(f"{'scheme':12s} {'final':>6s} {'best':>6s} {'upd':>5s} "
          f"{'idle':>11s}  staleness histogram (0..8+)")
    for fed in feds:
        t0 = time.time()
        res = fed.run()
        torch.cuda.synchronize()
        print(f"{res.scheme:12s} {res.accuracy[-1]:6.3f} "
              f"{max(res.accuracy):6.3f} {res.num_global_updates:5d} "
              f"{res.idle_connections:5d}/{res.total_connections:5d}  "
              f"{res.staleness_hist.tolist()}  ({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
