"""examples/isl_comparison.py on the PyTorch port: does letting
satellites talk to each other help, and when?

Races the two ISL policies — `intra_plane` (ring relay toward elected
sink satellites, arXiv 2302.13447) and `isl_async` (asynchronous gossip
over ring neighbours, arXiv 2206.00307) — against the ground-only
baselines (fedbuff, sync) on the flock191 mix and the starlink40 preset,
under the dense 12-station network and single-station Svalbard, with and
without a finite link budget. Each cell shares one world on the card
(constellation, data, adapter, ISL topology) through
`Federation.with_scheduler`, so differences are pure policy.

Run:  PYTHONPATH=src python examples/isl_comparison_torch.py
"""
import dataclasses
import time

import torch

from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                FLExperiment, Federation, ISLConfig,
                                LinkConfig, SchedulerConfig)
from repro_torch.fl.engine import EngineConfig

SCHEDULERS = [
    SchedulerConfig("fedbuff", params={"M": 12}),
    SchedulerConfig("sync"),
    SchedulerConfig("intra_plane"),
    SchedulerConfig("isl_async"),
]


def main():
    base = FLExperiment(
        name="isl_comparison",
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 12}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=192),
        # 600 MB model over 100 Mbit/s laser crosslinks: one ring hop per
        # window; sinks re-elected every 6 simulated hours
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24),
    )
    budget = LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=1)

    print(f"{'preset':10s} {'ground':8s} {'links':7s} {'scheme':12s} "
          f"{'idle%':>6s} {'upd':>4s} {'grads':>6s} "
          f"{'final':>6s}")
    for preset in ("flock191", "starlink40"):
        for ground in ("dense12", "sparse1"):
            for label, link in (("free", LinkConfig()), ("budget", budget)):
                exp = dataclasses.replace(
                    base,
                    constellation=ConstellationConfig(
                        preset=preset, ground=ground, days=2.0),
                    link=link)
                world = Federation.from_experiment(exp)     # on the card
                for cfg in SCHEDULERS:
                    t0 = time.time()
                    res = world.with_scheduler(cfg).run()
                    torch.cuda.synchronize()
                    idle = (100.0 * res.idle_connections
                            / max(res.total_connections, 1))
                    print(f"{preset:10s} {ground:8s} {label:7s} "
                          f"{res.scheme:12s} {idle:6.1f} "
                          f"{res.num_global_updates:4d} "
                          f"{res.num_aggregated_gradients:6d} "
                          f"{res.accuracy[-1]:6.3f}  "
                          f"({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
