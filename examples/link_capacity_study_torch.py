"""examples/link_capacity_study.py on the PyTorch port: the same
constellation and protocol over the dense 12-station network and the
single-station Svalbard network, with and without finite link budgets,
each run on the card.

With finite uplink/downlink rates, a real model size and one concurrent
contact per station (`LinkConfig`), the sparse network turns contacts
away at the saturated station and stretches every transfer over several
passes: fewer aggregated gradients, staler ones. `blocked` is the share
of geometric contacts turned away (`LinkBudget.blocked_fraction`).

Run:  PYTHONPATH=src python examples/link_capacity_study_torch.py
"""
import dataclasses
import time

import torch

from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                FLExperiment, Federation, LinkConfig,
                                SchedulerConfig)
from repro_torch.fl.engine import EngineConfig


def main():
    base = FLExperiment(
        name="link_capacity_study",
        constellation=ConstellationConfig(preset="starlink40", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 10}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=192),
    )
    # a 600 MB model over a 20 Mbit/s uplink needs 4 sixty-second contact
    # units, and each ground station serves one satellite at a time
    budget = LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=1)

    print(f"{'ground':8s} {'links':12s} {'blocked':>7s} {'idle':>11s} "
          f"{'upd':>4s} {'grads':>6s}  staleness histogram (0..8+)")
    for ground in ("dense12", "sparse1"):
        for label, link in (("free", LinkConfig()), ("budget", budget)):
            exp = dataclasses.replace(
                base,
                constellation=dataclasses.replace(base.constellation,
                                                  ground=ground),
                link=link)
            t0 = time.time()
            fed = Federation.from_experiment(exp)       # on the card
            res = fed.run()
            torch.cuda.synchronize()
            blocked = (f"{fed.link_budget.blocked_fraction():7.2f}"
                       if fed.link_budget is not None else "      -")
            print(f"{ground:8s} {label:12s} {blocked} "
                  f"{res.idle_connections:4d}/{res.total_connections:6d} "
                  f"{res.num_global_updates:4d} "
                  f"{res.num_aggregated_gradients:6d}  "
                  f"{res.staleness_hist.tolist()}  "
                  f"({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
