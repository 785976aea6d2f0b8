"""examples/fault_study.py on the PyTorch port: how gracefully does each
scheduler degrade when the world stops cooperating?

FedSpace plans on *deterministic* connectivity (§3.1). This study breaks
that premise the three ways production constellations do — satellites
deorbit mid-run (escalating churn), the whole ground network goes dark
for a stretch (blackout), and weather scales the link rates (degraded
passes) — and races sync / fedbuff / FedSpace / intra-plane sinks over
the same faulted worlds. Faults are *blind* by default: the schedulers
and the schedule search plan on the clean world while the engine
executes the faulted one. The final block flips FedSpace to the `oracle`
view (planning sees the faults).

The base world is built once on the card (`Federation.from_experiment`,
clean) and every scenario derives from it through
`Federation.with_faults`: the constellation, contact artifacts, data,
adapter, ISL topology and FedSpace's phase 1 are shared, only the fault
trace changes. The sweepable (scenario x policy) cells run through
`repro_torch.fl.sweep.run_sweep`, a group of variants at a time on the
card; their protocol counters equal the sequential runs'. FedSpace
re-plans mid-run and runs sequentially. Sweep rows report protocol-level
degradation (idle share, update counts, staleness); accuracy shows `—`
because the sweep does not train models.

Run:  PYTHONPATH=src python examples/fault_study_torch.py
"""
import time

import torch

from repro_torch.core.faults import random_churn, station_blackout
from repro_torch.fl.api import (ConstellationConfig, DatasetConfig,
                                FaultConfig, FLExperiment, Federation,
                                ISLConfig, LinkConfig, SchedulerConfig)
from repro_torch.fl.engine import EngineConfig
from repro_torch.fl.sweep import run_sweep

K, G, WINDOWS = 40, 12, 192          # starlink40 over dense12, 2 days

SWEEPABLE = [
    SchedulerConfig("sync"),
    SchedulerConfig("fedbuff", params={"M": 10}),
    SchedulerConfig("intra_plane", params={"M": 10}),
]
FEDSPACE = SchedulerConfig(
    "fedspace",
    params={"I0": 24, "n_min": 4, "n_max": 8, "num_candidates": 512},
    setup={"pretrain_rounds": 10, "clients_per_round": 12,
           "utility_samples": 60, "local_steps": 8, "client_lr": 1.0})

SCENARIOS = [
    ("clean", FaultConfig()),
    ("churn20", FaultConfig(deorbit=random_churn(K, WINDOWS, 0.20, seed=0))),
    ("churn40", FaultConfig(deorbit=random_churn(K, WINDOWS, 0.40, seed=0))),
    ("blackout", FaultConfig(outages=station_blackout(G, 64, 128))),
    ("weather", FaultConfig(rate_scale_min=0.25, rate_scale_max=1.0,
                            seed=1)),
]


def _row(scenario, res, note=""):
    idle = 100.0 * res.idle_connections / max(res.total_connections, 1)
    hist = res.staleness_hist
    n_agg = max(int(hist.sum()), 1)
    stale = sum(s * int(n) for s, n in enumerate(hist)) / n_agg
    final = f"{res.accuracy[-1]:6.3f}" if len(res.accuracy) else f"{'—':>6s}"
    return (f"{scenario:9s} {res.scheme:12s} {idle:6.1f} "
            f"{res.num_global_updates:4d} "
            f"{res.num_aggregated_gradients:6d} {stale:6.2f} "
            f"{final}{note}")


def main():
    base = FLExperiment(
        name="fault_study",
        constellation=ConstellationConfig(preset="starlink40",
                                          ground="dense12", days=2.0),
        dataset=DatasetConfig(num_train=4000, num_val=800, noise=2.2),
        scheduler=SchedulerConfig(kind="fedbuff", params={"M": 10}),
        train=EngineConfig(local_steps=8, client_lr=1.0, eval_every=48,
                           max_windows=WINDOWS),
        link=LinkConfig(uplink_mbps=20.0, downlink_mbps=100.0,
                        model_mb=600.0, gs_capacity=2),
        isl=ISLConfig(isl_mbps=100.0, model_mb=600.0, epoch=24),
    )
    clean = Federation.from_experiment(base)              # on the card
    worlds = {name: clean.with_faults(faults) for name, faults in SCENARIOS}

    # every sweepable (scenario x policy) cell through one batched sweep
    cells = [(name, cfg) for name, _ in SCENARIOS for cfg in SWEEPABLE]
    t0 = time.time()
    results = run_sweep(
        [worlds[name].with_scheduler(cfg) for name, cfg in cells])
    swept = {(name, cfg.kind): res
             for (name, cfg), res in zip(cells, results)}
    t_sweep = time.time() - t0
    print(f"# {len(cells)} sweepable cells in one batched sweep "
          f"({t_sweep:.0f}s); fedspace replans mid-run and stays "
          f"sequential\n")

    print(f"{'scenario':9s} {'scheme':12s} {'idle%':>6s} {'upd':>4s} "
          f"{'grads':>6s} {'stale':>6s} {'final':>6s}")
    for scenario, _ in SCENARIOS:
        for cfg in SWEEPABLE[:2]:
            print(_row(scenario, swept[(scenario, cfg.kind)]))
        t0 = time.time()
        res = worlds[scenario].with_scheduler(FEDSPACE).run()
        torch.cuda.synchronize()
        print(f"{_row(scenario, res)}  ({time.time() - t0:.0f}s)")
        print(_row(scenario, swept[(scenario, SWEEPABLE[2].kind)]))

    # what would perfect fault knowledge buy? FedSpace re-planned against
    # the *faulted* connectivity (oracle) vs the clean plan above (blind)
    print("\nfedspace under churn40, blind vs oracle planning:")
    for label, oracle in (("blind", False), ("oracle", True)):
        faults = FaultConfig(
            deorbit=random_churn(K, WINDOWS, 0.40, seed=0), oracle=oracle)
        t0 = time.time()
        res = clean.with_faults(faults).with_scheduler(FEDSPACE).run()
        torch.cuda.synchronize()
        print(f"{_row(label, res)}  ({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
