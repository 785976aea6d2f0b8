"""Part A of examples/satellite_fl_train.py on the PyTorch port: the
paper's experiment end to end on the card. A DenseNet-style CNN (the
paper's model family, its lower block frozen) is federated across 48
satellites under the FedSpace scheduler over simulated connectivity,
through `repro_torch.fl.Federation.from_experiment(exp).run()`: phase 1
(pretrain, eq.-12 samples, the utility forest) and the run on one CUDA
device, the aggregations in the port's eq.-4 kernel.

Part B of the reference example (pretraining mamba2-370m) needs the model
zoo and the launch layer, which the port does not have yet (ROADMAP
A.11); this script runs Part A only.

Run:  PYTHONPATH=src python examples/satellite_fl_train_torch.py
"""
import time

from repro_torch.fl import (AdapterConfig, ConstellationConfig,
                            DatasetConfig, EngineConfig, FLExperiment,
                            Federation, PartitionConfig, SchedulerConfig)


def part_a():
    print("=== Part A: federated DenseNet (the paper's model family) ===")
    t0 = time.time()
    exp = FLExperiment(
        name="satellite_fl_densenet",
        constellation=ConstellationConfig(num_satellites=48, days=2.0),
        dataset=DatasetConfig(num_train=3000, num_val=600, image_size=16,
                              noise=1.0),
        partition=PartitionConfig(kind="noniid"),
        adapter=AdapterConfig(kind="densenet",
                              params={"growth": 8, "blocks": (2, 2, 2),
                                      "stem": 16,
                                      "frozen_blocks": 1}),  # paper §4.1
        scheduler=SchedulerConfig(
            kind="fedspace",
            params={"I0": 24, "n_min": 4, "n_max": 8,
                    "num_candidates": 300},
            setup={"pretrain_rounds": 10, "clients_per_round": 8,
                   "utility_samples": 40, "clients_per_sample": 6,
                   "local_steps": 8, "client_lr": 0.3}),
        train=EngineConfig(local_steps=8, client_lr=0.3, eval_every=24,
                           max_windows=144),
    )
    fed = Federation.from_experiment(exp)      # on the card
    print(f"utility regressor "
          f"R^2={fed.scheduler_diag['r2_in_sample']:.2f}")
    res = fed.run()
    # the compact CNN on noisy synthetic imagery needs thousands of local
    # steps to climb (chance = 1.6%); this 1.5-simulated-day run shows the
    # paper's pipeline end to end
    print(f"accuracy curve: {[round(a, 3) for a in res.accuracy]}")
    print(f"global updates: {res.num_global_updates}, "
          f"aggregated gradients: {res.num_aggregated_gradients}")
    print(f"Part A done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    part_a()
