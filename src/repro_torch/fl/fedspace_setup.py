"""Wiring for FedSpace's first phase (paper §3.2, Fig. 5), the port of
`repro.fl.fedspace_setup`: pretrain a source trajectory, generate
(staleness-vector, status) -> Δf samples against it (eq. 12), and fit the
utility regressor û used by the schedule search.

The paper uses the same task's dataset as the source D^s (its §4.3
simplification); so does this module — the adapter provides both the
source trajectory training and the client updates. Everything but the
regressor's fit runs on the adapter's device; the fit is numpy on the host
(the forest) or PyTorch on the host (the MLP). As in the reference, the
pretrain and the samples' client updates train every parameter: an
adapter's `trainable_mask` applies to the engine's client updates only.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.utility import (MLPRegressor, RandomForestRegressor,
                                      generate_utility_samples)
from repro_torch.fl.client import make_batched_client_update, \
    make_client_update
from repro_torch.tree import tree_leaves, tree_map


def pretrain_trajectory(adapter, *, rounds: int = 40, clients_per_round: int
                        = 16, local_steps: int = 4, client_lr: float = 0.05,
                        seed: int = 0, batch_size: int = 32) -> List:
    """Simulated ideal-FL trajectory {w^0..w^Imax} on the source dataset:
    each round adds the mean of fresh updates from a random client subset
    (no connectivity constraints — this runs entirely at the GS). The
    initial model is `adapter.init(torch.Generator().manual_seed(seed))`,
    as the engine makes it; the client picks and batches are the
    reference's (`np.random.default_rng(seed)`, round rng 10_000 + r). A
    round's clients train in one batched update per batch shape; a client
    with an empty shard adds a zero update to the mean."""
    rng = np.random.default_rng(seed)
    params = adapter.init(torch.Generator().manual_seed(seed))
    update_many = make_batched_client_update(adapter, local_steps=local_steps,
                                             lr=client_lr)
    K = len(adapter.clients)
    traj = [params]
    for r in range(rounds):
        picks = rng.choice(K, min(clients_per_round, K), replace=False)
        by_shape = {}
        for k in picks:
            b = adapter.client_batch(int(k), 10_000 + r, batch_size,
                                     local_steps)
            if b is not None:
                by_shape.setdefault(tuple(t.shape for t in b), []).append(b)
        total = tree_map(torch.zeros_like, params)
        for batches in by_shape.values():
            upd = update_many(params, tuple(torch.stack(ts)
                                            for ts in zip(*batches)))
            total = tree_map(lambda t, u: t + u.sum(dim=0), total, upd)
        params = tree_map(lambda p, t: p + t / len(picks), params, total)
        traj.append(params)
    return traj


def phase1_samples(adapter, trajectory, *, n_samples: int = 300,
                    s_max: int = 8, clients_per_sample: int = 48,
                    local_steps: int = 4, client_lr: float = 0.05,
                    batch_size: int = 32, seed: int = 0):
    """The eq.-12 samples (X, y) against `trajectory`, generated on the
    adapter's batched machinery: client updates trained in groups by base
    checkpoint, perturbed checkpoints evaluated in batched loss calls on
    `adapter.eval_batch()` (the per-sample loop for adapters without
    one)."""
    client_update = make_client_update(adapter, local_steps=local_steps,
                                       lr=client_lr)

    def upd_fn(base, ci, rng_int):
        # eq. 4 normalization by participating count happens inside
        # generate_utility_samples
        return client_update(base, ci, round_rng=int(rng_int),
                             batch_size=batch_size)

    batched_loss = None
    if hasattr(adapter, "eval_batch"):
        X, y = adapter.eval_batch()

        @torch.no_grad()
        def batched_loss(stacked):
            m = tree_leaves(stacked)[0].shape[0]
            return adapter.loss(stacked, (X.expand(m, *X.shape),
                                          y.expand(m, *y.shape)))

    return generate_utility_samples(
        trajectory, upd_fn, lambda p: adapter.val_loss(p),
        num_clients=len(adapter.clients), n_samples=n_samples, s_max=s_max,
        clients_per_sample=clients_per_sample, seed=seed,
        batch_fn=lambda ci, rng_int: adapter.client_batch(
            ci, int(rng_int), batch_size, local_steps),
        batched_update_fn=make_batched_client_update(
            adapter, local_steps=local_steps, lr=client_lr),
        batched_loss_fn=batched_loss)


def fit_utility_regressor(adapter, trajectory, *, kind: str = "rf",
                          n_samples: int = 300, s_max: int = 8,
                          clients_per_sample: int = 48,
                          local_steps: int = 4, client_lr: float = 0.05,
                          batch_size: int = 32, seed: int = 0):
    """Generate the eq.-12 samples and fit û ("rf": the random forest,
    else the MLP). Returns (regressor, diagnostics: r2_in_sample, n,
    y_mean, y_std)."""
    X, y = phase1_samples(adapter, trajectory, n_samples=n_samples,
                          s_max=s_max, clients_per_sample=clients_per_sample,
                          local_steps=local_steps, client_lr=client_lr,
                          batch_size=batch_size, seed=seed)
    reg = (RandomForestRegressor(seed=seed) if kind == "rf"
           else MLPRegressor(seed=seed))
    reg.fit(X, y)
    # in-sample fit quality (diagnostic)
    pred = reg.predict(X)
    ss = 1.0 - np.sum((pred - y) ** 2) / max(np.sum((y - y.mean()) ** 2),
                                             1e-12)
    return reg, {"r2_in_sample": float(ss), "n": len(y),
                 "y_mean": float(y.mean()), "y_std": float(y.std())}


def build_utility_regressor(adapter, *, regressor_kind="rf",
                            pretrain_rounds=40, utility_samples=250,
                            local_steps=16, client_lr=1.0,
                            clients_per_round=24, clients_per_sample=48,
                            s_max=8, seed=0):
    """Phase 1 alone (the expensive part): pretrain the source trajectory
    and fit û. Returns (regressor, diagnostics) so callers comparing
    several FedSpace schedule configurations can reuse one regressor."""
    traj = pretrain_trajectory(adapter, rounds=pretrain_rounds,
                               clients_per_round=clients_per_round,
                               local_steps=local_steps,
                               client_lr=client_lr, seed=seed)
    return fit_utility_regressor(adapter, traj, kind=regressor_kind,
                                 n_samples=utility_samples, s_max=s_max,
                                 clients_per_sample=clients_per_sample,
                                 local_steps=local_steps,
                                 client_lr=client_lr, seed=seed)


def build_fedspace_scheduler(adapter, *, I0=24, n_min=None, n_max=None,
                             num_candidates=5000, s_max=8, seed=0,
                             **setup_kw):
    """Full phase-1 wiring: pretrain the source trajectory, fit û, and
    return the configured FedSpace scheduler plus the regressor
    diagnostics; extra keywords go to `build_utility_regressor`."""
    reg, diag = build_utility_regressor(adapter, s_max=s_max, seed=seed,
                                        **setup_kw)
    sched = make_scheduler("fedspace", regressor=reg, I0=I0, n_min=n_min,
                           n_max=n_max, num_candidates=num_candidates,
                           s_max=s_max, seed=seed)
    return sched, diag
