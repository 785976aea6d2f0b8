"""Back-compat entry point for the FL simulation; the port of
`repro.fl.simulation`.

The protocol loop lives in `repro_torch.fl.engine.SimulationEngine`;
`run_simulation` is the thin keyword wrapper around it that pre-engine
call sites use. Prefer the declarative layer for new code:

    from repro_torch.fl.api import FLExperiment, Federation
    result = Federation.from_experiment(FLExperiment(...)).run()
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.scheduler import Scheduler
from repro_torch.fl.engine import (EngineConfig, SimResult, SimulationEngine,
                                   T0_MINUTES)

__all__ = ["run_simulation", "SimResult", "SimulationEngine",
           "EngineConfig", "T0_MINUTES"]


def run_simulation(C: np.ndarray, adapter, scheduler: Scheduler, *,
                   local_steps: int = 4, batch_size: int = 32,
                   client_lr: float = 0.05, server_lr: float = 1.0,
                   alpha: float = 0.5, eval_every: int = 8,
                   target_acc: Optional[float] = None,
                   max_windows: Optional[int] = None,
                   repeat_connectivity: int = 1,
                   s_max: int = 8, seed: int = 0,
                   init_params=None, stop_at_target: bool = True,
                   uplink_topk: float = 0.0, device=None,
                   ) -> SimResult:
    """Run one scheme over the connectivity sequence C (I, K) on `device`
    (None means "cuda", and raises when no CUDA device is present; the
    adapter must live there). `uplink_topk` > 0 raises the client
    update's NotImplementedError when the run starts (the compression
    slice)."""
    config = EngineConfig(
        local_steps=local_steps, batch_size=batch_size,
        client_lr=client_lr, server_lr=server_lr, alpha=alpha,
        eval_every=eval_every, target_acc=target_acc,
        max_windows=max_windows,
        # legacy semantics: values <= 1 never tiled (0 is NOT the engine's
        # auto-tile sentinel here)
        repeat_connectivity=max(1, repeat_connectivity),
        s_max=s_max, seed=seed, stop_at_target=stop_at_target,
        uplink_topk=uplink_topk)
    return SimulationEngine(C, adapter, scheduler, config,
                            init_params=init_params, device=device).run()
