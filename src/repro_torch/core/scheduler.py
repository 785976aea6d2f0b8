"""Aggregation schedulers — the indicator a^i policies of Algorithm 1.

Sync (eq. 5), Async (eq. 6), FedBuff (eq. 7) and a periodic baseline,
behind one interface so the engine (`repro_torch.fl.engine`) is
policy-agnostic. The port runs the per-window host loop, so a scheduler
answers through `decide` alone (the reference's `device_plan` feeds its
chunked fast loop, which the port does not have yet). FedSpace (§3) comes
with a later slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import staleness as SS
from repro_torch.fl.registry import SCHEDULERS, register_scheduler


class Scheduler:
    """Aggregation-policy interface: the indicator a^i of Algorithm 1,
    asked once per window through `decide`. Schedulers are registered by
    name (`repro_torch.fl.registry.SCHEDULERS`) and built with
    `make_scheduler`."""
    name = "base"

    def reset(self):
        """Clear per-run state. The engine calls this once in `prepare()`;
        stateless schedulers need not override it."""
        pass

    def decide(self, i: int, *, n_in_buffer: int, K: int, state: SS.SatState,
               ig: int, connectivity: np.ndarray, status: float,
               link=None) -> bool:
        """The aggregation indicator a^i, asked once per window (after the
        window's uploads).

        Args:
          i: absolute window index.
          n_in_buffer: GS buffer occupancy after this window's uploads.
          K: constellation size.
          state: the post-upload `SatState` on the run's device (read-only).
          ig: current global version.
          connectivity: the full (num_windows, K) bool matrix.
          status: training status T (val loss at the last eval).
          link: always None in the port so far (link budgets come with a
            later slice); kept so schedulers share the reference's
            signature.

        Returns True to aggregate at this window (the engine additionally
        requires a non-empty buffer).
        """
        raise NotImplementedError


@register_scheduler("sync")
class SyncScheduler(Scheduler):
    """Wait for every satellite (FedAvg round over the full constellation)."""
    name = "sync"

    def decide(self, i, *, n_in_buffer, K, **_):
        return n_in_buffer >= K


@register_scheduler("async")
class AsyncScheduler(Scheduler):
    """Aggregate whenever anything is in the buffer."""
    name = "async"

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer > 0


@register_scheduler("fedbuff")
class FedBuffScheduler(Scheduler):
    """Aggregate once the buffer reaches M (Nguyen et al. 2021)."""
    name = "fedbuff"

    def __init__(self, M: int = 96):
        self.M = M

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer >= self.M


@register_scheduler("periodic")
class PeriodicScheduler(Scheduler):
    """Beyond-paper baseline: aggregate every P windows regardless of buffer
    content (a 'cron' server)."""
    name = "periodic"

    def __init__(self, period: int = 4):
        self.period = period

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer > 0 and (i + 1) % self.period == 0


def make_scheduler(name: str, **kw) -> Scheduler:
    """Build a registered scheduler by name. Unknown names raise a KeyError
    listing what is registered (see repro_torch.fl.registry)."""
    return SCHEDULERS.build(name, **kw)
