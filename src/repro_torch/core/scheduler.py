"""Aggregation schedulers — the indicator a^i policies of Algorithm 1.

Sync (eq. 5), Async (eq. 6), FedBuff (eq. 7), a periodic baseline,
FedSpace (§3: every I0 windows, an eq.-13 random search against the
utility regressor û) and the two ISL policies (sink relaying,
`intra_plane`; gossip, `isl_async`), behind one interface so the engine
(`repro_torch.fl.engine`) is policy-agnostic. The engine runs the
per-window host loop and asks `decide`. The policies whose indicator
holds for the whole run also offer `device_plan`: a module-level torch
indicator and its arguments, which the batched sweep
(`repro_torch.fl.sweep`) evaluates on the device for a whole group of
variants at once (the reference's contract with ``horizon=None``; the
engine's chunked loop over it is ROADMAP A.8).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import isl as ISL
from repro_torch.core import search as SR
from repro_torch.core import staleness as SS
from repro_torch.fl.registry import SCHEDULERS, register_scheduler


# Device-side aggregation indicators, evaluated by the sweep once per
# window for a whole group of variants. Module-level (stable identity), so
# variants of one kind share one group; instance knobs (K, M, the period)
# travel in `args`. `n_buf` and `args` may carry a leading variant axis, and
# `t` is the absolute window index.

def _sync_indicator(t, n_buf, args):
    return n_buf >= args                       # args = K


def _async_indicator(t, n_buf, args):
    return n_buf > 0


def _fedbuff_indicator(t, n_buf, args):
    return n_buf >= args                       # args = M


def _periodic_indicator(t, n_buf, args):
    return (n_buf > 0) & ((t + 1) % args == 0)  # args = period


def _int32(x):
    return torch.tensor(x, dtype=torch.int32)


class Scheduler:
    """Aggregation-policy interface: the indicator a^i of Algorithm 1,
    asked once per window through `decide`. Schedulers are registered by
    name (`repro_torch.fl.registry.SCHEDULERS`) and built with
    `make_scheduler`.

    `isl_mode` declares the ISL transition the policy is built on —
    ``"sink"`` (intra-plane relay toward elected sink satellites),
    ``"gossip"`` (asynchronous neighbour version exchange) or None
    (ground-only). The engine activates it only when the run also carries
    an ISL runtime (`repro_torch.core.isl.ISL`, from `FLExperiment.isl`),
    and binds that runtime to the `isl` attribute before `reset()`;
    ground-only schedulers in an ISL world run the unmodified protocol."""
    name = "base"
    isl_mode = None      # "sink" | "gossip" | None (ground-only)
    isl = None           # the resolved ISL runtime, bound by the engine
    # True for a policy that re-plans mid-run against the training status
    # (FedSpace): no device plan holds for the rest of its run
    replans = False

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
          connectivity: the full (num_windows, K) bool matrix — under a
            link budget the effective (served) one.
          status: training status T (val loss at the last eval).
          link: the run's `LinkGate` (grant (num_windows, K) host array
            and the unit needs) when the run models a link budget, else
            None; schedulers that simulate the future (FedSpace) gate
            their simulation with it.

        Returns True to aggregate at this window (the engine additionally
        requires a non-empty buffer).
        """
        raise NotImplementedError

    def device_plan(self, i: int, *, K: int, state: SS.SatState, ig: int,
                    connectivity: np.ndarray, status: float, link=None,
                    **_):
        """``(indicator_fn, args, None)`` when one device-side indicator
        decides every window from `i` to the end of the run, else None
        (the default: the policy answers through `decide` alone).
        ``indicator_fn(t, n_buf, args)`` is a module-level torch function
        (its identity groups the sweep's variants); `args` a tree of int32
        tensors, stacked over the variants of a group; `t` the absolute
        window and `n_buf` the post-upload buffer occupancy, both possibly
        with a leading variant axis. Its decisions equal `decide`'s for
        the same windows. Keywords as `decide`'s (the plan view, under a
        blind fault trace)."""
        return None


@register_scheduler("sync")
class SyncScheduler(Scheduler):
    """Wait for every satellite (FedAvg round over the full constellation)."""
    name = "sync"

    def decide(self, i, *, n_in_buffer, K, **_):
        return n_in_buffer >= K

    def device_plan(self, i, *, K, **_):
        return _sync_indicator, _int32(K), None


@register_scheduler("async")
class AsyncScheduler(Scheduler):
    """Aggregate whenever anything is in the buffer."""
    name = "async"

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer > 0

    def device_plan(self, i, **_):
        return _async_indicator, _int32(0), None


@register_scheduler("fedbuff")
class FedBuffScheduler(Scheduler):
    """Aggregate once the buffer reaches M (Nguyen et al. 2021)."""
    name = "fedbuff"

    def __init__(self, M: int = 96):
        self.M = M

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer >= self.M

    def device_plan(self, i, **_):
        return _fedbuff_indicator, _int32(self.M), None


@register_scheduler("periodic")
class PeriodicScheduler(Scheduler):
    """Beyond-paper baseline: aggregate every P windows regardless of buffer
    content (a 'cron' server)."""
    name = "periodic"

    def __init__(self, period: int = 4):
        self.period = period

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer > 0 and (i + 1) % self.period == 0

    def device_plan(self, i, **_):
        return _periodic_indicator, _int32(self.period), None


@register_scheduler("fedspace")
class FedSpaceScheduler(Scheduler):
    """The paper's scheduler: every I0 windows, random-search a schedule for
    the next I0 windows against the utility regressor û, using the known
    future connectivity and current protocol state (eq. 13). The search
    runs on the device of the engine's protocol state.

    `n_min`/`n_max` None are inferred from û (`infer_n_range`, paper
    §3.2) at each re-plan. The scheduler's rng (`np.random.default_rng(
    seed)`) is drawn by `random_candidates` alone, once per re-plan, so
    the candidate pools are the reference's. Under a link budget the
    search rolls the candidates through the same per-window grants the
    engine applies. It re-plans mid-run against the training status, so
    it offers no device plan and the sweep refuses it (`replans`). The
    replan service (`service=`) raises NotImplementedError (the
    replanning slice, ROADMAP A.10)."""
    name = "fedspace"
    replans = True

    def __init__(self, regressor, *, I0: int = 24, n_min: int = None,
                 n_max: int = None, num_candidates: int = 5000,
                 s_max: int = 8, seed: int = 0, service=None):
        if service is not None:
            raise SR._later("the replan service (FedSpaceScheduler(service="
                         "...))", "replanning")
        self.regressor = regressor
        self.I0 = I0
        self.n_min = n_min       # None => inferred from û (paper §3.2)
        self.n_max = n_max
        self.num_candidates = num_candidates
        self.s_max = s_max
        self.seed = seed
        self.reset()

    def reset(self):
        self._rng = np.random.default_rng(self.seed)
        self._schedule: Optional[np.ndarray] = None
        self._window_start = -1

    def _window_link(self, link, i):
        """Slice the run-level link gate to the planning window [i, i+I0),
        zero-padding the horizon tail like the connectivity slice."""
        if link is None:
            return None
        Gw = np.asarray(link.grant)[i:i + self.I0]
        if Gw.shape[0] < self.I0:
            Gw = np.concatenate(
                [Gw, np.zeros((self.I0 - Gw.shape[0], Gw.shape[1]),
                              Gw.dtype)], axis=0)
        return SS.LinkGate(Gw, link.need_up, link.need_dn)

    @staticmethod
    def _search_state(state, i, *, connectivity, link):
        """Invert window i's already-applied upload-grant accumulation.

        The search receives the *post-upload* state at window i (what
        `decide` sees) and its rollout re-simulates window i from the top,
        upload included. Without gating that re-run is idempotent: every
        connected pending update already left for the buffer. With gating
        a mid-upload satellite keeps `pending`, and its `progress` already
        holds window i's grant: the rollout would add it a second time and
        predict every in-flight upload one grant early. Subtracting the
        grant from exactly the connected satellites that are still
        pending (completed uploads reset progress and drop pending) makes
        the rollout's `upload_step` land on the engine's state."""
        if link is None or state.progress is None:
            return state
        device = state.progress.device
        conn = torch.as_tensor(np.asarray(connectivity[i], bool),
                               device=device)
        grant = torch.as_tensor(np.asarray(link.grant[i]),
                                dtype=state.progress.dtype, device=device)
        undo = torch.where(conn & (state.pending >= 0), grant, 0)
        return state._replace(progress=state.progress - undo)

    def _ensure_schedule(self, i, *, state, ig, connectivity, status,
                         link=None):
        """(Re-)plan at I0 boundaries (eq. 13). `state` must be the
        post-upload state at window i — that is what `decide` receives from
        the engine, and what the search's simulator assumes. Under a link
        budget `connectivity` is the effective matrix and the rollouts are
        gated by the grants of `link`."""
        if self._schedule is not None and \
                (i % self.I0 != 0 or self._window_start == i):
            return
        Cw = connectivity[i:i + self.I0]
        if Cw.shape[0] < self.I0:   # pad the tail of the horizon
            pad = np.zeros((self.I0 - Cw.shape[0], Cw.shape[1]), bool)
            Cw = np.concatenate([Cw, pad], axis=0)
        n_min, n_max = self.n_min, self.n_max
        if n_min is None or n_max is None:
            inf_min, inf_max = SR.infer_n_range(
                self.regressor, float(Cw.mean(axis=1).sum()) / self.I0
                * Cw.shape[1], self.I0, status, s_max=self.s_max,
                K=Cw.shape[1])
            n_min = n_min if n_min is not None else inf_min
            n_max = n_max if n_max is not None else inf_max
        search_state = self._search_state(state, i,
                                          connectivity=connectivity,
                                          link=link)
        self._schedule = SR.fedspace_search(
            self._rng, Cw, search_state, ig, self.regressor, status,
            n_min=n_min, n_max=n_max, num_candidates=self.num_candidates,
            s_max=self.s_max, link=self._window_link(link, i))
        self._window_start = i

    def decide(self, i, *, n_in_buffer, K, state, ig, connectivity, status,
               link=None, **_):
        self._ensure_schedule(i, state=state, ig=ig,
                              connectivity=connectivity, status=status,
                              link=link)
        a = bool(self._schedule[i - self._window_start])
        return a and n_in_buffer > 0


@register_scheduler("intra_plane")
class IntraPlaneScheduler(Scheduler):
    """Sink-satellite scheduling over intra-plane ISLs (arXiv 2302.13447):
    every plane relays its members' updates along the ring to an elected
    sink, which uplinks them in one ground pass; the GS aggregates once
    every *reachable* satellite's update has arrived.

    `M` overrides the aggregation threshold; the default (None) resolves
    it, once, to the number of satellites in planes with at least one
    effective ground contact over the run (`isl.reachable_count` on the
    connectivity `decide` receives) — a sync barrier over the satellites
    that can contribute at all. Without an ISL runtime the scheduler is a
    sync-over-K barrier on physical contacts."""
    name = "intra_plane"
    isl_mode = "sink"

    def __init__(self, M: Optional[int] = None):
        self.M = M
        self.reset()

    def reset(self):
        self._M_resolved: Optional[int] = None

    def _threshold(self, connectivity, K) -> int:
        if self.M is not None:
            return self.M
        if self._M_resolved is None:
            if self.isl is None:
                self._M_resolved = K
            else:
                self._M_resolved = max(
                    ISL.reachable_count(self.isl.topology, connectivity), 1)
        return self._M_resolved

    def decide(self, i, *, n_in_buffer, K, connectivity, **_):
        return n_in_buffer >= self._threshold(connectivity, K)

    def device_plan(self, i, *, K, connectivity, **_):
        return _fedbuff_indicator, \
            _int32(self._threshold(connectivity, K)), None


@register_scheduler("isl_async")
class IslAsyncScheduler(Scheduler):
    """Asynchronous FL over intra-plane gossip (arXiv 2206.00307): ring
    neighbours exchange models between ground contacts (the engine's
    gossip transition), satellites upload at their own physical contacts,
    and the GS aggregates as soon as `M` updates are buffered (default 1,
    fully asynchronous). The gossip hop period comes from the run's
    `ISLConfig`."""
    name = "isl_async"
    isl_mode = "gossip"

    def __init__(self, M: int = 1):
        self.M = max(int(M), 1)

    def decide(self, i, *, n_in_buffer, **_):
        return n_in_buffer >= self.M

    def device_plan(self, i, **_):
        return _fedbuff_indicator, _int32(self.M), None


def make_scheduler(name: str, **kw) -> Scheduler:
    """Build a registered scheduler by name. Unknown names raise a KeyError
    listing what is registered (see repro_torch.fl.registry)."""
    return SCHEDULERS.build(name, **kw)
