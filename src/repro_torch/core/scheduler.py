"""Aggregation schedulers — the indicator a^i policies of Algorithm 1.

Sync (eq. 5), Async (eq. 6), FedBuff (eq. 7), a periodic baseline,
FedSpace (§3: every I0 windows, an eq.-13 random search against the
utility regressor û) and the two ISL policies (sink relaying,
`intra_plane`; gossip, `isl_async`), behind one interface so the engine
(`repro_torch.fl.engine`) is policy-agnostic. Every policy answers
`decide`, once a window, on the engine's host loop. Every policy here
also offers `device_plan`: a module-level torch indicator, its
arguments and the horizon over which they hold, which the engine's
chunked fast loop evaluates on the device inside its window scans
(`SimulationEngine._run_chunk`) and the batched sweep
(`repro_torch.fl.sweep`) for a whole group of variants at once. FedSpace's
plan holds until its next re-plan, the others' to the end of the run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import isl as ISL
from repro_torch.core import search as SR
from repro_torch.core import staleness as SS
from repro_torch.fl.registry import SCHEDULERS, register_scheduler


# Device-side aggregation indicators, evaluated once a window inside the
# engine's window scans (`t` a 0-d int32 tensor on the run's device) and
# by the sweep for a whole group of variants (`t` a Python int, `n_buf`
# and `args` with a leading variant axis). Module-level (stable identity),
# so each is one key of the engine's captured graphs and variants of one
# kind share one sweep group; instance knobs (K, M, the period, FedSpace's
# schedule) travel in `args`. No indicator reads the device.

def _sync_indicator(t, n_buf, args):
    return n_buf >= args                       # args = K


def _async_indicator(t, n_buf, args):
    return n_buf > 0


def _fedbuff_indicator(t, n_buf, args):
    return n_buf >= args                       # args = M


def _periodic_indicator(t, n_buf, args):
    return (n_buf > 0) & ((t + 1) % args == 0)  # args = period


def _fedspace_indicator(t, n_buf, args):
    sched, start = args            # the (I0,) schedule and its first window
    # a bucketed scan runs padding windows past the plan's horizon: clamp
    # the index into the schedule (the reference's gather clamps), the
    # scan's `live` mask discards what they decide
    idx = (t - start).clamp(0, sched.shape[-1] - 1).long()
    return torch.take(sched, idx) > 0


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
    # the run's satellite-axis mesh (repro_torch.core.mesh), bound by the
    # engine before reset(); a scheduler that simulates on the device
    # (FedSpace's eq.-13 search) shards it over the run's mesh
    mesh = None
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
        """``(indicator_fn, args, horizon)`` when one device-side indicator
        decides every window of ``[i, i + horizon)`` (``horizon=None``:
        to the end of the run), else None (the default: the engine then
        runs window `i` on its host loop and asks `decide`).

        Contract (the reference's):
          * ``indicator_fn(t, n_buf, args)`` is a module-level torch
            function: its identity is a key of the engine's captured
            graphs and of the sweep's groups, so a fresh closure per call
            would capture a graph per chunk; per-instance knobs travel in
            `args`, a tree of int32 tensors;
          * `t` is the absolute window (a 0-d int32 device tensor in the
            engine's scans, an int in the sweep) and `n_buf` the
            post-upload buffer occupancy, both possibly with a leading
            variant axis (the sweep). The function reads nothing from the
            device (no `.item()`, no Python `if` on a tensor), and an index
            it takes from `t` is clamped: a bucketed scan runs padding
            windows past the horizon, whose decisions it discards;
          * its decisions equal `decide`'s for the same windows: the two
            execution strategies give the same bits;
          * the hook may do host work first: FedSpace re-plans here,
            simulating the boundary window's upload so the search sees
            the post-upload state `decide` would.

        Keywords as `decide`'s (the plan view, under a blind fault trace).
        Under a fault trace the engine also passes `exec_connectivity` and
        `exec_link`, the executed world, for a hook that simulates the
        boundary window's upload (hence the ``**_``)."""
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
    engine applies. Its `device_plan` (the reference's) re-plans at each
    I0 boundary and holds the schedule until the next one, so the
    engine's fast loop runs it; it re-plans mid-run against the training
    status, so the sweep refuses it (`replans`).

    `service` (a `repro_torch.fl.replan.ReplanService` with the same I0,
    s_max and pool size) routes every re-plan through the service: the
    same draw (the scheduler's rng), scorer and selection, so the
    schedules are the unrouted ones, while the service keeps its rollout
    cache and regressor across requests."""
    name = "fedspace"
    replans = True

    def __init__(self, regressor, *, I0: int = 24, n_min: int = None,
                 n_max: int = None, num_candidates: int = 5000,
                 s_max: int = 8, seed: int = 0, service=None):
        if service is not None and (service.I0 != I0
                                    or service.s_max != s_max
                                    or service.num_candidates
                                    != num_candidates):
            raise ValueError(
                "ReplanService knobs must match the scheduler: service "
                f"(I0={service.I0}, s_max={service.s_max}, "
                f"R={service.num_candidates}) vs scheduler (I0={I0}, "
                f"s_max={s_max}, R={num_candidates})")
        self.service = service
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
        if self.service is not None:
            self.service.invalidate("reset")

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
        if self.service is not None:
            self.service.mesh = self.mesh
            self._schedule = self.service.replan(
                i, Cw, search_state, ig, status,
                link=self._window_link(link, i), rng=self._rng,
                n_min=n_min, n_max=n_max)
        else:
            self._schedule = SR.fedspace_search(
                self._rng, Cw, search_state, ig, self.regressor, status,
                n_min=n_min, n_max=n_max,
                num_candidates=self.num_candidates, s_max=self.s_max,
                link=self._window_link(link, i), mesh=self.mesh)
        self._window_start = i

    def decide(self, i, *, n_in_buffer, K, state, ig, connectivity, status,
               link=None, **_):
        self._ensure_schedule(i, state=state, ig=ig,
                              connectivity=connectivity, status=status,
                              link=link)
        a = bool(self._schedule[i - self._window_start])
        return a and n_in_buffer > 0

    def device_plan(self, i, *, K, state, ig, connectivity, status,
                    link=None, exec_connectivity=None, exec_link=None, **_):
        if i % self.I0 == 0 or self._schedule is None:
            # `decide` runs after the engine's upload; simulate window i's
            # upload here so the search (and `_search_state`'s grant undo)
            # scores the post-upload state `decide` would see. Under a
            # blind fault trace that upload runs on the executed world,
            # while the search plans on the clean view.
            bc = connectivity if exec_connectivity is None \
                else exec_connectivity
            bl = link if exec_connectivity is None else exec_link
            device = state.version.device
            conn = torch.as_tensor(np.asarray(bc[i], bool), device=device)
            gate = None if bl is None else SS.LinkGate(
                torch.as_tensor(np.asarray(bl.grant[i]), dtype=torch.int32,
                                device=device),
                int(bl.need_up), int(bl.need_dn))
            state, _ = SS.upload_step(state, ig, conn, gate)
            self._ensure_schedule(i, state=state, ig=ig,
                                  connectivity=connectivity, status=status,
                                  link=link)
        device = state.version.device
        args = (torch.as_tensor(np.asarray(self._schedule, np.int32),
                                device=device),
                torch.tensor(self._window_start, dtype=torch.int32,
                             device=device))
        return _fedspace_indicator, args, \
            self._window_start + self.I0 - i


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
