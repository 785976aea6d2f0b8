"""Fault injection across the protocol stack: satellite churn, ground-station
outages, and weather-degraded links; the port of `repro.core.faults`.

FedSpace plans on *deterministic* connectivity (§3.1); production
constellations lose satellites mid-run, stations go dark for maintenance,
and weather scales link rates, so the planned schedule and the executed
contacts diverge. This module is that robustness layer:

  * `FaultConfig` — a seeded, declarative failure model: satellite
    deorbit/launch epochs, per-station outage windows, and a blockwise
    seeded link-rate multiplier (weather draws).
  * `fault_trace` — resolves a config into a deterministic per-window
    `FaultTrace`: a satellite-alive mask, a station-up mask, a rate
    multiplier and, given per-station contact counts, the "reaches some
    up station" mask.
  * pure transforms over the connectivity artifacts — `mask_connectivity`
    masks a geometry matrix `C`, `mask_served`/`mask_budget` a
    `repro_torch.core.connectivity.LinkBudget` (grants also rescaled by
    the weather multiplier) — and `fault_reset`, the re-entry transition
    that forces a recovered or launched satellite to download before it
    trains again.

The trace and the masks are numpy on the host, the port's own copy of the
reference's; `fault_reset` is three `torch.where`s on the run's device.
The engine (`repro_torch.fl.engine.SimulationEngine(faults=...)`)
executes on the fault-masked artifacts, while schedulers plan on the
clean view (*blind*, the default) or the faulted one (*oracle*,
`FaultConfig(oracle=True)`). ``faults=None`` leaves every run as it is
without faults.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import staleness as SS
from repro_torch.core.connectivity import LinkBudget


@dataclass(frozen=True)
class FaultConfig:
    """Declarative, seeded failure model (resolved by `fault_trace`).

    Fields:
      deorbit: ((sat, window), ...) — satellite `sat` is dead from
        `window` onward.
      launch: ((sat, window), ...) — satellite `sat` is alive from
        `window` onward. A satellite whose *first* event is a launch starts
        the run dead; a deorbit-then-launch pair models an outage with
        recovery. Events apply in window order.
      outages: ((station, start, end), ...) — ground station `station` is
        down for windows ``[start, end)``.
      rate_scale_min / rate_scale_max: bounds of the seeded per-block
        uniform link-rate multiplier ("weather"). The default (1, 1) draws
        nothing; link-budget grants are scaled by the draw.
      rate_block: windows per weather draw (8 windows = 2 h).
      seed: the weather RNG seed.
      oracle: scheduler visibility. False (blind): schedulers plan on the
        clean connectivity while the engine executes the faulted one.
        True (oracle): planning sees the faulted artifacts too.

    A default-constructed config is `trivial` and resolves to no trace at
    all (`Federation` then wires the run exactly as ``faults=None``).
    """
    deorbit: Tuple[Tuple[int, int], ...] = ()
    launch: Tuple[Tuple[int, int], ...] = ()
    outages: Tuple[Tuple[int, int, int], ...] = ()
    rate_scale_min: float = 1.0
    rate_scale_max: float = 1.0
    rate_block: int = 8
    seed: int = 0
    oracle: bool = False

    def __post_init__(self):
        for name in ("deorbit", "launch"):
            for j, (sat, window) in enumerate(getattr(self, name)):
                if sat < 0:
                    raise ValueError(
                        f"FaultConfig.{name}[{j}] satellite index must be "
                        f">= 0, got {sat}")
                if window < 0:
                    raise ValueError(
                        f"FaultConfig.{name}[{j}] epoch window must be "
                        f">= 0, got {window}")
        for j, (g, s, e) in enumerate(self.outages):
            if g < 0:
                raise ValueError(
                    f"FaultConfig.outages[{j}] station index must be >= 0, "
                    f"got {g}")
            if s < 0 or e < s:
                raise ValueError(
                    f"FaultConfig.outages[{j}] window range must satisfy "
                    f"0 <= start <= end, got ({s}, {e})")
        if not 0.0 <= self.rate_scale_min <= self.rate_scale_max:
            raise ValueError(
                "FaultConfig.rate_scale_min/rate_scale_max must satisfy "
                f"0 <= min <= max, got ({self.rate_scale_min}, "
                f"{self.rate_scale_max})")
        if self.rate_block < 1:
            raise ValueError(
                f"FaultConfig.rate_block must be >= 1, got "
                f"{self.rate_block}")

    @property
    def trivial(self) -> bool:
        """True when the config injects nothing — `Federation` then skips
        trace resolution entirely (the ``faults=None`` path)."""
        return (not self.deorbit and not self.launch and not self.outages
                and self.rate_scale_min == 1.0
                and self.rate_scale_max == 1.0)


@dataclass(frozen=True)
class FaultTrace:
    """A config resolved against a horizon: deterministic per-window masks.

    Fields:
      alive: (W, K) bool — satellite exists this window.
      station_up: (W, G) bool — ground station is serving this window
        (G = 0 when the trace was built without station information).
      rate_scale: (W,) float32 — link-rate multiplier (weather).
      reach: optional (W, K) bool — satellite sees at least one *up*
        station this window (built from per-station contact counts).
      oracle: scheduler visibility, copied from the config.

    Derived views: `mask` (alive ∧ reach, the connectivity multiplier) and
    `revive` (dead→alive transitions, where the engine applies
    `fault_reset`).
    """
    alive: np.ndarray
    station_up: np.ndarray
    rate_scale: np.ndarray
    reach: Optional[np.ndarray] = None
    oracle: bool = False

    @property
    def num_windows(self) -> int:
        return self.alive.shape[0]

    @property
    def mask(self) -> np.ndarray:
        """(W, K) bool connectivity multiplier: alive and (when station
        information was resolved) able to reach an up station."""
        return self.alive if self.reach is None \
            else self.alive & self.reach

    @property
    def revive(self) -> np.ndarray:
        """(W, K) bool: satellite transitions dead → alive at this window.
        Row 0 is all False."""
        prev = np.concatenate([self.alive[:1], self.alive[:-1]], axis=0)
        return self.alive & ~prev

    def extended(self, num_windows: int) -> "FaultTrace":
        """The trace padded to `num_windows` by persisting the final row.
        Faults are calendar events over absolute windows, so a tiled `C`
        does not tile the trace."""
        W = self.num_windows
        if num_windows <= W:
            return self

        def pad(arr):
            return np.concatenate(
                [arr, np.repeat(arr[-1:], num_windows - W, axis=0)], axis=0)

        return dataclasses.replace(
            self, alive=pad(self.alive), station_up=pad(self.station_up),
            rate_scale=pad(self.rate_scale),
            reach=None if self.reach is None else pad(self.reach))


def fault_trace(config: FaultConfig, num_windows: int, *, K: int,
                num_stations: Optional[int] = None,
                counts: Optional[np.ndarray] = None) -> FaultTrace:
    """Resolve a `FaultConfig` into a deterministic `FaultTrace`.

    Args:
      config: the declarative failure model.
      num_windows: the horizon W the trace covers.
      K: constellation size (satellite indices are validated against it).
      num_stations: ground-network size G for the station-up mask
        (defaults to ``counts.shape[2]`` when counts are given, else 0;
        required when the config declares station outages).
      counts: optional (>= W, K, G) per-window per-pair contact counts
        (`repro_torch.core.connectivity.station_windows`); when given, the
        trace also carries `reach`.

    Pure: same (config, horizon, counts) → the same trace.
    """
    W = int(num_windows)
    if counts is not None:
        counts = np.asarray(counts)
        if counts.shape[0] < W:
            raise ValueError(
                f"counts covers {counts.shape[0]} windows < horizon {W}")
        if num_stations is None:
            num_stations = counts.shape[2]
    G = int(num_stations or 0)
    if config.outages and G == 0:
        raise ValueError(
            "FaultConfig.outages requires station information: pass "
            "num_stations= (or counts=) to fault_trace")

    events = sorted(
        [(w, 0, k) for k, w in config.deorbit]
        + [(w, 1, k) for k, w in config.launch])
    for w, _, k in events:
        if k >= K:
            raise ValueError(
                f"FaultConfig satellite index {k} out of range for K={K}")
    # a satellite whose first event is a launch starts the run dead
    first_kind = {}
    for w, kind, k in events:
        first_kind.setdefault(k, kind)
    alive = np.ones((W, K), bool)
    for k, kind in first_kind.items():
        if kind == 1:
            alive[:, k] = False
    for w, kind, k in events:
        if w < W:
            alive[w:, k] = kind == 1

    station_up = np.ones((W, G), bool)
    for g, s, e in config.outages:
        if g >= G:
            raise ValueError(
                f"FaultConfig station index {g} out of range for G={G}")
        station_up[s:min(e, W), g] = False

    rate_scale = np.ones(W, np.float32)
    if (config.rate_scale_min, config.rate_scale_max) != (1.0, 1.0):
        rng = np.random.default_rng(config.seed)
        nblocks = -(-W // config.rate_block)
        draws = rng.uniform(config.rate_scale_min, config.rate_scale_max,
                            nblocks).astype(np.float32)
        rate_scale = np.repeat(draws, config.rate_block)[:W]

    reach = None
    if counts is not None and G > 0:
        reach = ((counts[:W] > 0) & station_up[:, None, :]).any(axis=-1)
    return FaultTrace(alive=alive, station_up=station_up,
                      rate_scale=rate_scale, reach=reach,
                      oracle=config.oracle)


# ---------------------------------------------------------------------------
# Pure transforms over the connectivity artifacts: faults *mask* what the
# clean world already resolved (a satellite whose assigned station goes
# dark loses that window's contact; stations do not re-bid for it).


def mask_connectivity(C: np.ndarray, trace: FaultTrace) -> np.ndarray:
    """Fault-masked geometry connectivity: ``C ∧ trace.mask``."""
    C = np.asarray(C, bool)
    return C & trace.extended(C.shape[0]).mask[:C.shape[0]]


def mask_served(served: np.ndarray, grants: np.ndarray, assign: np.ndarray,
                trace: FaultTrace):
    """Fault-masked (served, grants) arrays of a resolved link budget: a
    contact survives iff the satellite is alive and its *assigned* station
    is up; surviving grants are rescaled by the weather multiplier
    (``floor(grants * rate_scale)``)."""
    served = np.asarray(served, bool)
    W = served.shape[0]
    tr = trace.extended(W)
    ok = tr.alive[:W]
    if tr.station_up.shape[1]:
        up = np.take_along_axis(tr.station_up[:W],
                                np.maximum(assign, 0), axis=1)
        ok = ok & np.where(assign >= 0, up, False)
    served2 = served & ok
    grants2 = np.where(
        served2,
        np.floor(grants * tr.rate_scale[:W, None]).astype(np.int32),
        0).astype(np.int32)
    return served2, grants2


def mask_budget(budget: LinkBudget, trace: FaultTrace) -> LinkBudget:
    """A resolved `LinkBudget` under the trace: `visible` masked by
    aliveness, `served`/`grants` by `mask_served`, `assign` cleared where
    service was lost. Unit needs are untouched."""
    served2, grants2 = mask_served(budget.served, budget.grants,
                                   budget.assign, trace)
    W = budget.served.shape[0]
    alive = trace.extended(W).alive[:W]
    return LinkBudget(
        visible=np.asarray(budget.visible, bool) & alive, served=served2,
        assign=np.where(served2, budget.assign, -1).astype(np.int32),
        grants=grants2, need_up=budget.need_up, need_dn=budget.need_dn)


def fault_reset(state: SS.SatState, revive) -> SS.SatState:
    """The re-entry transition: satellites reviving this window reset to
    "never received" — version/pending -1, transfer progress and relay
    units 0 — which forces a model download before they train or upload
    again. `buffered` (the ground segment's) is untouched. `revive` is a
    bool tensor broadcasting against the state's (..., K) columns.
    Masked `torch.where` updates, dtype-preserving, idempotent."""
    version = torch.where(revive, -1, state.version)
    pending = torch.where(revive, -1, state.pending)
    progress = None if state.progress is None else torch.where(
        revive, 0, state.progress)
    relay = None if state.relay is None else torch.where(
        revive, 0, state.relay)
    return SS.SatState(version, pending, state.buffered, progress, relay)


# ---------------------------------------------------------------------------
# Scenario helpers (the robustness study's fault generators).


def random_churn(K: int, num_windows: int, fraction: float, *,
                 seed: int = 0) -> Tuple[Tuple[int, int], ...]:
    """Seeded churn events: ``floor(K * fraction)`` distinct satellites
    deorbit at uniform windows in ``[1, num_windows)``."""
    n = int(K * fraction)
    if n <= 0:
        return ()
    rng = np.random.default_rng(seed)
    sats = rng.permutation(K)[:n]
    windows = rng.integers(1, max(num_windows, 2), n)
    return tuple(sorted((int(k), int(w)) for k, w in zip(sats, windows)))


def station_blackout(num_stations: int, start: int,
                     end: int) -> Tuple[Tuple[int, int, int], ...]:
    """Outage entries taking the whole ground network down for
    ``[start, end)``."""
    return tuple((g, int(start), int(end)) for g in range(num_stations))
