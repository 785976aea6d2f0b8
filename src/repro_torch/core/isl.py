"""Inter-satellite links (ISLs): the intra-plane ring topology derived from
the constellation geometry, sink-satellite election, and the relay and
gossip transitions that compose with the Algorithm-1 protocol steps; the
port of `repro.core.isl`.

Two mechanisms, each behind one scheduler (`repro_torch.core.scheduler`):

  * **intra-plane propagation with sink satellites** (Razmi et al., arXiv
    2302.13447): the satellites of one orbital plane form a ring; per
    election epoch each plane elects the member with the earliest (tie:
    longest) ground contact as its *sink*, every member relays its trained
    update around the ring toward it, and the sink uplinks for the plane.
    Here that is the `relay` hop counter of `SatState` (`relay_step`) and
    sink-indexed effective connectivity (`sink_connectivity`).
  * **asynchronous gossip over ISLs** (Razmi et al., arXiv 2206.00307):
    ring neighbours (and grid neighbours across planes, when configured)
    exchange models between ground contacts, and a satellite that sees a
    newer global version adopts it and restarts local training on it
    (`gossip_step`). Uploads still happen at each satellite's own contacts.

The host side (topology, elections, reachability) is numpy, the port's own
copy of the reference's; the transitions are plain PyTorch on the run's
device. `isl=None` (the default everywhere) leaves every run of the
engine as it is without ISLs: the `relay` column stays None.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import staleness as SS
from repro_torch.core.connectivity import (ConstellationSpec,
                                           satellite_elements,
                                           transfer_windows)

T0_S = 900.0     # protocol window length (15 min), the hop-latency unit


@dataclass(frozen=True)
class ISLConfig:
    """Declarative ISL options, resolved by `Federation.from_experiment`.

    Zero sentinels mirror `LinkConfig`: `isl_mbps` or `model_mb` 0 makes a
    ring hop instantaneous; both positive make one hop take
    ``transfer_windows(isl_mbps, model_mb, T0)`` windows, so an update `d`
    hops from its sink arrives after ``d * relay_windows`` windows.
    `epoch` is the sink re-election period in windows; `cross_plane` adds
    grid links to the neighbouring planes of the same shell (gossip)."""
    isl_mbps: float = 0.0      # inter-satellite link rate; 0 = instantaneous
    model_mb: float = 0.0      # model transfer size; 0 = instantaneous
    cross_plane: bool = False  # grid links to adjacent planes (gossip)
    epoch: int = 24            # sink re-election period, windows

    def __post_init__(self):
        if self.isl_mbps < 0:
            raise ValueError(
                f"ISLConfig.isl_mbps must be >= 0, got {self.isl_mbps}")
        if self.model_mb < 0:
            raise ValueError(
                f"ISLConfig.model_mb must be >= 0, got {self.model_mb}")
        if int(self.epoch) < 1:
            raise ValueError(
                f"ISLConfig.epoch must be >= 1, got {self.epoch}")

    @property
    def relay_windows(self) -> int:
        """Windows one ring hop takes (0 = instantaneous sentinel)."""
        return transfer_windows(self.isl_mbps, self.model_mb, T0_S)


@dataclass(frozen=True)
class ISLTopology:
    """Ring (and optional grid) adjacency over a constellation.

    All arrays are (K,) int32 on the host (the engine moves what it needs
    to its device once per run). Planes are physical orbital planes: the
    satellites sharing a shell, RAAN, inclination and altitude. Within a
    plane, satellites are ordered by along-track phase and the ring closes
    over that order; a plane of one satellite is a self-loop. `left` /
    `right` are the same-slot members of the adjacent planes of the same
    shell (self when the shell has a single plane)."""
    plane: np.ndarray    # plane id per satellite
    pos: np.ndarray      # ring position within the plane (phase order)
    nxt: np.ndarray      # ring successor (self when alone)
    prv: np.ndarray      # ring predecessor (self when alone)
    left: np.ndarray     # same-slot member of previous plane in shell
    right: np.ndarray    # same-slot member of next plane in shell

    @property
    def num_planes(self) -> int:
        return int(self.plane.max()) + 1 if self.plane.size else 0

    def plane_sizes(self) -> np.ndarray:
        """(num_planes,) member count per plane."""
        return np.bincount(self.plane, minlength=self.num_planes)

    def ring_distance(self, target: np.ndarray) -> np.ndarray:
        """(K,) minimal ring hop count from each satellite to `target[k]`
        (per-satellite targets in the same plane, e.g. the sinks)."""
        n = self.plane_sizes()[self.plane]
        d = (self.pos - self.pos[target]) % n
        return np.minimum(d, n - d).astype(np.int32)


def _shell_ids(spec: ConstellationSpec) -> np.ndarray:
    """(K,) shell index per satellite (all 0 for single-shell specs)."""
    if spec.shells:
        return np.concatenate(
            [np.full(s.num_satellites, i, np.int32)
             for i, s in enumerate(spec.shells)])
    return np.zeros(spec.num_satellites, np.int32)


def ring_topology(spec: ConstellationSpec) -> ISLTopology:
    """The intra-plane ring (+ cross-plane grid) adjacency from the spec's
    deterministic orbital elements: satellites grouped into physical
    planes by (shell, RAAN, inclination, altitude), ringed in phase
    order."""
    raan, inc, phase, alt = satellite_elements(spec)
    shell = _shell_ids(spec)
    key = np.stack([shell.astype(np.float64), np.round(raan, 9),
                    np.round(inc, 9), np.round(alt, 3)], axis=1)
    _, plane = np.unique(key, axis=0, return_inverse=True)
    plane = plane.reshape(-1).astype(np.int32)
    K = plane.shape[0]
    pos = np.zeros(K, np.int32)
    nxt = np.arange(K, dtype=np.int32)
    prv = np.arange(K, dtype=np.int32)
    members = {}                     # plane id -> members in ring order
    for p in np.unique(plane):
        m = np.flatnonzero(plane == p)
        order = m[np.lexsort((m, phase[m]))]
        members[int(p)] = order
        pos[order] = np.arange(order.size)
        if order.size > 1:
            nxt[order] = np.roll(order, -1)
            prv[order] = np.roll(order, 1)
    left, right = _grid_neighbors(shell, plane, raan, members)
    return ISLTopology(plane=plane, pos=pos, nxt=nxt, prv=prv,
                       left=left, right=right)


def _grid_neighbors(shell, plane, raan, members):
    """Same-slot links to the adjacent planes of the same shell (RAAN
    order, wrapping), self where the shell has a single plane. Slot r of a
    plane maps to slot ``r % n`` of a differently-sized neighbour."""
    K = plane.shape[0]
    left = np.arange(K, dtype=np.int32)
    right = np.arange(K, dtype=np.int32)
    for s in np.unique(shell):
        pids = np.unique(plane[shell == s])
        order = pids[np.argsort([raan[members[int(p)][0]] for p in pids],
                                kind="stable")]
        if order.size < 2:
            continue
        for j, p in enumerate(order):
            mine = members[int(p)]
            for arr, q in ((left, order[(j - 1) % order.size]),
                           (right, order[(j + 1) % order.size])):
                other = members[int(q)]
                arr[mine] = other[np.arange(mine.size) % other.size]
    return left, right


def identity_topology(K: int) -> ISLTopology:
    """The degenerate no-ISL topology: every satellite its own singleton
    plane, every link a self-loop. An ISL run on it reproduces the plain
    ground-only protocol bit for bit."""
    idx = np.arange(K, dtype=np.int32)
    return ISLTopology(plane=idx.copy(), pos=np.zeros(K, np.int32),
                       nxt=idx.copy(), prv=idx.copy(), left=idx.copy(),
                       right=idx.copy())


@dataclass(frozen=True)
class ISL:
    """The resolved ISL runtime handed to the engine and the schedulers:
    the topology plus the hop latency and the election period. Built by
    `build_isl` (through `Federation.from_experiment` when
    `FLExperiment.isl` is set)."""
    topology: ISLTopology
    relay_windows: int = 0
    epoch: int = 24
    cross_plane: bool = False

    def sink_plan(self, C_epoch: np.ndarray, *, alive=None):
        """``(sink (K,), need_hops (K,))`` int32 for one election epoch,
        from the epoch's effective connectivity slice: `elect_sinks`, and
        ring distances scaled by the hop latency. `alive` (a fault run's
        (K,) mask, alive at some window of the epoch) restricts the
        election to live satellites."""
        sink = elect_sinks(C_epoch, self.topology, alive=alive)
        need = self.topology.ring_distance(sink) * self.relay_windows
        return sink, need.astype(np.int32)


def build_isl(spec: ConstellationSpec, config: ISLConfig) -> ISL:
    """Resolve an `ISLConfig` against a constellation spec."""
    return ISL(topology=ring_topology(spec),
               relay_windows=config.relay_windows,
               epoch=max(int(config.epoch), 1),
               cross_plane=config.cross_plane)


def elect_sinks(C_epoch: np.ndarray, topo: ISLTopology, *,
                alive=None) -> np.ndarray:
    """Per-plane sink election (2302.13447 §III): the member whose first
    ground contact in the epoch comes earliest wins; ties go to the member
    with the most contact windows in the epoch, then the lowest satellite
    index. A plane with no contact in the epoch elects its lowest-index
    member.

    Args:
      C_epoch: (W, K) bool — the epoch's (effective) connectivity slice.
      topo: the ring topology whose `plane` grouping scopes the election.
      alive: optional (K,) bool candidate mask (`repro_torch.core.faults`):
        dead satellites are never elected; an all-dead plane falls back to
        its full membership (no member of it can act).

    Returns (K,) int32: each satellite's elected sink (always in its plane).
    """
    C_epoch = np.asarray(C_epoch, bool)
    W = C_epoch.shape[0]
    has = C_epoch.any(axis=0)
    first = np.where(has, C_epoch.argmax(axis=0), W)     # W = "never"
    total = C_epoch.sum(axis=0)
    sink = np.empty(topo.plane.shape[0], np.int32)
    alive = None if alive is None else np.asarray(alive, bool)
    for p in np.unique(topo.plane):
        m = np.flatnonzero(topo.plane == p)
        cand = m if alive is None else m[alive[m]]
        if cand.size == 0:
            cand = m
        best = cand[np.lexsort((cand, -total[cand], first[cand]))][0]
        sink[m] = best
    return sink


def reachable_count(topo: ISLTopology, C: np.ndarray) -> int:
    """Number of satellites in planes with at least one (effective) ground
    contact over the run — the sync threshold of sink-relay scheduling
    (planes that never see a station can never contribute)."""
    has = np.asarray(C, bool).any(axis=0)
    reach = np.unique(topo.plane[has])
    return int(np.isin(topo.plane, reach).sum())


# ---------------------------------------------------------------------------
# ISL transitions over the protocol state, on its device. They take the
# batch dims of the state like the Algorithm-1 transitions (a (..., K)
# state, index arrays of K global satellite indices: one (K,) row for the
# whole batch, or one row per batch index, as the sweep's variants carry).


def _take(x, idx):
    """``x[..., idx]`` along the satellite axis. `idx` is one (K,) row of
    global indices, or carries batch dims of its own (one row each)."""
    if idx.dim() == 1:
        return x[..., idx]
    x, idx = torch.broadcast_tensors(x, idx)
    return torch.take_along_dim(x, idx, dim=-1)


def relay_step(state, need_hops):
    """Advance the intra-ring relay by one window: every satellite holding
    a pending update adds one hop unit toward its sink. Returns ``(state,
    arrived)`` where ``arrived[k]`` means k's update has covered its ring
    distance (``relay >= need_hops``; sinks, and everyone under
    instantaneous hops, arrive at once). The counter resets on download
    (`reset_relay`); re-elections mid-transit keep it."""
    relay = state.relay + (state.pending >= 0).to(state.relay.dtype)
    return state._replace(relay=relay), relay >= need_hops


def reset_relay(state, downloads):
    """Zero the relay counter where a download started a fresh local
    round."""
    return state._replace(relay=torch.where(downloads, 0, state.relay))


def sink_connectivity(conn, sink, arrived, pending, *, axis_name=None):
    """Effective connectivity under sink relaying: satellite k reaches the
    GS this window iff its plane's sink has a (served) contact AND k's
    update has arrived at the sink — or k has nothing in transit (idle and
    download-only contacts ride the sink's pass directly). `sink` holds
    global satellite indices (int64); `axis_name` raises (the mesh
    slice)."""
    SS._no_mesh(axis_name)
    return _take(conn, sink) & (arrived | (pending < 0))


def gossip_step(state, nxt, prv, left, right, do_hop, alive=None, *,
                axis_name=None):
    """One asynchronous gossip exchange (2206.00307): each satellite looks
    at its ring neighbours (and grid neighbours, self-loops unless
    cross-plane links are configured) and, when `do_hop` is set and a
    neighbour holds a newer global version, adopts it and restarts local
    training on it — `download_step`'s restart-on-newer-model rule with
    the neighbour in place of the GS.

    `nxt`, `prv`, `left`, `right` are int64 global indices, (K,) or one
    row per batch index; `do_hop` a bool, or a bool tensor with one value
    per batch index of the state. `alive` (a fault run's (..., K) bool
    mask) removes dead satellites from the exchange: they offer nothing
    (their version reads as -1) and adopt nothing. `axis_name` raises
    NotImplementedError (the mesh slice). Returns ``(state, adopted)``."""
    SS._no_mesh(axis_name)
    v = state.version
    vn = v if alive is None else torch.where(alive, v, -1)
    nbv = torch.maximum(torch.maximum(_take(vn, nxt), _take(vn, prv)),
                        torch.maximum(_take(vn, left), _take(vn, right)))
    adopted = nbv > v
    if isinstance(do_hop, bool):
        if not do_hop:
            adopted = torch.zeros_like(adopted)
    else:
        hop = torch.as_tensor(do_hop, dtype=torch.bool, device=v.device)
        adopted = adopted & hop.reshape(hop.shape
                                        + (1,) * (v.dim() - hop.dim()))
    if alive is not None:
        adopted = adopted & alive
    return state._replace(version=torch.where(adopted, nbv, v),
                          pending=torch.where(adopted, nbv,
                                              state.pending)), adopted
