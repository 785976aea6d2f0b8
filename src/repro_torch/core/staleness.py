"""Staleness / idleness dynamics (paper eqs. 4, 9, 10): the Algorithm-1
protocol transitions over device tensors.

Protocol semantics (Algorithm 1 + Appendix A):
  at each time index i, for every connected satellite k in C_i:
    1. upload: if k holds a trained update (base version b_k), it enters the
       GS buffer with staleness s_k = i_g - b_k *at aggregation time*;
    2. if a^i = 1 the GS aggregates the buffer and increments i_g;
    3. download: k receives the current global model; if its version is newer
       than what k last received, k starts a new local round from it.
  A connection is *idle* when the satellite has nothing to upload (no
  aggregation happened between its two previous contacts — eq. 10).

The port of `repro.core.staleness` for geometry-only runs: the transitions
here match the reference's exactly on integer state. Link-budget gating
(`LinkGate`, the `progress` column), the ISL `relay` column, the compact
staleness marks and the vectorised window simulators (`simulate_window`,
`simulate_candidates`) come with later slices of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


def staleness_compensation(s, alpha: float = 0.5):
    """c_alpha(s) = (s+1)^(-alpha) (paper §2.3, after Xie et al. 2019)."""
    if isinstance(s, torch.Tensor):
        return (s.float() + 1.0) ** (-alpha)
    return (s + 1.0) ** (-alpha)


class SatState(NamedTuple):
    """Per-satellite protocol state: int32 tensors of shape (..., K) on the
    run's device."""
    version: torch.Tensor    # last global version received (-1 = never)
    pending: torch.Tensor    # base version of trained-but-unsent update (-1)
    buffered: torch.Tensor   # base version of update sitting in GS buffer (-1)


def init_state(K: int, *, device=None) -> SatState:
    """No satellite holds a model yet. `device=None` means "cuda" and
    raises when no CUDA device is present; pass "cpu" for the CPU."""
    m1 = torch.full((K,), -1, dtype=torch.int32,
                    device=resolve_device(device))
    return SatState(version=m1, pending=m1.clone(), buffered=m1.clone())


def bootstrap_state(K: int, *, device=None) -> SatState:
    """All satellites already hold version 0 and have a pending update on it
    (the GS seeds the constellation with w^0). `device` as in
    `init_state`."""
    device = resolve_device(device)
    zeros = torch.zeros((K,), dtype=torch.int32, device=device)
    return SatState(version=zeros, pending=zeros.clone(),
                    buffered=torch.full((K,), -1, dtype=torch.int32,
                                        device=device))


# ---------------------------------------------------------------------------
# Algorithm-1 sub-transitions. The engine drives these three functions one
# window at a time; `step` is their composition.


def upload_step(state: SatState, ig, connected):
    """Phase 1 of a time index: connected satellites hand their pending
    update to the GS buffer; idle contacts (eq. 10) are counted.

    Masked `torch.where` updates over the dense (..., K) state,
    dtype-preserving. `connected` is a (..., K) bool tensor.

    Returns (new_state, info) with masks/counters on the device:
      uploads (K,) bool, idle (K,) bool,
      n_connected, n_idle, n_buffered — int32 scalars.
    """
    has_pending = state.pending >= 0
    uploads = connected & has_pending
    buffered = torch.where(uploads, state.pending, state.buffered)
    pending = torch.where(uploads, -1, state.pending)
    # idle: connected, nothing to send, nothing new to fetch (eq. 10)
    idle = connected & ~has_pending & (state.version == ig)
    info = {"uploads": uploads, "idle": idle,
            "n_connected": connected.sum(dtype=torch.int32),
            "n_idle": idle.sum(dtype=torch.int32),
            "n_buffered": (buffered >= 0).sum(dtype=torch.int32)}
    return SatState(state.version, pending, buffered), info


def aggregate_step(state: SatState, ig, aggregate, *, s_max: int,
                   collect: str = "hist"):
    """Phase 2: when a^i = 1 and the buffer is non-empty, consume the buffer
    and advance the global version (a no-op on an empty buffer — eq. 4 has
    nothing to sum; the global version must not advance spuriously).

    Args:
      state: SatState (..., K).
      ig: global round index (int or int32 scalar tensor).
      aggregate: the schedule indicator a^i (bool or bool scalar tensor).
      s_max: staleness histogram clip.
      collect: ``"hist"`` (default) emits {hist (s_max+1,), n_aggregated,
        max_staleness, aggregated (K,)}; ``"none"`` emits {} (transition
        only — the engine keeps its own staleness bookkeeping).

    Returns (new_state, new_ig, info); new_ig is an int32 scalar tensor.
    """
    if collect not in ("hist", "none"):
        raise ValueError(f"collect must be 'hist' or 'none', got {collect!r}"
                         " (staleness marks come with a later slice)")
    device = state.buffered.device
    in_buffer = state.buffered >= 0
    aggregate = torch.as_tensor(aggregate, dtype=torch.bool,
                                device=device) & in_buffer.any()
    ig = torch.as_tensor(ig, dtype=state.buffered.dtype, device=device)
    new_ig = ig + aggregate.to(ig.dtype)
    buffered = torch.where(aggregate, -1, state.buffered)
    new_state = SatState(state.version, state.pending, buffered)
    if collect == "none":
        return new_state, new_ig, {}
    counted = in_buffer & aggregate
    stale = torch.where(in_buffer, ig - state.buffered, 0)
    stale_c = stale.clamp(0, s_max)
    levels = torch.arange(s_max + 1, dtype=stale_c.dtype, device=device)
    hist = ((stale_c[..., None] == levels) & counted[..., None]).sum(
        dim=-2, dtype=torch.int32)
    info = {"hist": hist, "n_aggregated": counted.sum(dtype=torch.int32),
            "max_staleness": torch.where(counted, stale, 0).max(),
            "aggregated": counted}
    return new_state, new_ig, info


def download_step(state: SatState, ig, connected):
    """Phase 3: connected satellites fetch the current global model and, if
    it is newer than what they last received, start a fresh local round.

    Returns (new_state, info) with the download mask on the device.
    """
    ig = torch.as_tensor(ig, dtype=state.version.dtype,
                         device=state.version.device)
    done = connected & (state.version < ig)
    version = torch.where(done, ig, state.version)
    pending = torch.where(done, ig, state.pending)
    return SatState(version, pending, state.buffered), {"downloads": done}


def step(state: SatState, ig, connected, aggregate, *, s_max: int,
         collect: str = "hist"):
    """One time index of the protocol: upload ∘ aggregate ∘ download.

    Returns (new_state, new_ig, info) where info (collect="hist") has:
      hist: (s_max+1,) counts of aggregated gradients per clipped staleness
      n_aggregated, n_idle, max_staleness (only meaningful when aggregate)
    """
    state, up = upload_step(state, ig, connected)
    state, new_ig, agg = aggregate_step(state, ig, aggregate, s_max=s_max,
                                        collect=collect)
    state, _ = download_step(state, new_ig, connected)
    if collect != "hist":
        return state, new_ig, agg
    info = {"hist": agg["hist"], "n_aggregated": agg["n_aggregated"],
            "n_idle": up["n_idle"], "max_staleness": agg["max_staleness"]}
    return state, new_ig, info
