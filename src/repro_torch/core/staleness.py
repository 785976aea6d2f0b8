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

The port of `repro.core.staleness`: the transitions here match the
reference's exactly on integer state, and are dtype-preserving, so
int16-narrowed search states stay int16.
`simulate_window` rolls them over a scheduling window (the reference's
`lax.scan`, here a Python loop over the I0 windows) and
`simulate_candidates` over a batch of candidate schedules, the candidate
axis a leading batch dimension of the state (the reference's `vmap`): the
inner loop of the FedSpace random search (eq. 13).

Batching rule: the global version `ig` carries the batch dimensions. With
a scalar `ig` the whole state is one protocol instance (the reference's
un-vmapped call); with an `ig` of shape B the state is (*B, K), one
instance per batch index, each with its own empty-buffer guard and
counters (the reference under `vmap`).

Link budgets gate the upload and the download on accumulated contact
units (`LinkGate`, the `progress` column); the ISL layer
(`repro_torch.core.isl`) keeps its relay hop counter in the `relay`
column. Both columns are None unless the run models them, so
geometry-only callers keep the three-column state and its exact
transitions.

A sharded satellite axis (`axis_name`, the mesh's process group, see
`repro_torch.core.mesh`) keeps every mask per shard and makes the
counters, the empty-buffer guard and the histograms exact integer
collectives (`MM.psum`, `MM.pmax`), so every shard takes the same
aggregate-or-not branch; `axis_name=None` runs the single-device
program unchanged.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import mesh as MM
from repro_torch.device import resolve_device


def staleness_compensation(s, alpha: float = 0.5):
    """c_alpha(s) = (s+1)^(-alpha) (paper §2.3, after Xie et al. 2019)."""
    if isinstance(s, torch.Tensor):
        return (s.float() + 1.0) ** (-alpha)
    return (s + 1.0) ** (-alpha)


class SatState(NamedTuple):
    """Per-satellite protocol state: int32 tensors of shape (..., K) on the
    run's device.

    `progress` is the link-budget layer's in-progress-transfer column:
    contact units accumulated toward the satellite's current transfer (the
    pending upload while one exists, the model download otherwise).
    `relay` is the ISL layer's column: hop units the pending update has
    accumulated toward its plane's sink satellite. Each is None unless the
    run models it; both stay int32 when the search narrows the other
    three columns."""
    version: torch.Tensor    # last global version received (-1 = never)
    pending: torch.Tensor    # base version of trained-but-unsent update (-1)
    buffered: torch.Tensor   # base version of update sitting in GS buffer (-1)
    progress: Optional[torch.Tensor] = None   # in-progress transfer units
    relay: Optional[torch.Tensor] = None      # accumulated ISL hop units


class LinkGate(NamedTuple):
    """Link-budget gating for `upload_step` / `download_step`.

    `grant` holds the contact units each satellite is granted (visible
    propagation substeps at its contention-assigned ground station, see
    `repro_torch.core.connectivity.link_budget`): shape (..., K) for one
    transition, (I0, K) along the window axis of `simulate_window`, or the
    run's (num_windows, K) matrix (host numpy) when the engine hands it to
    a scheduler. `need_up` / `need_dn` are the units an upload / download
    takes (ints; 0 = instantaneous, which reproduces the geometry-only
    protocol bit for bit). A transfer completes in the window where the
    accumulated `SatState.progress` plus that window's grant reaches its
    need; progress persists across windows without contact.

    Accounting is full-duplex at window granularity: a window whose grant
    completes an upload contributes its full grant to a download that
    starts in the same window; surplus units beyond the need are
    discarded."""
    grant: torch.Tensor
    need_up: int
    need_dn: int


def _columns(K: int, device, progress: bool, relay: bool):
    zeros = (lambda: torch.zeros((K,), dtype=torch.int32, device=device))
    return {"progress": zeros() if progress else None,
            "relay": zeros() if relay else None}


def init_state(K: int, *, progress: bool = False, relay: bool = False,
               device=None) -> SatState:
    """No satellite holds a model yet. `progress=True` attaches the zeroed
    in-progress-transfer column (link-budget runs), `relay=True` the
    zeroed ISL relay column (sink-satellite runs). `device=None` means
    "cuda" and raises when no CUDA device is present; pass "cpu" for the
    CPU."""
    device = resolve_device(device)
    m1 = torch.full((K,), -1, dtype=torch.int32, device=device)
    return SatState(version=m1, pending=m1.clone(), buffered=m1.clone(),
                    **_columns(K, device, progress, relay))


def bootstrap_state(K: int, *, progress: bool = False, relay: bool = False,
                    device=None) -> SatState:
    """All satellites already hold version 0 and have a pending update on it
    (the GS seeds the constellation with w^0). `progress`, `relay` and
    `device` as in `init_state`."""
    device = resolve_device(device)
    zeros = torch.zeros((K,), dtype=torch.int32, device=device)
    return SatState(version=zeros, pending=zeros.clone(),
                    buffered=torch.full((K,), -1, dtype=torch.int32,
                                        device=device),
                    **_columns(K, device, progress, relay))


# ---------------------------------------------------------------------------
# Algorithm-1 sub-transitions. The engine drives these three functions one
# window at a time; `step` is their composition, and `simulate_window`
# scans it.


def _batched(ig, ref):
    """(ig, ig_b, nb): `ig` as a tensor of `ref`'s dtype and device,
    the same with a unit dim for each state dim it lacks (to broadcast
    against the state), and the number of batch dims it carries."""
    ig = torch.as_tensor(ig, dtype=ref.dtype, device=ref.device)
    nb = ig.dim()
    return ig, ig.reshape(ig.shape + (1,) * (ref.dim() - nb)), nb


def _count(mask, nb):
    """int32 count of `mask` over all but its first `nb` dims."""
    return mask.flatten(nb).sum(-1, dtype=torch.int32)


def upload_step(state: SatState, ig, connected, link=None, *,
                axis_name=None):
    """Phase 1 of a time index: connected satellites hand their pending
    update to the GS buffer; idle contacts (eq. 10) are counted.

    Masked `torch.where` updates over the dense (..., K) state,
    dtype-preserving. `connected` is a (..., K) bool tensor. `ig` carries
    the batch dims (module docstring).

    `link` (a per-window `LinkGate`, grant (..., K)) gates the transfer: a
    connected satellite with a pending update adds this window's grant to
    `SatState.progress`, and the upload enters the buffer only once
    progress reaches `need_up` (progress then resets). `link=None` — or a
    gate with `need_up == 0` — is the instantaneous upload, bit for bit.
    `connected` is then the capacity-resolved (served) connectivity, so
    the counters count served contacts. `axis_name` (a sharded satellite
    axis) makes the three counters one psum, so every shard sees the
    global values.

    Returns (new_state, info) with masks/counters on the device:
      uploads (..., K) bool, idle (..., K) bool,
      n_connected, n_idle, n_buffered — int32, one per batch index.
    """
    _, ig_b, nb = _batched(ig, state.version)
    has_pending = state.pending >= 0
    active = connected & has_pending
    if link is None:
        uploads = active
        progress = state.progress
    else:
        progress = state.progress + torch.where(active, link.grant, 0)
        uploads = active & (progress >= link.need_up)
        progress = torch.where(uploads, 0, progress)
    buffered = torch.where(uploads, state.pending, state.buffered)
    pending = torch.where(uploads, -1, state.pending)
    # idle: connected, nothing to send, nothing new to fetch (eq. 10)
    idle = connected & ~has_pending & (state.version == ig_b)
    conn = connected.expand(idle.shape) if nb else connected
    counts = (_count(conn, nb), _count(idle, nb), _count(buffered >= 0, nb))
    if axis_name is not None:
        # one all-reduce of the stacked counters (exact: integer sums)
        counts = MM.psum(torch.stack(counts), axis_name).unbind(0)
    info = {"uploads": uploads, "idle": idle, "n_connected": counts[0],
            "n_idle": counts[1], "n_buffered": counts[2]}
    return SatState(state.version, pending, buffered, progress,
                    state.relay), info


def aggregate_step(state: SatState, ig, aggregate, *, s_max: int,
                   collect: str = "hist", axis_name=None):
    """Phase 2: when a^i = 1 and the buffer is non-empty, consume the buffer
    and advance the global version (a no-op on an empty buffer — eq. 4 has
    nothing to sum; the global version must not advance spuriously).

    Args:
      state: SatState (..., K); any signed-int dtype (the transition is
        dtype-preserving, so narrow-state callers stay narrow).
      ig: global round index (int or int tensor; it carries the batch
        dims, see the module docstring).
      aggregate: the schedule indicator a^i (bool, or a bool tensor of
        `ig`'s shape).
      s_max: staleness histogram / marks clip.
      collect: which diagnostics to emit —
        * ``"hist"`` (default): {hist (..., s_max+1), n_aggregated,
          max_staleness, aggregated (..., K)};
        * ``"marks"``: {marks (..., K)} — each aggregated satellite's
          clipped staleness, -1 for satellites not aggregated this index
          (int8 when s_max <= 126; see `hist_from_marks`);
        * ``"none"``: {} — the transition only.
      axis_name: a sharded satellite axis: the empty-buffer guard and
        the histogram and count diagnostics become cross-device
        reductions (exact integer psums, the maximum a pmax), so every
        shard takes the same branch.

    The `progress` and `relay` columns pass through unchanged.

    Returns (new_state, new_ig, info); new_ig is a tensor of `ig`'s shape
    in the state's dtype.
    """
    if collect not in ("hist", "marks", "none"):
        raise ValueError(f"collect must be 'hist', 'marks' or 'none', got "
                         f"{collect!r}")
    ig, ig_b, nb = _batched(ig, state.buffered)
    in_buffer = state.buffered >= 0
    any_buf = in_buffer.flatten(nb).any(-1)
    if axis_name is not None:
        any_buf = MM.psum(any_buf.to(torch.int32), axis_name) > 0
    aggregate = torch.as_tensor(aggregate, dtype=torch.bool,
                                device=ig.device) & any_buf
    new_ig = ig + aggregate.to(ig.dtype)
    agg_b = aggregate.reshape(aggregate.shape
                              + (1,) * (in_buffer.dim() - nb))
    buffered = torch.where(agg_b, -1, state.buffered)
    new_state = SatState(state.version, state.pending, buffered,
                         state.progress, state.relay)
    if collect == "none":
        return new_state, new_ig, {}
    counted = in_buffer & agg_b
    if collect == "marks":
        stale_c = (ig_b - state.buffered).clamp(0, s_max)
        marks = torch.where(counted, stale_c, -1).to(marks_dtype(s_max))
        return new_state, new_ig, {"marks": marks}
    stale = torch.where(in_buffer, ig_b - state.buffered, 0)
    stale_c = stale.clamp(0, s_max)
    levels = torch.arange(s_max + 1, dtype=stale_c.dtype,
                          device=stale_c.device)
    hist = ((stale_c[..., None] == levels) & counted[..., None]).sum(
        dim=-2, dtype=torch.int32)
    n_agg = _count(counted, nb)
    max_stale = torch.where(counted, stale, 0).flatten(nb).amax(-1)
    if axis_name is not None:
        # the histogram and the count in one psum, the maximum a pmax
        summed = MM.psum(torch.cat([hist, n_agg[..., None]], -1),
                         axis_name)
        hist, n_agg = summed[..., :-1], summed[..., -1]
        max_stale = MM.pmax(max_stale.to(torch.int32),
                            axis_name).to(max_stale.dtype)
    info = {"hist": hist, "n_aggregated": n_agg,
            "max_staleness": max_stale, "aggregated": counted}
    return new_state, new_ig, info


def marks_dtype(s_max: int):
    """Narrowest dtype that can hold clipped staleness marks (-1..s_max)."""
    return torch.int8 if s_max <= 126 else torch.int32


def hist_from_marks(marks, *, s_max: int, dtype=torch.int32):
    """Staleness histograms from aggregation `marks`, batched over any
    leading axes: (..., K) -> (..., s_max+1).

    `marks` holds each aggregated satellite's clipped staleness and -1
    everywhere else (the ``collect="marks"`` output of `aggregate_step` /
    `step`), so counting value matches recovers exactly the integer counts
    the in-step ``"hist"`` path emits. (The reference counts in blocks of
    eight with int8 partial sums, a CPU trick; the integers are the same.)
    """
    levels = torch.arange(s_max + 1, dtype=marks.dtype, device=marks.device)
    return (marks[..., None] == levels).sum(dim=-2, dtype=dtype)


def download_step(state: SatState, ig, connected, link=None):
    """Phase 3: connected satellites fetch the current global model and, if
    it is newer than what they last received, start a fresh local round.
    Dtype-preserving; `ig` carries the batch dims.

    `link` gates the transfer: a behind-version satellite with no
    un-uploaded pending update (the uplink drains first, which is what
    makes one `progress` column enough) adds this window's grant and
    receives the model once progress reaches `need_dn`. A download always
    delivers the *current* global version: one in flight re-targets the
    newest model when `ig` advances, keeping its progress. `link=None` or
    `need_dn == 0` is the instantaneous download, bit for bit.

    Returns (new_state, info) with the download mask on the device.
    """
    _, ig_b, _ = _batched(ig, state.version)
    gets_new = connected & (state.version < ig_b)
    if link is None:
        done = gets_new
        progress = state.progress
    else:
        active = gets_new & (state.pending < 0)
        progress = state.progress + torch.where(active, link.grant, 0)
        done = active & (progress >= link.need_dn)
        progress = torch.where(done, 0, progress)
    version = torch.where(done, ig_b, state.version)
    pending = torch.where(done, ig_b, state.pending)
    return SatState(version, pending, state.buffered, progress,
                    state.relay), {"downloads": done}


def step(state: SatState, ig, connected, aggregate, *, s_max: int,
         collect: str = "hist", link=None, axis_name=None):
    """One time index of the protocol: upload ∘ aggregate ∘ download.

    Args:
      state: SatState (..., K); any signed-int dtype (dtype-preserving).
      ig: global round index (carries the batch dims).
      connected: (K,) or (..., K) bool — C_i.
      aggregate: a^i, bool or a bool tensor of `ig`'s shape.
      s_max: staleness histogram clip.
      collect: ``"hist"`` (default), ``"marks"`` or ``"none"`` (see
        `aggregate_step`).
      link: optional per-window `LinkGate` (grant (K,) or (..., K)) gating
        the upload and the download; None = instantaneous transfers.
      axis_name: a sharded satellite axis, threaded to the upload's
        counters and the aggregation's guard and diagnostics.

    Returns (new_state, new_ig, info) where info (collect="hist") has:
      hist: (..., s_max+1) counts of aggregated gradients per clipped
      staleness; n_aggregated, n_idle, max_staleness (only meaningful when
      aggregating); under "marks" and "none", `aggregate_step`'s info.
    """
    # the upload's counters are read only under "hist": elsewhere no
    # collective is issued for them
    state, up = upload_step(state, ig, connected, link,
                            axis_name=axis_name if collect == "hist"
                            else None)
    state, new_ig, agg = aggregate_step(state, ig, aggregate, s_max=s_max,
                                        collect=collect, axis_name=axis_name)
    state, _ = download_step(state, new_ig, connected, link)
    if collect != "hist":
        return state, new_ig, agg
    info = {"hist": agg["hist"], "n_aggregated": agg["n_aggregated"],
            "n_idle": up["n_idle"], "max_staleness": agg["max_staleness"]}
    return state, new_ig, info


def simulate_window(C_window, a, state: SatState, ig, *, s_max: int = 8,
                    lite: bool = False, collect: Optional[str] = None,
                    link=None, axis_name=None):
    """Roll the protocol over a scheduling window.

    Args:
      C_window: (I0, K) bool future connectivity (deterministic!) — the
        capacity-resolved (served) matrix when link budgets are modeled.
      a: (..., I0) {0,1} aggregation schedules; leading dims are a batch
        of candidates, each rolled from the same `state` and `ig`.
      state, ig: protocol state (K,) and global version at window start
        (`state.progress` attached when `link` is given).
      lite: emit only the staleness histograms.
      collect: overrides `lite` when given — ``"hist"`` (= lite=False),
        ``"marks"`` (infos carry only marks (..., I0, K), recovered into
        histograms by `hist_from_marks`), or ``"none"`` (infos empty).
      link: optional `LinkGate` whose grant is (I0, K): row i gates the
        transfers of window i, shared by every candidate.
      axis_name: a sharded satellite axis (the state and the K axes of
        `C_window` and the grants are the rank's columns), threaded to
        every step: the empty-buffer guard and, under "hist", the counters
        and histograms cross shards.

    Returns (final_state (..., K), final_ig (...), infos) with infos
    stacked over I0 after the batch dims: hist (..., I0, s_max+1) and,
    unless lite, n_aggregated, n_idle, max_staleness (..., I0) — or marks
    (..., I0, K) under collect="marks".
    """
    keep = ("hist",) if collect is None and lite else None
    collect = collect or "hist"
    C_window = torch.as_tensor(C_window, dtype=torch.bool,
                               device=state.version.device)
    a = torch.as_tensor(a, device=C_window.device) != 0
    batch = a.shape[:-1]
    state = SatState(*(None if x is None else x.expand(batch + x.shape)
                       for x in state))
    grants = None if link is None else torch.as_tensor(
        link.grant, dtype=torch.int32, device=C_window.device)
    ig = torch.as_tensor(ig, dtype=state.version.dtype,
                         device=C_window.device).expand(batch)
    steps = []
    for i in range(C_window.shape[0]):
        gate = None if link is None \
            else LinkGate(grants[i], link.need_up, link.need_dn)
        state, ig, info = step(state, ig, C_window[i], a[..., i],
                               s_max=s_max, collect=collect, link=gate,
                               axis_name=axis_name)
        steps.append(info if keep is None
                     else {k: info[k] for k in keep})
    infos = {k: torch.stack([s[k] for s in steps], dim=len(batch))
             for k in (steps[0] if steps else {})}
    return state, ig, infos


def simulate_candidates(C_window, candidates, state: SatState, ig, *,
                        s_max: int = 8, lite: bool = False,
                        collect: Optional[str] = None, link=None,
                        axis_name=None):
    """`simulate_window` over candidate schedules (R, I0): the candidate
    axis is a leading batch dimension of the rolled state (the
    reference's `vmap`); the link gate, when given, is shared by every
    candidate (schedules differ in *when* they aggregate, not in the
    physics of the links). Returns (states (R, K), igs (R,), infos with a
    leading R axis)."""
    return simulate_window(C_window, candidates, state, ig, s_max=s_max,
                           lite=lite, collect=collect, link=link,
                           axis_name=axis_name)
