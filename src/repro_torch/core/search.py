"""Random search over aggregation-schedule candidates (paper §3.2, eq. 13),
the port of `repro.core.search`.

The search space R ⊂ {0,1}^{I0} is restricted to schedules with
n_agg ∈ [N_min, N_max] aggregations (the paper infers the range from û and
uses |R| = 5000). The candidate pool is drawn in numpy on the host, bit for
bit the reference's from the same `np.random.Generator`; the candidates
are then rolled through the protocol on the device of the search state
(`repro_torch.core.staleness.simulate_candidates`, the candidate axis a
batch dimension), and the staleness marks, histograms, features and the
forest walk stay there. The only transfer back per chunk is the (R,)
score vector. Under a link budget the rollouts are gated by the same
per-window grants the engine applies (`link=`, a `LinkGate` of (I0, K)
grants), so candidates are scored against transfers that can complete.

The replan service (`repro_torch.fl.replan.ReplanService`) builds on
`scan_candidates`, which also keeps each candidate's per-event utilities
and final rollout state, and `step_candidates`, one window over
per-candidate states. Both reductions a score is made of add in a fixed
order (the forest's mean over trees in `utility`, the masked event sum
here, `_event_sum`), so a row's score has the same bits whether it is
scored alone or with others: a delta re-plan equals a full rescan.

`score_candidates(mesh=...)` shards the rollouts over a satellite-axis
mesh (`repro_torch.core.mesh`): each rank rolls its columns of the
padded satellite axis for every candidate (the only cross-rank step is
`aggregate_step`'s empty-buffer psum), the marks are gathered along the
satellite axis, and the features and the forest run on every rank, so
the scores are those of `mesh=None` bit for bit. Under a mesh
`scan_candidates`, which does this, keeps none of the artifacts of the
replan cache, and `step_candidates` stays single-device: no replan cache
is built under a mesh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import mesh as MM
from repro_torch.core import staleness as SS
from repro_torch.core.utility import featurize, featurize_t


def random_candidates(rng: np.random.Generator, I0: int, n_min: int,
                      n_max: int, R: int) -> np.ndarray:
    """(R, I0) binary matrix; row r has n_r ~ U[n_min, n_max] ones."""
    n_min = max(0, min(n_min, I0))
    n_max = max(n_min, min(n_max, I0))
    scores = rng.random((R, I0))
    n_agg = rng.integers(n_min, n_max + 1, R)
    order = np.argsort(scores, axis=1)
    ranks = np.empty_like(order)
    rows = np.arange(R)[:, None]
    ranks[rows, order] = np.arange(I0)[None, :]
    return (ranks < n_agg[:, None]).astype(np.int32)


def event_positions(candidates: np.ndarray):
    """Per-candidate aggregation-window indices, dense (host numpy).

    Returns (idx, mask): idx (R, n_cap) int32 holds each schedule's a=1
    window indices in increasing order (n_cap = max aggregation count over
    the batch, at least 1), 0-padded; mask (R, n_cap) bool flags the real
    entries. The eq.-13 objective only sums utility at a=1 windows, so the
    scorer evaluates û at these positions instead of all I0 windows.
    """
    cands = np.asarray(candidates)
    n = cands.sum(axis=1).astype(np.int64)
    n_cap = max(int(n.max()) if n.size else 0, 1)
    # stable argsort of (1 - a) lists the a=1 positions first, in order
    idx = np.argsort(1 - cands, axis=1, kind="stable")[:, :n_cap]
    mask = np.arange(n_cap)[None, :] < n[:, None]
    return idx.astype(np.int32), mask


def _simulate_marks_state(C_window, candidates, state, ig, link=None, *,
                          s_max: int, axis=None):
    """Staleness marks (R, I0, K) of each candidate's rollout, on the
    state's device (`link` an optional device `LinkGate`, grant (I0, K)),
    with each candidate's final rollout state and global version: the
    frontier the replan service caches so that its next re-plan rolls
    only the newly revealed window."""
    fstate, fig, infos = SS.simulate_candidates(C_window, candidates, state,
                                                ig, s_max=s_max,
                                                collect="marks", link=link,
                                                axis_name=axis)
    return infos["marks"], fstate, fig


def step_candidates(states, igs, connected, bits, link=None, *,
                    s_max: int):
    """One protocol window over per-candidate states: the delta scan of a
    newly revealed window.

    Every candidate carries its own frontier state and version (the rollout
    state cached from the previous re-plan), takes its own aggregation bit
    for the window, and shares the window's connectivity column and link
    gate. It is `staleness.step` with the candidate axis as the batch
    axis, so the marks and the advanced states are the ones a full rescan
    computes at its last window.

    Args:
      states: `SatState` (R, K), any signed-int dtype.
      igs: (R,) per-candidate global version, the states' dtype.
      connected: (K,) bool, the revealed window's connectivity column.
      bits: (R,) {0,1}, each candidate's aggregation bit at that window.
      link: optional `LinkGate` with a (K,) grant shared by every
        candidate, or None.

    Returns (marks (R, K), new_states, new_igs).
    """
    st, g, info = SS.step(states, igs, connected, bits != 0, s_max=s_max,
                          collect="marks", link=link)
    return info["marks"], st, g


def _event_sum(util, mask):
    """Per-row sum of `util * mask` (R, n_cap), added column by column
    from the left: the bits of a row do not depend on how many rows are
    reduced together (a library reduction may change its order with the
    row count on the card)."""
    masked = util * mask
    total = masked[:, 0].clone()
    for j in range(1, masked.shape[1]):
        total += masked[:, j]
    return total, masked


def _event_features(marks, idx, status, *, s_max: int):
    """Gather the (R, I0, K) staleness marks at each candidate's
    aggregation windows (idx (R, n_cap), int64), histogram them in int16
    (exact for K < 32768), and featurize: (R*n_cap, F) features for the
    utility regressor."""
    g = torch.take_along_dim(marks, idx[..., None], dim=1)  # (R, n_cap, K)
    hists = SS.hist_from_marks(g, s_max=s_max, dtype=torch.int16)
    Rn, n_cap, F = hists.shape
    return featurize_t(hists.reshape(Rn * n_cap, F), status)


def _narrow_state(state: SS.SatState, ig: int, horizon: int):
    """int16 copy of (state, ig) when every version the window can produce
    fits (half the bytes a rolled step moves, the same marks), int32
    otherwise. The `progress` and `relay` columns (if attached) stay
    int32: they only meet int32 grants, needs and hop counts, never the
    version columns."""
    if ig + horizon < np.iinfo(np.int16).max - 1:
        dt = torch.int16
    else:
        dt = torch.int32
    return (SS.SatState(*(x.to(dt) for x in state[:3]), state.progress,
                        state.relay),
            torch.tensor(ig, dtype=dt, device=state.version.device))


def _chunk_scores(marks, idx, mask, status, predict_device, *,
                  s_max: int):
    """A chunk's scores from its rollouts' marks (Rc, I0, K): the
    features at each candidate's aggregation windows, û, and the masked
    event sum. Returns `_event_sum`'s (total (Rc,), masked (Rc, n_cap))."""
    feats = _event_features(marks, idx, status, s_max=s_max)
    util = predict_device(feats).reshape(-1, idx.shape[1])
    return _event_sum(util, mask)


def score_candidates(candidates: np.ndarray, C_window: np.ndarray,
                     state: SS.SatState, ig: int, regressor, status: float,
                     *, s_max: int = 8, chunk_rows: Optional[int] = None,
                     link=None, mesh=None) -> np.ndarray:
    """Predicted summed utility per candidate (eq. 13).

    When the regressor exposes `predict_device` (both built-in regressors
    do), the pipeline stays on the device of `state`: the batched
    protocol rollout (int16-narrowed state) emits compact staleness
    marks; histograms, featurization and regression run once after it, at
    each candidate's aggregation windows only (a=0 windows contribute
    exactly 0 to eq. 13). The only transfer back is the (R,) score vector.
    That pipeline is `scan_candidates`', whose scores this returns.
    Regressors with only `.predict` (e.g. test oracles) take the legacy
    full-histogram host path.

    Args:
      candidates: (R, I0) {0,1} schedules to score.
      C_window: (I0, K) bool future connectivity.
      state, ig: post-upload protocol state at the window start.
      regressor: utility model û; `predict_device` selects the fast path.
      status: training status T fed to the featurizer.
      s_max: staleness clip — must match the regressor's feature width.
      chunk_rows: candidates rolled per batch (None = auto-sized so the
        marks buffer stays ~64 MB); per-candidate results are unchanged.
      link: optional `LinkGate` (grant (I0, K), any array-like) gating the
        rolled transfers, so candidates are scored against the effective,
        capacity-constrained connectivity; `state.progress` must be
        attached when given.
      mesh: optional satellite-axis `DeviceMesh`
        (`repro_torch.core.mesh.sim_mesh`): the device pipeline pads K to
        a multiple of the mesh's size with never-connected satellites and
        rolls each rank's columns (`scan_candidates`), the scores of
        `mesh=None` bit for bit. Every rank of the mesh calls with the
        same arguments. The `.predict` path ignores it.

    Returns: (R,) float32 predicted utility sums.
    """
    if getattr(regressor, "predict_device", None) is not None:
        return scan_candidates(candidates, C_window, state, ig, regressor,
                               status, s_max=s_max, chunk_rows=chunk_rows,
                               link=link, mesh=mesh)[0]
    device = state.version.device
    if link is not None:
        link = SS.LinkGate(torch.as_tensor(link.grant, dtype=torch.int32,
                                           device=device),
                           int(link.need_up), int(link.need_dn))
    _, _, infos = SS.simulate_candidates(
        np.asarray(C_window, bool), np.asarray(candidates), state,
        torch.tensor(ig, dtype=torch.int32, device=device),
        s_max=s_max, lite=True, link=link)
    hist = infos["hist"].cpu().numpy()              # (R, I0, s_max+1)
    Rn, I0, F = hist.shape
    feats = featurize(hist.reshape(Rn * I0, F), status)
    util = regressor.predict(feats).reshape(Rn, I0)
    agg_mask = np.asarray(candidates, np.float32)
    return (util * agg_mask).sum(axis=1)


def scan_candidates(candidates: np.ndarray, C_window: np.ndarray,
                    state: SS.SatState, ig: int, regressor, status: float,
                    *, s_max: int = 8, chunk_rows: Optional[int] = None,
                    link=None, mesh=None):
    """`score_candidates`' device pipeline, which also keeps the
    per-candidate artifacts the replan service caches
    (`repro_torch.fl.replan`). The regressor must expose `predict_device`
    (a host-path regressor has no device artifacts).

    Under a satellite-axis `mesh` the satellite axis is padded to a
    multiple of the mesh's size with never-connected satellites, each rank
    rolls its columns of it for every candidate, and the marks are
    gathered along it before the features, so the scores are those of
    `mesh=None` bit for bit; padded satellites keep their -1 marks, which
    count in no histogram. No artifacts are kept then (None).

    Returns (scores (R,) float32 numpy, artifacts), artifacts a dict:
      win_util: (R, I0) float32 tensor on the state's device — each
        candidate's predicted per-event utility at its aggregation windows,
        0 elsewhere (padded event slots fall on a=0 windows, so no real
        event is overwritten).
      end_state: `SatState` (R, K) on the state's device — each
        candidate's rollout state after the last window (the frontier the
        next delta step advances). It stays there: at the serving shape,
        R 20000 x K 1000 x 3 int16 columns is 120 MB.
      end_ig: (R,) tensor, each candidate's final global version.
      state_dtype: the narrowed rollout dtype (np.int16 or np.int32), for
        the delta path's narrowing guard.
    """
    device = state.version.device
    cands = np.asarray(candidates)
    R, I0 = cands.shape
    K = C_window.shape[1]
    Cw = np.asarray(C_window, bool)
    grant, axis = None if link is None else link.grant, None
    if mesh is not None:
        axis, Kp = MM.mesh_axis(mesh), MM.padded_size(K, mesh)
        Cw = MM.pad_axis(Cw, Kp)
        grant = None if link is None else MM.pad_axis(np.asarray(grant), Kp)
        state = MM.pad_state(state, Kp)
    if link is not None:
        link = SS.LinkGate(MM.local(torch.as_tensor(
            grant, dtype=torch.int32, device=device), axis).contiguous(),
            int(link.need_up), int(link.need_dn))
    idx, mask = event_positions(cands)
    Cw = MM.local(torch.as_tensor(Cw, device=device), axis).contiguous()
    state = SS.SatState(*(None if x is None else MM.local(x, axis)
                          for x in state))
    cands_d = torch.as_tensor(cands, device=device)
    idx_d = torch.as_tensor(idx.astype(np.int64), device=device)
    mask_d = torch.as_tensor(mask, dtype=torch.float32, device=device)
    st, igd = _narrow_state(state, int(ig), I0)
    if chunk_rows is None:
        chunk_rows = max(256, (64 << 20) // max(I0 * K, 1))
    scores = np.empty(R, np.float32)
    win_util = (torch.zeros((R, I0), dtype=torch.float32, device=device)
                if axis is None else None)
    end_states, end_igs = [], []
    predict_device = regressor.predict_device
    for c0 in range(0, R, chunk_rows):
        rows = slice(c0, min(c0 + chunk_rows, R))
        marks, fstate, fig = _simulate_marks_state(
            Cw, cands_d[rows], st, igd, link, s_max=s_max, axis=axis)
        total, masked = _chunk_scores(MM.all_gather(marks, axis),
                                      idx_d[rows], mask_d[rows], status,
                                      predict_device, s_max=s_max)
        scores[rows] = total.cpu().numpy()
        if axis is None:
            win_util[rows].scatter_(1, idx_d[rows], masked)
            end_states.append(fstate)
            end_igs.append(fig)
    if axis is not None:
        return scores, None
    end_state = SS.SatState(*(
        None if end_states[0][j] is None
        else torch.cat([s[j] for s in end_states])
        for j in range(len(end_states[0]))))
    return scores, {"win_util": win_util, "end_state": end_state,
                    "end_ig": torch.cat(end_igs),
                    "state_dtype": np.dtype(np.int16)
                    if st.version.dtype == torch.int16
                    else np.dtype(np.int32)}


def infer_n_range(regressor, uploads_per_window: float, I0: int,
                  status: float, *, s_max: int = 8, K: int = None,
                  halfwidth: int = 4):
    """Infer [N_min, N_max] from û, as the paper does: for each candidate
    aggregation count n, approximate the per-aggregation staleness histogram
    under even spacing (uploads split across n aggregations, mostly fresh),
    and pick the count maximizing n * û(hist(n), T)."""
    # Cap at one aggregation per two windows: beyond that per-aggregation
    # buffers thin out into the async regime the paper shows fails, and û
    # extrapolates badly at counts it never sampled.
    n_cap = max(1, I0 // 2)
    total_uploads = uploads_per_window * I0
    # f64 like the reference (the f32 store happens once, on assignment
    # into hists), so the histogram features are the reference's bits
    ns = np.arange(1, n_cap + 1, dtype=np.float64)
    per = total_uploads / ns
    if K:
        per = np.minimum(per, K)
    hists = np.zeros((n_cap, s_max + 1), np.float32)
    hists[:, 0] = per * 0.7          # even spacing: gradients mostly fresh
    hists[:, 1] = per * 0.3
    u = ns * regressor.predict(featurize(hists, status)).astype(np.float64)
    best_n = 1 + int(np.argmax(u))
    return max(1, best_n - halfwidth), min(n_cap, best_n + halfwidth)


def fedspace_search(rng: np.random.Generator, C_window: np.ndarray,
                    state: SS.SatState, ig: int, regressor, status: float,
                    *, n_min: int = 4, n_max: int = 8, num_candidates: int
                    = 5000, s_max: int = 8, link=None,
                    mesh=None) -> np.ndarray:
    """One eq.-13 re-plan: draw `num_candidates` schedules from `rng`,
    score them against û and return the winner (I0,) int32."""
    I0 = C_window.shape[0]
    cands = random_candidates(rng, I0, n_min, n_max, num_candidates)
    scores = score_candidates(cands, C_window, state, ig, regressor, status,
                              s_max=s_max, link=link, mesh=mesh)
    return cands[select_candidate(cands, scores)]


def select_candidate(cands: np.ndarray, scores: np.ndarray) -> int:
    """Index of the winning candidate. Distinct-but-equivalent candidates
    (identical staleness histograms) tie at float level, and different
    scoring backends break such ties differently by reduction-order
    jitter; so among candidates within float noise of the max, pick the
    lexicographically smallest schedule — deterministic and
    backend-stable."""
    best = float(np.max(scores))
    eps = 32 * float(np.finfo(np.float32).eps) * max(1.0, abs(best))
    near = np.flatnonzero(scores >= best - eps)
    if near.size > 1:
        near = sorted(near, key=lambda j: cands[j].tobytes())
    return int(near[0])
