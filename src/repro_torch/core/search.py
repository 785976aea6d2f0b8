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

The replan service's incremental scan (`scan_candidates`,
`step_candidates`) comes with the replanning slice, and the
satellite-axis mesh with the mesh slice (ROADMAP A.10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def _simulate_marks(C_window, candidates, state, ig, link=None, *,
                    s_max: int):
    """Staleness marks (R, I0, K) of each candidate's rollout, on the
    state's device; `link` an optional device `LinkGate` (grant
    (I0, K))."""
    _, _, infos = SS.simulate_candidates(C_window, candidates, state, ig,
                                         s_max=s_max, collect="marks",
                                         link=link)
    return infos["marks"]


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


def _later(what: str, slice_: str) -> NotImplementedError:
    """The error of an option the port has not yet: `slice_` names the
    slice of queue A.10 that brings it."""
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the {slice_} slice of the port (ROADMAP "
                               f"A.10)")


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
      mesh: raises NotImplementedError (the mesh slice, ROADMAP A.10).

    Returns: (R,) float32 predicted utility sums.
    """
    if mesh is not None:
        raise _later("the satellite-axis mesh", "mesh")
    device = state.version.device
    if link is not None:
        link = SS.LinkGate(torch.as_tensor(link.grant, dtype=torch.int32,
                                           device=device),
                           int(link.need_up), int(link.need_dn))
    predict_device = getattr(regressor, "predict_device", None)
    if predict_device is None:
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

    cands = np.asarray(candidates)
    R, I0 = cands.shape
    K = C_window.shape[1]
    idx, mask = event_positions(cands)
    Cw = torch.as_tensor(np.asarray(C_window, bool), device=device)
    cands_d = torch.as_tensor(cands, device=device)
    idx_d = torch.as_tensor(idx.astype(np.int64), device=device)
    mask_d = torch.as_tensor(mask, dtype=torch.float32, device=device)
    st, igd = _narrow_state(state, int(ig), I0)
    if chunk_rows is None:
        chunk_rows = max(256, (64 << 20) // max(I0 * K, 1))
    scores = np.empty(R, np.float32)
    for c0 in range(0, R, chunk_rows):
        rows = slice(c0, min(c0 + chunk_rows, R))
        marks = _simulate_marks(Cw, cands_d[rows], st, igd, link,
                                s_max=s_max)
        feats = _event_features(marks, idx_d[rows], status, s_max=s_max)
        util = predict_device(feats).reshape(-1, idx.shape[1])
        scores[rows] = (util * mask_d[rows]).sum(dim=1).cpu().numpy()
    return scores


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
