"""Incremental eq.-13 replanning as a service (ground-assisted scheduling,
arXiv 2109.01348), the port of `repro.fl.replan`.

Every FedSpace aggregation event recomputes the full candidate scan over
the I0 horizon, yet consecutive horizons overlap in all but one window.
`ReplanService` holds the rollout artifacts of the previous re-plan and
scores only the delta:

* A **full plan** at window j draws a candidate pool, runs
  `repro_torch.core.search.scan_candidates` (the artifact-keeping twin of
  `score_candidates`) and keeps, per candidate, the predicted per-event
  utilities (`win_util`) and the final rollout state and version (the
  frontier), on the device of the caller's state.
* A **delta re-plan** at window j+1 keeps the candidates whose window-j
  bit equals the realized action (their rollouts coincide with reality on
  the overlap, so every cached per-event utility over [j+1, j+I0) is the
  one a fresh rescan computes), extends each survivor with a drawn bit
  for the newly revealed window j+I0, and rolls **only that window** —
  one `step_candidates` step over the candidates that scheduled it —
  before re-reducing the scores at the shape a full rescan of the pool
  uses. The per-row reductions add in a fixed order (the forest's mean
  over trees, the masked event sum), so a row's score has the same bits
  whether 30 rows or 20,000 are scored together: the answer is
  `score_candidates` + `select_candidate` on the same pool and state, bit
  for bit, on the CPU and on the card.

The cache is invalidated — the service falls back to a full rescan — on:
  * **drift**: the caller's state is not the one the cached rollouts
    predicted (a fault mask, an out-of-band aggregation, or a caller that
    executed another action than the returned schedule's);
  * **narrowing**: the global version grew past the int16 narrowing guard
    the cached frontier states were rolled under;
  * **horizon / window**: I0 or K changed, or the request is not the next
    consecutive window;
  * **link / connectivity view**: the overlapping connectivity or grant
    rows differ from the cached view (weather, outages, a new budget);
  * **status**: the training status T changed (every cached utility was
    predicted at the old T);
  * **pool**: the survivors would fall below `min_pool`.
  * **mesh**: under a satellite-axis mesh (`mesh=`) every answer is a
    sharded full rescan (`score_candidates(mesh=...)`) and nothing is
    cached. The reason reads "mesh" from the first answer on (the
    reference checks it after the cold start and never fills its cache
    under a mesh, so every one of its answers there reads "cold").
Fallbacks are counted per reason in `ReplanService.stats`.

The candidate pools, the extension bits and the selection run on the host
in numpy, from the reference's generators in the reference's order, so
the pools are the reference's. The rollouts, utilities and scores run on
the device of the `SatState` tensors the caller hands in, which every
request keeps. The reference pads the delta step's rows
to power-of-two buckets to keep `jit` to few shapes; PyTorch runs eagerly
and needs no padding.

Forest transfer: the regressor is handed in once (`regressor=`) and the
serving path never refits — the histogram featurization is K-agnostic
(`repro_torch.core.utility.transfer_ready`), so a forest fitted on
flock191 serves starlink40/120/400 unchanged
(`examples/serve_replan_torch.py`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import staleness as SS
from repro_torch.core.search import (_event_sum, event_positions,
                                     infer_n_range, random_candidates,
                                     scan_candidates, score_candidates,
                                     select_candidate, step_candidates)
from repro_torch.core.utility import featurize_t, transfer_ready

__all__ = ["ReplanService"]


class _Cache:
    """The previous re-plan's rollout artifacts (see module docstring)."""

    def __init__(self, *, window, cands, Cw, grant, need_up, need_dn,
                 win_util, end_state, end_ig, state_dtype, pre_state,
                 pre_ig, winner_bit, status, density, n_max):
        self.window = window          # absolute window the plan answered
        self.cands = cands            # (R, I0) int32 pool, host
        self.Cw = Cw                  # (I0, K) bool horizon view, host
        self.grant = grant            # (I0, K) int32 grants or None, host
        self.need_up = need_up
        self.need_dn = need_dn
        self.win_util = win_util      # (R, I0) f32 per-event utilities
        self.end_state = end_state    # SatState (R, K), the frontier
        self.end_ig = end_ig          # (R,) frontier versions
        self.state_dtype = state_dtype
        self.pre_state = pre_state    # int32 (K,) search state of the plan
        self.pre_ig = pre_ig
        self.winner_bit = winner_bit  # realized action the cache assumes
        self.status = status
        self.density = density        # pool aggregation density at draw
        self.n_max = n_max            # cap for extension bits
        self.pending = None           # (conn, gate) of an unadvanced window


def _int32_state(state: SS.SatState) -> SS.SatState:
    """int32 copy of a (K,) SatState, on its device."""
    return SS.SatState(*(None if x is None
                         else x.to(torch.int32).clone() for x in state))


def _rows(state: SS.SatState, sel) -> SS.SatState:
    """Index the leading (candidate) axis of a stacked SatState."""
    return SS.SatState(*(None if x is None else x[sel] for x in state))


def _state_equal(a: SS.SatState, b: SS.SatState) -> bool:
    return all((x is None) == (y is None)
               and (x is None or torch.equal(x, y)) for x, y in zip(a, b))


class ReplanService:
    """Persistent eq.-13 replanner with delta-window scoring.

    One service holds one regressor (the forest-transfer handoff: fit
    once, serve any constellation) and the rollout cache of its latest
    plan. `replan` answers a request; `maintain` runs the deferred
    frontier advance between requests so the answer costs a delta step.

    Args:
      regressor: fitted utility model û; must pass
        `repro_torch.core.utility.transfer_ready` for this `s_max` (the
        serving path never refits).
      I0: planning-horizon length (windows).
      num_candidates: pool size R of a full plan.
      n_min / n_max: aggregation-count range for candidate draws; None
        infers both from û per plan (paper §3.2, `infer_n_range`).
      s_max: staleness clip — must match the regressor's feature width.
      seed: service rng (extension bits, and full-plan draws when the
        caller does not pass its own rng).
      min_pool: survivor floor below which a delta request full-rescans.
      mesh: optional satellite-axis `DeviceMesh`
        (`repro_torch.core.mesh`) for full rescans; nothing is cached
        under a mesh. A FedSpace scheduler holding the service sets it to
        its run's mesh.
    """

    def __init__(self, regressor, *, I0: int = 24,
                 num_candidates: int = 5000, n_min: Optional[int] = None,
                 n_max: Optional[int] = None, s_max: int = 8, seed: int = 0,
                 min_pool: int = 256, mesh=None):
        if not transfer_ready(regressor, s_max=s_max):
            raise ValueError(
                "regressor is not transfer-ready for s_max="
                f"{s_max}: it must expose predict_device and (if fitted "
                "through .fit) a matching feature width — see "
                "repro_torch.core.utility.transfer_ready")
        self.regressor = regressor
        self.mesh = mesh
        self.I0 = I0
        self.num_candidates = num_candidates
        self.n_min = n_min
        self.n_max = n_max
        self.s_max = s_max
        self.seed = seed
        self.min_pool = min_pool
        self._rng = np.random.default_rng(seed)
        self._cache: Optional[_Cache] = None
        self.stats = {"full": 0, "delta": 0, "invalidated": {}}
        self.last_mode: Optional[str] = None
        self.last_reason: Optional[str] = None

    # -- cache management ---------------------------------------------------

    def invalidate(self, reason: str = "external"):
        """Drop the rollout cache (the next request full-rescans). The
        scheduler's `reset()` cascades here so re-runs never reuse a stale
        plan."""
        if self._cache is not None:
            self.stats["invalidated"][reason] = \
                self.stats["invalidated"].get(reason, 0) + 1
        self._cache = None

    @property
    def pool(self) -> Optional[np.ndarray]:
        """The current candidate pool (a copy), for parity gates."""
        return None if self._cache is None else self._cache.cands.copy()

    def _gate(self, grant_row, need_up, need_dn, device):
        if grant_row is None:
            return None
        return SS.LinkGate(torch.as_tensor(np.asarray(grant_row, np.int32),
                                           device=device),
                           int(need_up), int(need_dn))

    def maintain(self):
        """Deferred delta-step bookkeeping: advance every cached frontier
        state through the window revealed by the last delta re-plan. The
        answer path rolls the revealed window only for candidates that
        *scheduled* it; this advances the whole pool so the next request
        is again one window's work. Call it between requests (the server
        loop does); a re-plan arriving first runs it inline."""
        c = self._cache
        if c is None or c.pending is None:
            return
        conn, gate = c.pending
        bits = torch.as_tensor(c.cands[:, -1], device=conn.device)
        _, c.end_state, c.end_ig = step_candidates(
            c.end_state, c.end_ig, conn, bits, gate, s_max=self.s_max)
        c.pending = None

    # -- request path -------------------------------------------------------

    def replan(self, window: int, C_window: np.ndarray, state: SS.SatState,
               ig: int, status: float, *, link: Optional[SS.LinkGate] = None,
               rng: Optional[np.random.Generator] = None,
               n_min: Optional[int] = None,
               n_max: Optional[int] = None) -> np.ndarray:
        """Answer one re-plan request: the winning (I0,) schedule for the
        horizon [window, window + I0).

        Arguments mirror `repro_torch.core.search.fedspace_search`:
        `C_window` is the (I0, K) future connectivity (the effective,
        capacity-resolved one when budgets are modeled), `state`/`ig` the
        search-ready protocol state (post-upload at `window`,
        grant-inverted under a link budget —
        `FedSpaceScheduler._search_state`), `status` the training status
        T, `link` the horizon's `LinkGate` slice. `rng` drives the
        candidate draw of a full plan (the FedSpace scheduler passes its
        own so routed plans are the unrouted ones); extension bits of
        delta steps always come from the service rng.

        Consecutive-window requests with an intact cache take the delta
        path; anything else falls back to a full rescan (the module
        docstring's invalidation table).
        """
        C_window = np.asarray(C_window, bool)
        self.maintain()
        reason = self._delta_blocker(window, C_window, state, ig, status,
                                     link)
        if reason is None:
            self.last_mode, self.last_reason = "delta", None
            self.stats["delta"] += 1
            return self._delta(window, C_window, state, ig, status, link)
        if self._cache is not None and reason != "cold":
            self.invalidate(reason)
        self.last_mode, self.last_reason = "full", reason
        self.stats["full"] += 1
        return self._full(window, C_window, state, ig, status, link, rng,
                          n_min, n_max)

    # -- full plan ----------------------------------------------------------

    def _full(self, window, Cw, state, ig, status, link, rng, n_min,
              n_max):
        I0, K = Cw.shape
        rng = rng if rng is not None else self._rng
        n_min = n_min if n_min is not None else self.n_min
        n_max = n_max if n_max is not None else self.n_max
        if n_min is None or n_max is None:
            inf_min, inf_max = infer_n_range(
                self.regressor, float(Cw.mean(axis=1).sum()) / I0 * K,
                I0, status, s_max=self.s_max, K=K)
            n_min = n_min if n_min is not None else inf_min
            n_max = n_max if n_max is not None else inf_max
        cands = random_candidates(rng, I0, n_min, n_max,
                                  self.num_candidates)
        if self.mesh is not None:
            scores = score_candidates(cands, Cw, state, ig, self.regressor,
                                      status, s_max=self.s_max, link=link,
                                      mesh=self.mesh)
            return cands[select_candidate(cands, scores)].copy()
        scores, art = scan_candidates(cands, Cw, state, ig, self.regressor,
                                      status, s_max=self.s_max, link=link)
        w = select_candidate(cands, scores)
        self._cache = _Cache(
            window=window, cands=cands, Cw=Cw.copy(),
            grant=None if link is None
            else np.asarray(link.grant, np.int32).copy(),
            need_up=0 if link is None else int(link.need_up),
            need_dn=0 if link is None else int(link.need_dn),
            win_util=art["win_util"], end_state=art["end_state"],
            end_ig=art["end_ig"], state_dtype=art["state_dtype"],
            pre_state=_int32_state(state), pre_ig=int(ig),
            winner_bit=int(cands[w, 0]), status=float(status),
            density=float(cands.mean()), n_max=n_max)
        return cands[w].copy()

    # -- delta path ---------------------------------------------------------

    def _delta_blocker(self, window, Cw, state, ig, status, link):
        """None when the cached rollouts can answer this request, else the
        invalidation reason (module docstring)."""
        c = self._cache
        if self.mesh is not None:
            return "mesh"
        if c is None:
            return "cold"
        if window != c.window + 1:
            return "window"
        if Cw.shape != c.Cw.shape:
            return "horizon"
        if float(status) != c.status:
            return "status"
        if not np.array_equal(Cw[:-1], c.Cw[1:]):
            return "connectivity"
        if (link is None) != (c.grant is None):
            return "link"
        if link is not None:
            if (int(link.need_up) != c.need_up
                    or int(link.need_dn) != c.need_dn
                    or not np.array_equal(
                        np.asarray(link.grant, np.int32)[:-1],
                        c.grant[1:])):
                return "link"
        if (c.state_dtype == np.int16
                and not (int(ig) + self.I0 + 1
                         < np.iinfo(np.int16).max - 1)):
            return "narrowing"
        if np.count_nonzero(c.cands[:, 0] == c.winner_bit) < self.min_pool:
            return "pool"
        if self._drifted(window, Cw, state, ig, link):
            return "drift"
        return None

    def _drifted(self, window, Cw, state, ig, link) -> bool:
        """True when the caller's state is not the one the cached rollouts
        predicted. The cached scan entered window `window` with the state
        produced by realizing the winner's bit at window-1; a fresh rescan
        enters it by (idempotently) re-uploading the caller's search-ready
        state. The two coincide — and every cached mark stays valid — iff
        both post-upload states are equal, so that is the check: one
        (K,)-sized transition each, compared as integers."""
        c = self._cache
        device = c.pre_state.version.device
        prev_gate = self._gate(None if c.grant is None else c.grant[0],
                               c.need_up, c.need_dn, device)
        after, g_after, _ = SS.step(
            c.pre_state, c.pre_ig, torch.as_tensor(c.Cw[0], device=device),
            bool(c.winner_bit), s_max=self.s_max, collect="none",
            link=prev_gate)
        if int(g_after) != int(ig):
            return True
        gate0 = self._gate(None if link is None
                           else np.asarray(link.grant, np.int32)[0],
                           c.need_up, c.need_dn, device)
        conn0 = torch.as_tensor(Cw[0], device=device)
        predicted, _ = SS.upload_step(after, g_after, conn0, gate0)
        rescanned, _ = SS.upload_step(_int32_state(state), int(ig), conn0,
                                      gate0)
        return not _state_equal(predicted, rescanned)

    def _delta(self, window, Cw, state, ig, status, link):
        c = self._cache
        device = c.win_util.device
        keep = c.cands[:, 0] == c.winner_bit
        base = c.cands[keep]
        S = base.shape[0]
        # extend every survivor with a drawn bit for the revealed window
        # (service rng; capped so no candidate exceeds the draw-time n_max)
        n_now = base[:, 1:].sum(axis=1)
        draw = (self._rng.random(S) < c.density).astype(np.int32)
        new_bits = np.where(n_now < c.n_max, draw, 0).astype(np.int32)
        cands = np.concatenate([base[:, 1:], new_bits[:, None]], axis=1)
        keep_d = torch.as_tensor(keep, device=device)
        win_util = torch.cat(
            [c.win_util[keep_d, 1:],
             torch.zeros((S, 1), dtype=torch.float32, device=device)],
            dim=1)
        end_state = _rows(c.end_state, keep_d)
        end_ig = c.end_ig[keep_d]
        # roll ONLY the newly revealed window, only for candidates that
        # scheduled it — the full scan's marks -> hist -> featurize ->
        # predict pipeline, from the cached per-candidate frontier
        conn_new = torch.as_tensor(Cw[-1], device=device)
        gate_new = self._gate(None if link is None
                              else np.asarray(link.grant, np.int32)[-1],
                              c.need_up, c.need_dn, device)
        rows1 = np.flatnonzero(new_bits == 1)
        if rows1.size:
            r1 = torch.as_tensor(rows1, device=device)
            marks, _, _ = step_candidates(
                _rows(end_state, r1), end_ig[r1], conn_new,
                torch.ones(rows1.size, dtype=torch.int32, device=device),
                gate_new, s_max=self.s_max)
            hists = SS.hist_from_marks(marks, s_max=self.s_max,
                                       dtype=torch.int16)
            win_util[r1, -1] = self.regressor.predict_device(
                featurize_t(hists, status))
        # re-reduce at the per-row (n_cap,) shape a full rescan uses; the
        # fixed-order sum gives each row the full rescan's bits
        idx, mask = event_positions(cands)
        util_ev = torch.take_along_dim(
            win_util, torch.as_tensor(idx.astype(np.int64), device=device),
            dim=1)
        scores = _event_sum(util_ev, torch.as_tensor(
            mask, dtype=torch.float32, device=device))[0].cpu().numpy()
        w = select_candidate(cands, scores)
        # roll the cache forward; the frontier advance is deferred to
        # maintain() so it stays off the answer path
        c.window = window
        c.cands = cands
        c.Cw = Cw.copy()
        if link is not None:
            c.grant = np.asarray(link.grant, np.int32).copy()
        c.win_util = win_util
        c.end_state = end_state
        c.end_ig = end_ig
        c.pre_state = _int32_state(state)
        c.pre_ig = int(ig)
        c.winner_bit = int(cands[w, 0])
        c.pending = (conn_new, gate_new)
        return cands[w].copy()
