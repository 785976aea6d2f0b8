"""Utility-function estimation (paper §3.2, eq. 12), the port of
`repro.core.utility`.

The GS (i) trains a model on a source dataset and stores the checkpoint
trajectory {w^0..w^Imax}; (ii) samples (staleness vector s, training status
T) pairs; (iii) measures the loss drop Δf of applying the staleness-vector's
local updates to w^{i_start}; (iv) fits a regression model û(φ(s), T) ≈ Δf.

Featurization φ: the histogram of staleness values (counts of gradients at
each staleness 0..s_max) + total count + staleness-compensated mass + mean
staleness + T — the feature the schedule simulator
(`repro_torch.core.staleness`) emits, so the search scores candidates
without per-satellite vectors.

Two regressors: a random forest (paper-faithful: "a standard random forest
regression"), fitted in numpy on the host exactly as the reference fits
it, with a tensor traversal for device-side prediction; and a small MLP
(beyond-paper), trained in PyTorch. The numpy pieces (`featurize`, the
CART fit, the sample draws) are copies of the reference's, so the same
inputs give the same integers and the same trees.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def featurize(hist: np.ndarray, status: float) -> np.ndarray:
    """hist: (..., s_max+1) counts; status: scalar training status T.

    Features: raw histogram + derived physical quantities the utility
    actually depends on — total count (direction variance ~ 1/count under
    eq. 4 normalization), staleness-compensated mass sum_s hist_s * c(s),
    and mean staleness — plus T."""
    hist = np.asarray(hist, np.float32)
    total = hist.sum(axis=-1, keepdims=True)
    s_vals = np.arange(hist.shape[-1], dtype=np.float32)
    c = (s_vals + 1.0) ** -0.5
    fresh_mass = (hist * c).sum(axis=-1, keepdims=True)
    mean_stale = (hist * s_vals).sum(axis=-1, keepdims=True) \
        / np.maximum(total, 1.0)
    stat = np.broadcast_to(np.float32(status), total.shape)
    return np.concatenate([hist, total, fresh_mass, mean_stale, stat],
                          axis=-1)


def featurize_t(hist: torch.Tensor, status: float) -> torch.Tensor:
    """`featurize` on an integer-count tensor, on its device (the
    reference's `featurize_jnp`). The c(s) table is built in numpy
    float32, so both paths share the exact constants.

    The staleness-compensated mass is the one float sum of the features.
    XLA computes it as a chain of fmas over s = 0..s_max; here each link
    is taken in float64, where the count times c(s) and its sum with the
    float32 running total are exact (counts below 2^15), and rounded once
    to float32: that fma's result, bit for bit, on every device. (The
    host `featurize` sums in numpy's order, within 2 ulps of it.) The
    other sums are of integers, exact in any order."""
    s1 = hist.shape[-1]
    c = (np.arange(s1, dtype=np.float32) + 1.0) ** -0.5
    hd = hist.double()
    fresh = torch.zeros(hist.shape[:-1], dtype=torch.float64,
                        device=hist.device)
    for s in range(s1):
        fresh = fresh.add(hd[..., s], alpha=float(c[s])).float().double()
    hist = hist.float()
    total = hist.sum(dim=-1, keepdim=True)
    s_vals = torch.arange(s1, dtype=torch.float32, device=hist.device)
    fresh_mass = fresh.float()[..., None]
    mean_stale = (hist * s_vals).sum(dim=-1, keepdim=True) \
        / total.clamp(min=1.0)
    stat = torch.full_like(total, float(np.float32(status)))
    return torch.cat([hist, total, fresh_mass, mean_stale, stat], dim=-1)


def n_features(s_max: int) -> int:
    """Width of `featurize`'s output: the raw histogram (s_max+1) plus
    total count, staleness-compensated fresh mass, mean staleness, and the
    training status T. Depends only on `s_max`, never on K — which is what
    makes a fitted regressor transferable across constellations."""
    return s_max + 5


def transfer_ready(regressor, *, s_max: int = 8) -> bool:
    """True when `regressor` can serve eq.-13 schedule searches on any
    constellation at this `s_max` without refitting: a matching feature
    width (when the regressor records one at fit time) and a device
    prediction path."""
    nf = getattr(regressor, "n_features_", None)
    if nf is not None and int(nf) != n_features(s_max):
        return False
    return callable(getattr(regressor, "predict_device", None))


def transfer_report(regressor, feats) -> dict:
    """How a feature batch from another constellation than the fit sits
    relative to the regressor's training envelope, plus a prediction
    summary: rows, finite, in_envelope and out_features (only when the
    regressor recorded an envelope), pred_min/pred_max/pred_finite. Tree
    ensembles extrapolate as constants, so `in_envelope` below 1.0 flags
    reduced resolution, not invalid predictions."""
    X = np.asarray(feats, np.float32)
    if X.ndim == 1:
        X = X[None, :]
    out = {"rows": int(X.shape[0]),
           "finite": bool(np.isfinite(X).all())}
    lo = getattr(regressor, "feature_low_", None)
    hi = getattr(regressor, "feature_high_", None)
    if lo is not None and hi is not None:
        inside = (X >= lo) & (X <= hi)
        out["in_envelope"] = float(inside.mean())
        out["out_features"] = [int(j) for j in
                               np.flatnonzero(~inside.all(axis=0))]
    preds = np.asarray(regressor.predict(X))
    out["pred_min"] = float(preds.min())
    out["pred_max"] = float(preds.max())
    out["pred_finite"] = bool(np.isfinite(preds).all())
    return out


def _record_envelope(regressor, X):
    """Remember the fit's feature width and per-feature range for
    `transfer_ready` / `transfer_report`. Predictions are untouched."""
    regressor.n_features_ = int(X.shape[1])
    regressor.feature_low_ = X.min(axis=0)
    regressor.feature_high_ = X.max(axis=0)


# ---------------------------------------------------------------------------
# Random forest (numpy CART ensemble)


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


@dataclass(frozen=True)
class ForestArrays:
    """Structure-of-arrays view of a fitted forest: (n_trees, max_nodes)
    per-node fields, leaf-padded so every tree shares one node axis.
    `feature < 0` marks a leaf; leaf left/right self-loop to node 0 so the
    level-wise traversal is branch-free."""
    feature: np.ndarray    # (T, M) int32, -1 at leaves / padding
    thresh: np.ndarray     # (T, M) f32
    left: np.ndarray       # (T, M) int32
    right: np.ndarray      # (T, M) int32
    value: np.ndarray      # (T, M) f32
    depth: int             # max root-to-leaf edge count


def forest_to_arrays(trees: List[List[_Node]], max_depth: int
                     ) -> ForestArrays:
    T = len(trees)
    M = max(len(t) for t in trees)
    feature = np.full((T, M), -1, np.int32)
    thresh = np.zeros((T, M), np.float32)
    left = np.zeros((T, M), np.int32)
    right = np.zeros((T, M), np.int32)
    value = np.zeros((T, M), np.float32)
    for ti, nodes in enumerate(trees):
        for ni, n in enumerate(nodes):
            feature[ti, ni] = n.feature
            thresh[ti, ni] = n.thresh
            left[ti, ni] = max(n.left, 0)
            right[ti, ni] = max(n.right, 0)
            value[ti, ni] = n.value
    return ForestArrays(feature, thresh, left, right, value, max_depth)


def forest_predict_np(fa: ForestArrays, X: np.ndarray) -> np.ndarray:
    """Vectorized level-wise traversal: every (tree, row) pair walks one
    level per iteration; rows already at a leaf stay put. Bit-matches the
    per-row node walk (same leaf values, same f32 mean over trees)."""
    X = np.asarray(X, np.float32)
    T, N = fa.feature.shape[0], X.shape[0]
    rows = np.arange(T)[:, None]
    cols = np.arange(N)[None, :]
    idx = np.zeros((T, N), np.int32)
    for _ in range(fa.depth):
        f = fa.feature[rows, idx]
        leaf = f < 0
        xv = X[cols, np.clip(f, 0, X.shape[1] - 1)]
        go_left = xv <= fa.thresh[rows, idx]
        nxt = np.where(go_left, fa.left[rows, idx], fa.right[rows, idx])
        idx = np.where(leaf, idx, nxt)
    return fa.value[rows, idx].mean(axis=0)


def _forest_leaves_t(feature, thresh, left, right, value, offsets, X,
                     depth: int):
    """Level-wise traversal over the flattened forest on X's device: the
    (T, N) leaf values. Node fields are 1-D (total_nodes,) tensors (int64
    indices, as `torch.take` wants) and `offsets` (T, 1) holds each tree's
    root index; left/right store tree-local child indices, hence the
    `offsets +` rebase each level. `depth` levels, unrolled in Python."""
    T = offsets.shape[0]
    N, F = X.shape
    Xf = X.reshape(-1)
    cols = torch.arange(N, device=X.device)[None, :] * F
    idx = offsets.expand(T, N)
    for _ in range(depth):
        f = torch.take(feature, idx)
        xv = torch.take(Xf, cols + f.clamp(0, F - 1))
        go_left = xv <= torch.take(thresh, idx)
        nxt = offsets + torch.where(go_left, torch.take(left, idx),
                                    torch.take(right, idx))
        idx = torch.where(f < 0, idx, nxt)
    return torch.take(value, idx)


class RandomForestRegressor:
    def __init__(self, n_trees: int = 40, max_depth: int = 6,
                 min_leaf: int = 4, feature_frac: float = 0.8,
                 seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.feature_frac = feature_frac
        self.seed = seed
        self.trees: List[List[_Node]] = []
        self._arrays: Optional[ForestArrays] = None
        self._device_arrays = {}      # torch.device -> flat node tensors

    def _build(self, X, y, rng) -> List[_Node]:
        nodes: List[_Node] = []

        def grow(idx, depth) -> int:
            node = _Node(value=float(y[idx].mean()))
            nodes.append(node)
            me = len(nodes) - 1
            if depth >= self.max_depth or len(idx) < 2 * self.min_leaf \
                    or np.ptp(y[idx]) < 1e-12:
                return me
            nf = max(1, int(X.shape[1] * self.feature_frac))
            feats = rng.choice(X.shape[1], nf, replace=False)
            best = (None, None, np.inf)
            for f in feats:
                xs = X[idx, f]
                order = np.argsort(xs)
                xs_s, ys_s = xs[order], y[idx][order]
                csum = np.cumsum(ys_s)
                csq = np.cumsum(ys_s ** 2)
                n = len(ys_s)
                for cut in range(self.min_leaf, n - self.min_leaf):
                    if xs_s[cut] == xs_s[cut - 1]:
                        continue
                    ln, rn = cut, n - cut
                    lsum, lsq = csum[cut - 1], csq[cut - 1]
                    rsum, rsq = csum[-1] - lsum, csq[-1] - lsq
                    sse = (lsq - lsum ** 2 / ln) + (rsq - rsum ** 2 / rn)
                    if sse < best[2]:
                        best = (f, (xs_s[cut] + xs_s[cut - 1]) / 2, sse)
            if best[0] is None:
                return me
            f, t, _ = best
            mask = X[idx, f] <= t
            node.feature, node.thresh = int(f), float(t)
            node.left = grow(idx[mask], depth + 1)
            node.right = grow(idx[~mask], depth + 1)
            return me

        grow(np.arange(len(y)), 0)
        return nodes

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_trees):
            boot = rng.integers(0, len(y), len(y))
            self.trees.append(self._build(X[boot], y[boot], rng))
        self._arrays = None
        self._device_arrays = {}
        _record_envelope(self, X)
        return self

    def arrays(self) -> ForestArrays:
        """Structure-of-arrays view, built once per fit."""
        if self._arrays is None:
            self._arrays = forest_to_arrays(self.trees, self.max_depth)
        return self._arrays

    def _predict_tree(self, nodes: List[_Node], X) -> np.ndarray:
        out = np.empty(len(X), np.float32)
        for i, x in enumerate(X):
            n = 0
            while nodes[n].feature >= 0:
                n = nodes[n].left if x[nodes[n].feature] <= nodes[n].thresh \
                    else nodes[n].right
            out[i] = nodes[n].value
        return out

    def predict_reference(self, X) -> np.ndarray:
        """Per-row, per-tree node walk — the O(rows * trees) pure-Python
        oracle the vectorized paths are tested against."""
        X = np.asarray(X, np.float32)
        return np.mean([self._predict_tree(t, X) for t in self.trees],
                       axis=0)

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        return forest_predict_np(self.arrays(), X)

    def _on(self, device):
        """The flat node tensors on `device`, made once per device."""
        if device not in self._device_arrays:
            fa = self.arrays()
            T, M = fa.feature.shape
            offsets = (np.arange(T, dtype=np.int64) * M)[:, None]
            self._device_arrays[device] = tuple(
                torch.as_tensor(a.reshape(-1), device=device)
                for a in (fa.feature.astype(np.int64), fa.thresh,
                          fa.left.astype(np.int64),
                          fa.right.astype(np.int64), fa.value)) \
                + (torch.as_tensor(offsets, device=device),)
        return self._device_arrays[device]

    def leaf_values_device(self, X: torch.Tensor) -> torch.Tensor:
        """(n_trees, N) leaf value of every (tree, row), on X's device."""
        return _forest_leaves_t(*self._on(X.device), X.float(),
                                self.arrays().depth)

    def predict_device(self, X: torch.Tensor) -> torch.Tensor:
        """Prediction on a feature tensor, on its device (the search feeds
        simulator histograms straight in with no host round-trip)."""
        return self.leaf_values_device(X).mean(dim=0)


# ---------------------------------------------------------------------------
# MLP regressor (beyond-paper alternative)


def _mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


class MLPRegressor:
    """Two tanh layers over standardized features, full-batch SGD with
    momentum 0.9, as the reference's. Its parameters are a dict of float32
    tensors on the host, drawn from a `torch.Generator` seeded with
    `seed` (other numbers than the reference's `jax.random` draw; carry a
    reference fit across with `repro_torch.weights.mlp_regressor_from_numpy`)."""

    def __init__(self, hidden: int = 64, steps: int = 800, lr: float = 1e-2,
                 seed: int = 0):
        self.hidden = hidden
        self.steps = steps
        self.lr = lr
        self.seed = seed
        self.params = None
        self.mu = self.sd = self.ymu = self.ysd = None
        self._device_params = {}

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-6
        self.ymu, self.ysd = y.mean(), y.std() + 1e-9
        _record_envelope(self, X)
        Xn = torch.as_tensor((X - self.mu) / self.sd)
        yn = torch.as_tensor((y - self.ymu) / self.ysd)
        g = torch.Generator().manual_seed(self.seed)
        F, H = X.shape[1], self.hidden
        p = {"w1": torch.randn(F, H, generator=g) / np.sqrt(F),
             "b1": torch.zeros(H),
             "w2": torch.randn(H, H, generator=g) / np.sqrt(H),
             "b2": torch.zeros(H),
             "w3": torch.randn(H, 1, generator=g) / np.sqrt(H),
             "b3": torch.zeros(1)}
        m = tree_map(torch.zeros_like, p)
        for _ in range(self.steps):
            leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
            loss = torch.mean((_mlp_apply(p, Xn) - yn) ** 2)
            grads = dict(zip(sorted(p), torch.autograd.grad(
                loss, leaves)))
            with torch.no_grad():
                m = {k: 0.9 * m[k] + grads[k] for k in p}
                p = {k: (p[k] - self.lr * m[k]).detach() for k in p}
        self.params = p
        self._device_params = {}
        return self

    def predict(self, X) -> np.ndarray:
        Xn = (np.asarray(X, np.float32) - self.mu) / self.sd
        with torch.no_grad():
            out = _mlp_apply(self.params, torch.as_tensor(Xn)).numpy()
        return out * self.ysd + self.ymu

    def predict_device(self, X: torch.Tensor) -> torch.Tensor:
        """Prediction on a feature tensor, on its device."""
        dev = X.device
        if dev not in self._device_params:
            self._device_params[dev] = tree_map(
                lambda t: t.to(dev), {**self.params,
                                      "mu": torch.as_tensor(self.mu),
                                      "sd": torch.as_tensor(self.sd)})
        p = self._device_params[dev]
        with torch.no_grad():
            Xn = (X.float() - p["mu"]) / p["sd"]
            return _mlp_apply(p, Xn) * float(self.ysd) + float(self.ymu)


# ---------------------------------------------------------------------------
# Sample generation (eq. 12)


def generate_utility_samples(
        checkpoints: List,                    # {w^0..w^Imax} trees
        client_update_fn: Callable,           # (params, client_idx, rng)->upd
        eval_loss_fn: Callable,               # params -> float
        *,
        num_clients: int,
        n_samples: int = 200,
        s_max: int = 8,
        clients_per_sample: int = 48,
        participate_p=None,
        seed: int = 0,
        batch_fn: Optional[Callable] = None,
        batched_update_fn: Optional[Callable] = None,
        batched_loss_fn: Optional[Callable] = None,
        eval_chunk: int = 64):
    """Returns (features (N,F), targets ΔF (N,)). Each sample: draw i_start
    and a staleness vector over a client subset, apply eq. 12 against the
    checkpoint trajectory and record the loss drop. (The reference's
    first argument, a `jax.random` key that nothing reads, is dropped.)

    The participation fraction is drawn per sample from U(0.1, 1.0) so the
    regressor sees the full range of aggregation sizes the scheduler will
    encounter. Updates are normalized by the participating count, matching
    eq. 4. The draws come from `np.random.default_rng(seed)` in the
    reference's order, so the integer staleness histograms (and thus the
    features but T) equal the reference's.

    When the batched machinery is supplied — ``batch_fn(ci, rng_int)``
    returning the client's training batch (or None for an empty shard),
    ``batched_update_fn(base, stacked_batches)`` (e.g.
    `repro_torch.fl.client.make_batched_client_update`), and
    ``batched_loss_fn(stacked_params) -> (M,) losses`` — generation is
    vectorized: sampled client updates are grouped by base checkpoint and
    batch shape, each group padded to a power of two and trained in one
    batched call, and every perturbed checkpoint evaluated in batched loss
    calls. A group's updates reach their samples through one dense
    (n_samples, bucket) weight matrix times the group's update rows per
    leaf (`torch.matmul`): a fixed order of sums, so the targets repeat
    bit for bit on the card, where `index_add_` would sum with atomics.
    Targets agree with the loop path to float tolerance."""
    rng = np.random.default_rng(seed)
    Imax = len(checkpoints) - 1
    vectorized = (batch_fn is not None and batched_update_fn is not None
                  and batched_loss_fn is not None)

    # --- draws (one rng stream, identical for both execution paths)
    plans = []   # per sample: (i_start, hist, n_part, any participant)
    items = []   # flattened work list: (sample, base ckpt idx, ci, rng_int)
    for n in range(n_samples):
        i_start = int(rng.integers(min(s_max, Imax - 1) if Imax > s_max
                                   else 0, Imax))
        clients = rng.choice(num_clients, min(clients_per_sample,
                                              num_clients), replace=False)
        s_vec = np.full(len(clients), -1, np.int64)
        p_this = (rng.uniform(0.1, 1.0) if participate_p is None
                  else participate_p)
        part = rng.random(len(clients)) < p_this
        s_vec[part] = rng.integers(0, min(s_max, i_start) + 1,
                                   part.sum())
        n_part = max(int(part.sum()), 1)
        items += [(n, i_start - int(s), int(ci),
                   int(rng.integers(0, 2 ** 31)))
                  for ci, s in zip(clients, s_vec) if s >= 0]
        hist = np.bincount(s_vec[s_vec >= 0], minlength=s_max + 1
                           )[:s_max + 1]
        plans.append((i_start, hist, n_part, bool(part.sum())))

    if not vectorized:
        return _samples_loop(checkpoints, client_update_fn, eval_loss_fn,
                             plans, items)

    # --- vectorized path: train grouped by base checkpoint ...
    totals = tree_map(lambda l: torch.zeros((n_samples,) + tuple(l.shape),
                                            dtype=l.dtype, device=l.device),
                      checkpoints[0])
    device = tree_leaves(totals)[0].device
    seg_all = np.asarray([it[0] for it in items], np.int64)
    w_all = np.asarray([1.0 / plans[it[0]][2] for it in items], np.float32)
    by_base = {}
    for idx, it in enumerate(items):
        by_base.setdefault(it[1], []).append(idx)
    for base_i, idxs in by_base.items():
        by_shape = {}   # batch-shape signature -> rows (into items)
        for idx in idxs:
            b = batch_fn(items[idx][2], items[idx][3])
            if b is None:        # empty shard: exact-zero update, skip
                continue
            sig = tuple(tuple(leaf.shape) for leaf in b)
            by_shape.setdefault(sig, []).append((idx, b))
        for mem in by_shape.values():
            m = len(mem)
            bucket = 1 << (m - 1).bit_length()
            # padded rows repeat the first batch and carry zero weight
            blist = [b for _, b in mem] + [mem[0][1]] * (bucket - m)
            batches = tuple(torch.stack(ts) for ts in zip(*blist))
            upd = batched_update_fn(checkpoints[base_i], batches)
            rows = [idx for idx, _ in mem]
            W = np.zeros((n_samples, bucket), np.float32)
            W[seg_all[rows], np.arange(m)] = w_all[rows]
            W = torch.as_tensor(W, device=device)
            totals = tree_map(
                lambda t, u: t + torch.matmul(
                    W, u.reshape(bucket, -1)).reshape(t.shape),
                totals, upd)

    # --- ... and evaluate every base/perturbed checkpoint in batched calls
    i_starts = np.asarray([p[0] for p in plans])
    distinct = sorted(set(int(i) for i in i_starts))
    base_stack = tree_map(lambda *ls: torch.stack(ls),
                          *[checkpoints[i] for i in distinct])
    T_by = dict(zip(distinct, batched_loss_fn(base_stack).double().cpu()
                    .numpy()))
    lookup = torch.as_tensor([distinct.index(int(i)) for i in i_starts],
                             device=device)
    new_loss = np.empty(n_samples, np.float64)
    for c0 in range(0, n_samples, eval_chunk):
        # materialize base + total only per chunk, so eval_chunk bounds
        # the memory on top of the `totals` accumulator
        lk = lookup[c0:c0 + eval_chunk]
        sl = tree_map(lambda b, t: b[lk] + t[c0:c0 + eval_chunk],
                      base_stack, totals)
        new_loss[c0:c0 + eval_chunk] = \
            batched_loss_fn(sl).double().cpu().numpy()

    feats, targets = [], []
    for n, (i_start, hist, _, any_part) in enumerate(plans):
        T = float(T_by[i_start])
        d_f = T - float(new_loss[n]) if any_part else 0.0
        feats.append(featurize(hist, T))
        targets.append(d_f)
    return np.stack(feats), np.asarray(targets, np.float32)


def _samples_loop(checkpoints, client_update_fn, eval_loss_fn, plans,
                  items):
    """The per-sample/per-client loop (the reference path, and for callers
    without batched machinery): one client-update call and one loss
    evaluation per sample."""
    losses = {}

    def loss_at(i):
        if i not in losses:
            losses[i] = float(eval_loss_fn(checkpoints[i]))
        return losses[i]

    per_sample = [[] for _ in plans]
    for it in items:
        per_sample[it[0]].append(it)
    feats, targets = [], []
    for n, (i_start, hist, n_part, _) in enumerate(plans):
        total_update = None
        for _, base_i, ci, rng_int in per_sample[n]:
            upd = client_update_fn(checkpoints[base_i], ci, rng_int)
            upd = tree_map(lambda x: x / n_part, upd)
            total_update = upd if total_update is None else tree_map(
                lambda a, b: a + b, total_update, upd)
        T = loss_at(i_start)
        if total_update is None:
            d_f = 0.0
        else:
            new = tree_map(lambda w, u: w + u, checkpoints[i_start],
                           total_update)
            d_f = T - float(eval_loss_fn(new))
        feats.append(featurize(hist, T))
        targets.append(d_f)
    return np.stack(feats), np.asarray(targets, np.float32)
