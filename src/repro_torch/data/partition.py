"""Dataset partitioning across satellites (paper §4.1).

IID: shuffle and split uniformly across the K satellites.
Non-IID: partition samples by UTM zone; for each zone, find the satellites
whose ground track passes over it during the simulated days and assign the
zone's samples across those satellites proportionally to their number of
visits — yielding skewed labels and heterogeneous sample counts, as in the
paper.

The port's own numpy copy of `repro.data.partition`: identical shards
from identical inputs.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import connectivity as CN
from repro_torch.data.fmow import NUM_UTM_ZONES


def iid_partition(num_samples: int, K: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_samples)
    return [np.sort(p) for p in np.array_split(perm, K)]


LAT_EDGES = np.array([-90.0, -45.0, -15.0, 15.0, 45.0, 90.0])
N_LON = NUM_UTM_ZONES // (len(LAT_EDGES) - 1)   # 12 lon bands x 5 lat bands


def ground_track_zone_visits(spec: CN.ConstellationSpec, *,
                             days: float = 5.0, step_s: float = 120.0
                             ) -> np.ndarray:
    """(K, NUM_UTM_ZONES) visit counts: how often each satellite's subpoint
    falls in each (longitude-band x latitude-band) cell. Latitude matters:
    ISS-inclination satellites never overfly polar cells, sun-synchronous
    ones concentrate there — the source of the paper's per-satellite data
    heterogeneity."""
    times = np.arange(int(days * 86400 / step_s)) * step_s
    pos = CN.satellite_positions_eci(spec, times)          # (T,K,3)
    r = np.linalg.norm(pos, axis=-1)
    lat = np.degrees(np.arcsin(pos[..., 2] / r))           # (T,K)
    lon_eci = np.arctan2(pos[..., 1], pos[..., 0])
    lon = (lon_eci - (CN.OMEGA_EARTH * times)[:, None] + np.pi) \
        % (2 * np.pi) - np.pi
    lon_band = ((np.degrees(lon) + 180.0) // (360.0 / N_LON)
                ).astype(int) % N_LON
    lat_band = np.clip(np.searchsorted(LAT_EDGES, lat) - 1, 0,
                       len(LAT_EDGES) - 2)
    zone = lat_band * N_LON + lon_band
    K = pos.shape[1]
    visits = np.zeros((K, NUM_UTM_ZONES), np.int64)
    for k in range(K):
        visits[k] = np.bincount(zone[:, k], minlength=NUM_UTM_ZONES)
    return visits


def noniid_partition(sample_zones: np.ndarray, K: int,
                     spec: CN.ConstellationSpec, *, days: float = 5.0,
                     sharpen: float = 3.0, top_frac: float = 0.25,
                     seed: int = 0) -> List[np.ndarray]:
    """Assign each UTM zone's samples across the satellites that visit it,
    proportional to visit counts (paper §4.1).

    Deviation note (DESIGN.md §7): a satellite only downlinks imagery it
    captured while *directly overflying* a cell, so ownership concentrates
    among the most frequent visitors. We model that by keeping the top
    `top_frac` visitors per zone and sharpening weights with visits^sharpen
    — without this the 120 s-step ground tracks visit every cell and the
    partition degenerates to IID."""
    rng = np.random.default_rng(seed)
    visits = ground_track_zone_visits(spec, days=days)     # (K, Z)
    parts: List[list] = [[] for _ in range(K)]
    m = max(1, int(K * top_frac))
    for z in range(NUM_UTM_ZONES):
        idx = np.flatnonzero(sample_zones == z)
        if len(idx) == 0:
            continue
        rng.shuffle(idx)
        w = visits[:, z].astype(np.float64)
        if w.sum() == 0:
            w = np.ones(K)
        top = np.argsort(w)[-m:]
        wt = w[top] ** sharpen
        p = wt / wt.sum()
        owners = top[rng.choice(m, len(idx), p=p)]
        for i, o in zip(idx, owners):
            parts[o].append(i)
    return [np.sort(np.asarray(p, np.int64)) for p in parts]


def partition_stats(parts: List[np.ndarray], labels: np.ndarray) -> dict:
    sizes = np.array([len(p) for p in parts])
    # label-distribution skew: mean TV distance from global distribution
    gl = np.bincount(labels, minlength=labels.max() + 1).astype(float)
    gl /= gl.sum()
    tvs = []
    for p in parts:
        if len(p) == 0:
            continue
        d = np.bincount(labels[p], minlength=len(gl)).astype(float)
        d /= d.sum()
        tvs.append(0.5 * np.abs(d - gl).sum())
    return {"size_min": int(sizes.min()), "size_max": int(sizes.max()),
            "size_mean": float(sizes.mean()),
            "tv_mean": float(np.mean(tvs))}
