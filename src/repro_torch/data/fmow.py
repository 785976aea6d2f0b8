"""Synthetic fMoW-like dataset (see DESIGN.md §7 — the real Functional Map
of the World imagery is not available offline).

Mirrors the properties the paper's evaluation depends on:
  * 62 functional categories;
  * per-sample geolocation metadata (UTM zone) — the Non-IID partitioner
    assigns samples to satellites by ground-track visits per zone;
  * a learnable signal: images are class-conditional templates + noise, so a
    small CNN/MLP actually converges and time-to-accuracy is meaningful.

Two renderings of each sample: a (H, W, 3) image for the DenseNet path and a
low-dim feature vector for fast FL sweeps.

The port's own numpy copy of `repro.data.fmow`: the same spec draws the
same arrays in both packages (the label draw keeps its crc32 seeding).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

NUM_CLASSES = 62
NUM_UTM_ZONES = 60      # 12 longitude bands x 5 latitude bands
N_LAT_BANDS = 5
N_LON_BANDS = NUM_UTM_ZONES // N_LAT_BANDS


@dataclass(frozen=True)
class FmowSpec:
    num_train: int = 36_000        # 1/10 of the real 360k, same structure
    num_val: int = 5_304
    image_size: int = 16
    feature_dim: int = 32
    noise: float = 0.9
    class_skew_per_zone: float = 4.0   # zones see a biased class mix
    seed: int = 1234


class SyntheticFmow:
    def __init__(self, spec: FmowSpec = FmowSpec()):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        s = spec.image_size
        # class templates in image and feature space
        self._img_t = rng.normal(0, 1, (NUM_CLASSES, s, s, 3)).astype(
            np.float32)
        self._feat_t = rng.normal(0, 1, (NUM_CLASSES, spec.feature_dim)
                                  ).astype(np.float32)
        # zone-conditional class distribution (geography skews land use).
        # Latitude is the dominant factor: each latitude band strongly
        # prefers a contiguous block of classes (tundra vs tropics vs
        # temperate land uses), plus per-zone noise.
        zone_logits = rng.normal(0, 1, (NUM_UTM_ZONES, NUM_CLASSES))
        lat_band = np.arange(NUM_UTM_ZONES) // N_LON_BANDS       # (60,)
        block = NUM_CLASSES / N_LAT_BANDS
        centers = (lat_band + 0.5) * block                       # per zone
        dist = np.abs(np.arange(NUM_CLASSES)[None, :] - centers[:, None])
        zone_logits = zone_logits - dist / block \
            * spec.class_skew_per_zone
        self._zone_p = np.exp(zone_logits)
        self._zone_p /= self._zone_p.sum(1, keepdims=True)

        def draw(n, tag):
            # crc32, not hash(): str hashing is randomized per process,
            # which made the drawn dataset itself non-reproducible
            r = np.random.default_rng(
                spec.seed + zlib.crc32(tag.encode()) % 2 ** 16)
            zones = r.integers(0, NUM_UTM_ZONES, n)
            labels = np.array([r.choice(NUM_CLASSES, p=self._zone_p[z])
                               for z in zones], np.int64)
            return zones, labels

        self.train_zones, self.train_labels = draw(spec.num_train, "train")
        self.val_zones, self.val_labels = draw(spec.num_val, "val")

    # -- renderings ------------------------------------------------------
    def _noise_rng(self, idx, split):
        return np.random.default_rng(
            (self.spec.seed * 1_000_003 + (0 if split == "train" else 1)
             * 500_009 + int(idx)) % 2 ** 63)

    def images(self, idx: np.ndarray, split: str = "train") -> np.ndarray:
        labels = (self.train_labels if split == "train"
                  else self.val_labels)[idx]
        out = self._img_t[labels].copy()
        for j, i in enumerate(idx):
            out[j] += self._noise_rng(i, split).normal(
                0, self.spec.noise, out[j].shape).astype(np.float32)
        return out

    def features(self, idx: np.ndarray, split: str = "train") -> np.ndarray:
        labels = (self.train_labels if split == "train"
                  else self.val_labels)[idx]
        out = self._feat_t[labels].copy()
        noise = np.random.default_rng(
            self.spec.seed + (0 if split == "train" else 1)
        ).normal(0, self.spec.noise, out.shape).astype(np.float32)
        # deterministic per-index noise via hashing rows of a fixed stream
        return out + noise

    def labels(self, idx: np.ndarray, split: str = "train") -> np.ndarray:
        return (self.train_labels if split == "train"
                else self.val_labels)[idx]
