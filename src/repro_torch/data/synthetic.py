"""Synthetic datasets statistically matched to the paper's 1-key benchmarks.

A copy of the reference generators (pure numpy, same seeds, same arrays):

    HKI   0.9M (timestamp, index value)      -> MAX queries
    TWEET 1M   (latitude,)                   -> COUNT queries (1 key)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["hki_series", "tweet_latitudes", "make_queries_1d"]


def hki_series(n: int = 900_000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(timestamps, index values): minute-bar random walk around ~30_000
    (the Hang-Seng-like level of the paper's HK-40 2018 dataset)."""
    rng = np.random.default_rng(seed)
    # trading-minute timestamps with gaps (sessions), strictly increasing
    t = np.cumsum(rng.uniform(0.5, 1.5, n))
    # GBM-ish walk with intraday noise and occasional jumps
    steps = rng.normal(0, 12.0, n) + rng.normal(0, 80.0, n) * (rng.uniform(size=n) < 0.002)
    level = 30_000 + np.cumsum(steps)
    level = np.maximum(level, 1000.0)
    return t, level


def tweet_latitudes(n: int = 1_000_000, seed: int = 1) -> np.ndarray:
    """1-D latitudes: mixture of city clusters + sparse background, in
    [-60, 70] — the skew profile of geotagged tweet latitudes."""
    rng = np.random.default_rng(seed)
    centers = np.array([40.7, 34.0, 51.5, 48.8, 35.7, 19.4, -23.5, 1.3, 28.6, -33.9])
    weights = np.array([.2, .14, .12, .08, .1, .08, .08, .06, .08, .06])
    comp = rng.choice(len(centers), size=n, p=weights)
    lat = centers[comp] + rng.normal(0, 1.5, n)
    bg = rng.uniform(-60, 70, n)
    take_bg = rng.uniform(size=n) < 0.05
    lat = np.where(take_bg, bg, lat)
    return np.clip(lat, -60, 70)


def make_queries_1d(keys: np.ndarray, n_queries: int = 1000, seed: int = 7,
                    selectivity: float | None = None):
    """Paper §7.1: endpoints drawn from the dataset's keys.  With
    ``selectivity`` set, ranges cover ~that fraction of sorted keys."""
    rng = np.random.default_rng(seed)
    k = np.sort(np.asarray(keys, np.float64))
    n = len(k)
    if selectivity is None:
        a = k[rng.integers(0, n, n_queries)]
        b = k[rng.integers(0, n, n_queries)]
        return np.minimum(a, b), np.maximum(a, b)
    span = max(1, int(selectivity * n))
    i0 = rng.integers(0, max(1, n - span), n_queries)
    return k[i0], k[np.minimum(i0 + span, n - 1)]
