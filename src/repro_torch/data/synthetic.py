"""Synthetic datasets statistically matched to the paper's benchmarks.

A copy of the reference generators (pure numpy, same seeds, same arrays):

    HKI   0.9M (timestamp, index value)      -> MAX queries
    TWEET 1M   (latitude,)                   -> COUNT queries (1 key)
    OSM   100M (latitude, longitude)         -> COUNT queries (2 keys)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["hki_series", "tweet_latitudes", "osm_points",
           "make_queries_1d", "make_queries_2d"]


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


def osm_points(n: int = 1_000_000, seed: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """2-D (latitude, longitude) mixture: dense metro clusters, road-like
    filaments, uniform background — OSM-node-like skew."""
    rng = np.random.default_rng(seed)
    centers = np.array([
        [40.7, -74.0], [34.0, -118.2], [51.5, -0.1], [48.8, 2.3],
        [35.7, 139.7], [19.4, -99.1], [-23.5, -46.6], [1.3, 103.8],
        [28.6, 77.2], [-33.9, 151.2], [55.7, 37.6], [30.0, 31.2],
    ])
    weights = np.full(len(centers), 1 / len(centers))
    comp = rng.choice(len(centers), size=n, p=weights)
    pts = centers[comp] + rng.normal(0, 1.2, (n, 2))
    # filaments: move a third of points along random "roads"
    fil = rng.uniform(size=n) < 0.3
    tpar = rng.uniform(-8, 8, n)
    ang = rng.uniform(0, np.pi, len(centers))[comp]
    pts[fil, 0] += tpar[fil] * np.cos(ang[fil])
    pts[fil, 1] += tpar[fil] * np.sin(ang[fil])
    bg = np.stack([rng.uniform(-60, 70, n), rng.uniform(-180, 180, n)], axis=1)
    take_bg = rng.uniform(size=n) < 0.08
    pts = np.where(take_bg[:, None], bg, pts)
    lat = np.clip(pts[:, 0], -60, 70)
    lon = np.clip(pts[:, 1], -180, 180)
    return lat, lon


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


def make_queries_2d(px: np.ndarray, py: np.ndarray, n_queries: int = 1000,
                    seed: int = 7, frac: float = 0.05):
    """Rectangles sampled from the dataset (paper §7.1): centers at data
    points, extents ~frac of the data bounding box."""
    rng = np.random.default_rng(seed)
    n = len(px)
    ci = rng.integers(0, n, n_queries)
    wx = (px.max() - px.min()) * frac * rng.uniform(0.3, 1.5, n_queries)
    wy = (py.max() - py.min()) * frac * rng.uniform(0.3, 1.5, n_queries)
    x0 = px[ci] - wx / 2
    x1 = px[ci] + wx / 2
    y0 = py[ci] - wy / 2
    y1 = py[ci] + wy / 2
    return x0, x1, y0, y1
