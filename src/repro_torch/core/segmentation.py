"""Segmentation of the exact function F(k) into minimax-fitted intervals.

The twin of ``repro.core.segmentation``, greedy part:

* ``greedy_segmentation`` — the paper's GS (Alg. 1) accelerated with
  exponential (doubling + binary) search, exactly as §4.2.1 describes.  GS is
  optimal (Thm 4.3) because E(I) is monotone under interval growth
  (Lemma 4.2); the doubling search relies on the same monotonicity.
* ``FastAcceptFitter`` — the least-squares screen in front of the LP.

``dp_segmentation`` and ``parallel_segmentation`` are not ported yet
(ROADMAP Queue 1 item 7).

All fitters receive (keys, values) = (k_i, F(k_i)) for the keys inside the
candidate interval and return a PolyModel whose ``err`` field certifies
max_i |F(k_i) - P(k_i)| — the quantity the δ-guarantees are built on.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from .fitting import PolyModel, fit_lstsq, fit_minimax_lp

__all__ = ["greedy_segmentation", "FastAcceptFitter", "Fitter"]

Fitter = Callable[[np.ndarray, np.ndarray, int], PolyModel]


def _feasible(fitter: Fitter, keys, values, deg, delta):
    m = fitter(keys, values, deg)
    return m, m.err <= delta


class FastAcceptFitter:
    """Least-squares fast-accept wrapper (construction speedup, exact-safe).

    The L2 fit's max residual upper-bounds E(I): if it already satisfies
    ``delta`` the LP is skipped entirely (feasible probes — the common case
    during doubling — cost one lstsq).  Rejections fall through to the exact
    fitter; committed certificates are always the achieved max-residual of
    the stored fit.  ``post`` optionally augments a fit's certificate (e.g.
    continuum_error for MAX indexes).
    """

    def __init__(self, exact: Fitter = fit_minimax_lp, delta: float | None = None,
                 post=None, screen: bool = True):
        self.exact = exact
        self.delta = delta
        self.post = post
        self.screen = screen

    def _finish(self, m, keys, values):
        return self.post(m, keys, values) if self.post else m

    def __call__(self, keys, values, deg) -> PolyModel:
        if self.screen and self.delta is not None:
            m = self._finish(fit_lstsq(keys, values, deg), keys, values)
            if m.err <= self.delta:
                return m
        return self._finish(self.exact(keys, values, deg), keys, values)


def greedy_segmentation(
    keys: np.ndarray,
    values: np.ndarray,
    deg: int,
    delta: float,
    fitter: Fitter = fit_minimax_lp,
    use_exponential_search: bool = True,
) -> List[PolyModel]:
    """Paper Alg. 1 (GS) + exponential-search acceleration (§4.2.1).

    Scans left→right; for each left endpoint finds the maximal u with
    E([k_l, k_u]) <= delta.  Monotonicity of E (Lemma 4.2) makes doubling +
    binary search sound: if a prefix is infeasible, every extension is too.
    """
    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    n = len(keys)
    if n == 0:
        return []
    segs: List[PolyModel] = []
    l = 0
    while l < n:
        if l == n - 1:
            m = fitter(keys[l : l + 1], values[l : l + 1], deg)
            segs.append(m)
            break
        if not use_exponential_search:
            # literal Alg. 1: extend one key at a time
            prev = fitter(keys[l : l + 1], values[l : l + 1], deg)
            u = l + 1
            while u < n:
                m, ok = _feasible(fitter, keys[l : u + 1], values[l : u + 1], deg, delta)
                if not ok:
                    break
                prev = m
                u += 1
            segs.append(prev)
            l = u
            continue
        # exponential search: find smallest infeasible length by doubling
        step = max(deg + 2, 2)
        lo_len = 1                      # last known-feasible length
        best = None
        while True:
            length = min(lo_len + step, n - l)
            m, ok = _feasible(fitter, keys[l : l + length], values[l : l + length], deg, delta)
            if ok:
                best, lo_len = m, length
                if length == n - l:
                    break
                step *= 2
            else:
                break
        if best is None:
            # even the minimal extension fails -> single-key interpolation
            best = fitter(keys[l : l + 1], values[l : l + 1], deg)
            lo_len = 1
        if lo_len < n - l:
            # binary search in (lo_len, lo_len + step]
            hi_len = min(lo_len + step, n - l)
            while lo_len + 1 < hi_len:
                mid = (lo_len + hi_len) // 2
                m, ok = _feasible(fitter, keys[l : l + mid], values[l : l + mid], deg, delta)
                if ok:
                    best, lo_len = m, mid
                else:
                    hi_len = mid
        segs.append(best)
        l += lo_len
    return segs
