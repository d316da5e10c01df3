"""Segmentation of the exact function F(k) into minimax-fitted intervals.

The twin of ``repro.core.segmentation``:

* ``greedy_segmentation`` — the paper's GS (Alg. 1) accelerated with
  exponential (doubling + binary) search, exactly as §4.2.1 describes.  GS is
  optimal (Thm 4.3) because E(I) is monotone under interval growth
  (Lemma 4.2); the doubling search relies on the same monotonicity.
* ``dp_segmentation``     — the O(n² · fit) dynamic program the paper cites
  [42]; used in tests to verify GS optimality on small inputs.
* ``parallel_segmentation`` — lockstep-chunked GS: every chunk's next
  exponential/binary-search probe of a round is fitted in one
  ``lawson_batched`` call on the device (the card by default), and the
  accepted segments are re-certified with the exact fitter on the host.
* ``FastAcceptFitter`` — the least-squares screen in front of the LP.

All fitters receive (keys, values) = (k_i, F(k_i)) for the keys inside the
candidate interval and return a PolyModel whose ``err`` field certifies
max_i |F(k_i) - P(k_i)| — the quantity the δ-guarantees are built on.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .. import resolve_device
from .fitting import (PolyModel, fit_lstsq, fit_minimax_lawson, fit_minimax_lp,
                      lawson_batched)

__all__ = ["greedy_segmentation", "dp_segmentation", "parallel_segmentation",
           "FastAcceptFitter", "Fitter"]

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


def dp_segmentation(
    keys: np.ndarray,
    values: np.ndarray,
    deg: int,
    delta: float,
    fitter: Fitter = fit_minimax_lp,
) -> List[PolyModel]:
    """O(n^2) optimal DP (reference implementation for tests).

    dp[i] = min #segments covering keys[:i]; transition over all j<i with
    feasible fit on keys[j:i].  Uses Lemma 4.2 to prune: for fixed i, as j
    decreases the interval grows, so once infeasible we can stop.
    """
    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    n = len(keys)
    INF = 10**9
    dp = [0] + [INF] * n
    choice = [None] * (n + 1)
    for i in range(1, n + 1):
        for j in range(i - 1, -1, -1):
            m, ok = _feasible(fitter, keys[j:i], values[j:i], deg, delta)
            if not ok:
                break  # Lemma 4.2: larger intervals only get worse
            if dp[j] + 1 < dp[i]:
                dp[i] = dp[j] + 1
                choice[i] = (j, m)
    segs: List[PolyModel] = []
    i = n
    while i > 0:
        j, m = choice[i]
        segs.append(m)
        i = j
    segs.reverse()
    return segs


class _ChunkState:
    """Exponential-search state machine for one chunk's greedy cursor."""

    __slots__ = ("base", "end", "cursor", "phase", "lo_len", "step", "hi_len",
                 "done")

    def __init__(self, base: int, end: int):
        self.base = base        # chunk's first key (global index)
        self.end = end          # chunk's one-past-last key
        self.cursor = base      # current segment's left endpoint
        self.phase = "grow"     # 'grow' | 'binary'
        self.lo_len = 1         # last known-feasible length
        self.step = 0
        self.hi_len = 0
        self.done = base >= end


def parallel_segmentation(
    keys: np.ndarray,
    values: np.ndarray,
    deg: int,
    delta: float,
    chunks: int = 64,
    iters: int = 40,
    verify_lp: bool = True,
    fitter: Fitter = fit_minimax_lp,
    device=None,
) -> List[PolyModel]:
    """Lockstep-chunked GS with the probes fitted on ``device`` (the card
    by default).

    The key domain is split into ``chunks`` equal pieces whose greedy scans
    run *in lockstep*: each round gathers every active chunk's next
    exponential/binary-search probe interval and evaluates all of them in a
    single ``lawson_batched`` call (padded to the round's max length).
    Segment count grows by at most C-1 over sequential GS (forced breaks at
    chunk boundaries).  Final segments are re-certified with the exact
    fitter (``verify_lp``) on the host so stored certificates equal the
    paper's E(I); a Lawson under-certification shrinks the segment, and
    greedy GS repairs any gap that leaves.
    """
    dev = resolve_device(device)
    keys64 = np.asarray(keys, np.float64)
    values64 = np.asarray(values, np.float64)
    n = len(keys64)
    if n == 0:
        return []
    # each forced chunk boundary can add one segment vs sequential GS: cap
    # chunk count so the overhead stays small relative to the data size
    chunks = max(1, min(chunks, n // 4096, n))
    bounds = np.linspace(0, n, chunks + 1).astype(np.int64)
    states = [_ChunkState(int(bounds[i]), int(bounds[i + 1]))
              for i in range(chunks)]
    # per-chunk list of (start, length) accepted segments
    accepted: List[List[tuple]] = [[] for _ in range(chunks)]

    def _probe_interval(st: _ChunkState):
        """Next probe (start, length) for a chunk, or None if settled."""
        avail = st.end - st.cursor
        if st.phase == "grow":
            length = min(st.lo_len + st.step, avail)
            return (st.cursor, length)
        if st.lo_len + 1 >= st.hi_len:   # binary
            return None
        mid = (st.lo_len + st.hi_len) // 2
        return (st.cursor, mid)

    def _advance(st: _ChunkState, length: int, feasible: bool):
        avail = st.end - st.cursor
        if st.phase == "grow":
            if feasible:
                st.lo_len = length
                if length == avail:
                    _commit(st)
                    return
                st.step *= 2
            else:
                st.hi_len = length
                st.phase = "binary"
                if st.lo_len + 1 >= st.hi_len:
                    _commit(st)
        else:
            if feasible:
                st.lo_len = length
            else:
                st.hi_len = length
            if st.lo_len + 1 >= st.hi_len:
                _commit(st)

    def _commit(st: _ChunkState):
        accepted[states.index(st)].append((st.cursor, st.lo_len))
        st.cursor += st.lo_len
        if st.cursor >= st.end:
            st.done = True
        else:
            st.phase = "grow"
            st.lo_len = 1
            st.step = max(deg + 2, 2)
            st.hi_len = 0

    for st in states:
        if not st.done:
            st.step = max(deg + 2, 2)

    while any(not st.done for st in states):
        probes = []
        probe_states = []
        for st in states:
            if st.done:
                continue
            p = _probe_interval(st)
            while p is None:  # binary settled without a probe
                _commit(st)
                if st.done:
                    break
                p = _probe_interval(st)
            if st.done or p is None:
                continue
            probes.append(p)
            probe_states.append(st)
        if not probes:
            break
        # pad shapes to powers of two, as the reference pads them: the
        # padding sets the reductions' summation order, and so the
        # errs <= delta decisions
        Lmax = 1 << int(np.ceil(np.log2(max(p[1] for p in probes))))
        B = 1 << int(np.ceil(np.log2(len(probes))))
        u = np.zeros((B, Lmax))
        F = np.zeros((B, Lmax))
        valid = np.zeros((B, Lmax))
        for b, (s, L) in enumerate(probes):
            kw = keys64[s : s + L]
            vw = values64[s : s + L]
            lo, hi = kw[0], kw[-1]
            span = hi - lo if hi > lo else 1.0
            u[b, :L] = (2.0 * kw - lo - hi) / span
            F[b, :L] = vw
            valid[b, :L] = 1.0
        to = lambda a: torch.as_tensor(a, device=dev)
        _, errs = lawson_batched(to(u), to(F), to(valid), deg, iters)
        errs = errs.cpu().numpy()
        for b, st in enumerate(probe_states):
            _advance(st, probes[b][1], bool(errs[b] <= delta))

    # certify + emit (the exact fitter restores the paper's E(I); shrink on
    # the rare Lawson under-certification)
    segs: List[PolyModel] = []
    refit = fitter if verify_lp else (
        lambda k, v, d: fit_minimax_lawson(k, v, d, iters=iters, device=dev))
    for clist in accepted:
        for (s, L) in clist:
            while L >= 1:
                m = refit(keys64[s : s + L], values64[s : s + L], deg)
                if m.err <= delta or L == 1:
                    segs.append(m)
                    break
                L = max(1, L - max(1, L // 8))
    # ensure coverage: accepted segments tile each chunk by construction;
    # shrinking above can leave a tail -> re-run greedy on any gap
    segs.sort(key=lambda m: m.lo)
    out: List[PolyModel] = []
    covered_to = 0
    for m in segs:
        i = int(np.searchsorted(keys64, m.lo, side="left"))
        if i > covered_to:
            out.extend(greedy_segmentation(keys64[covered_to:i],
                                           values64[covered_to:i],
                                           deg, delta, fitter=fitter))
        out.append(m)
        covered_to = max(covered_to,
                         int(np.searchsorted(keys64, m.hi, side="right")))
    if covered_to < n:
        out.extend(greedy_segmentation(keys64[covered_to:],
                                       values64[covered_to:],
                                       deg, delta, fitter=fitter))
    return out
