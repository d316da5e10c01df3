"""Dynamic PolyFit: delta-buffered inserts/deletes with selective refit.

The twin of ``repro.engine.dynamic``, with its serving-executor factories
(``fused_executor``, ``fused_quantile_executor``).  A static ``IndexPlan`` freezes the fitted key array;
``DynamicEngine`` makes it updatable while keeping every certified bound:

* **Delta buffers** — fixed-capacity, device-resident, sentinel-padded
  tensors (a sorted insert log and delete tombstones) with the structures
  the corrections read kept on append: exclusive prefix sums over both logs
  and, for MAX/MIN plans on the ``'cuda'`` backend, a sparse table over the
  insert log.
* **Exact correction in the query path** — every query runs the static
  plan's backend-dispatched approximation *and* an exact correction over
  the buffer: kernels K5 (``delta_sum_gather``) and K6
  (``delta_max_gather``) on ``'cuda'``, the whole-log scans K16
  (``delta_sum``) and K17 (``delta_max``) on ``'cuda_scan'``, binary
  searches into the prefix sums (SUM) or a dense masked max (MAX) on
  ``'torch'``, the one-hot oracles on ``'ref'``.  The only approximation
  error left is the static plan's own E(I) <= delta, so Lemmas 5.1-5.4
  hold over the updated data.
* **Selective refit** — when the buffer fills, or a segment's accumulated
  |measure| drift exceeds its error headroom (delta - E(I)), a merge pass
  re-fits *only* the segments whose spans contain changed keys (greedy
  segmentation on the affected windows, on the host); clean SUM/COUNT
  segments absorb the CF shift of upstream edits as a constant-coefficient
  bump, and clean MAX/MIN segments are untouched.  The new plan is
  installed by one locked pointer swap, so queries in flight keep the old
  (plan, buffer) pair; with ``background=True`` the merge runs on a worker
  thread, which also uploads the new plan and synchronizes the card before
  the swap.

MAX/MIN deletes cannot be folded into a monotone max correction (the
deleted point may *be* the maximum), so they shadow their victim instead:
the buffer carries the victim keys and a victim-masked exact sparse table
(``vic_keys``/``live_st``), queries whose range covers a victim refine to
the exact live answer, and the removal waits for the next merge.  They
also write the device delete log, which the extremum executor never reads
(as in the reference).  SUM/COUNT deletes ride the tombstone log.

Quantiles over a dynamic table (``_exec_dyn_quantile``) invert the fitted
CF against rank targets corrected by the buffer's exact prefix sums and
re-certify at each candidate key; the reference runs that loop as plain
XLA for every backend, and so does the port: plain torch, bit-identical
between ``'torch'`` and the card backends.

``DynamicEngine2D`` applies the same buffering and exact correction to
two-key COUNT/SUM rectangles and dominance MAX/MIN corners
(``DeltaBuffer2D``: x-sorted point logs, with merge-sort-tree levels on
the ``'cuda'`` backend for kernels K9-K11; the whole-log scans K18-K20 on
``'cuda_scan'`` and the dense oracles of ``kernels/ref.py`` elsewhere
read the raw logs); its merge runs ``core.index2d.selective_refit_2d``
over the touched leaves only, and dominance deletes shadow their victims
as MAX/MIN deletes do in 1-D.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import DTYPE
from ..core.exact import build_sparse_table, sparse_table_range_max
from ..core.fitting import PolyModel, fit_minimax_lp
from ..core.index import PolyFitIndex1D, _continuum_post, assemble_index_1d
from ..core.index2d import (MergeSortTree, PolyFitIndex2D,
                            mst_weighted_prefix, selective_refit_2d)
from ..core.quantile import invert_cf
from ..core.queries import QueryResult
from ..core.segmentation import FastAcceptFitter, greedy_segmentation
from ..kernels import ref as _ref
from ..kernels.delta_scan import (delta_count2d, delta_count2d_gather,
                                  delta_dommax2d, delta_dommax2d_gather,
                                  delta_max, delta_max_gather, delta_sum,
                                  delta_sum2d, delta_sum2d_gather,
                                  delta_sum_gather)
from ..kernels.locate import bsearch_count
from .engine import (QuantileResult, _no_refine, _prepare, _x_ranks,
                     check_pow2, execute_extremum, key_span,
                     prepare_fractions, quantile_mass, quantile_tables,
                     raw_count2d, raw_eval2d, raw_extremum, raw_sum,
                     resolve_backend, truth_count2d, truth_dommax2d,
                     truth_extremum, truth_sum, truth_sum2d)
from .plan import (IndexPlan, IndexPlan2D, big_sentinel, build_plan,
                   build_plan_2d)

__all__ = ["DeltaBuffer", "DeltaBuffer2D", "DynamicEngine",
           "DynamicEngine2D", "fused_executor", "fused_quantile_executor"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# device-resident delta buffers (fixed capacity)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaBuffer:
    """Sorted insert log + delete tombstones for a 1-D plan.

    Empty slots hold a huge-but-finite sentinel key (``big_sentinel``) and
    value 0, so they fail every membership test and leave the prefix sums
    flat across the tail: no correction needs the fill level.  Values live
    in *internal* space (negated for MIN plans, as in the static index).

    ``vic_keys`` holds the (sentinel-padded, sorted) keys of base rows that
    extremal deletes shadow and ``live_st`` the victim-masked exact sparse
    table over the base measures; both are None until the first extremal
    delete.  The buffer is immutable: appends build a new one.
    """

    ins_keys: torch.Tensor   # (cap,) sorted, sentinel-padded
    ins_vals: torch.Tensor   # (cap,) measures; 0 on padding
    ins_cf: torch.Tensor     # (cap+1,) exclusive prefix sum of ins_vals
    del_keys: torch.Tensor   # (cap,) sorted, sentinel-padded
    del_vals: torch.Tensor   # (cap,) tombstoned measures; 0 on padding
    del_cf: torch.Tensor     # (cap+1,) exclusive prefix sum of del_vals
    ins_st: Optional[torch.Tensor]   # (L, cap) sparse table (cuda max/min)
    cap: int
    vic_keys: Optional[torch.Tensor] = None   # (vcap,) deleted base keys
    live_st: Optional[torch.Tensor] = None    # (L, n) victim-masked exact ST

    @staticmethod
    def empty(cap: int, dtype: torch.dtype = DTYPE, device=None,
              with_st: bool = False) -> "DeltaBuffer":
        s = torch.full((cap,), big_sentinel(dtype), dtype=dtype,
                       device=device)
        z = torch.zeros((cap,), dtype=dtype, device=device)
        cf = torch.zeros((cap + 1,), dtype=dtype, device=device)
        st = (torch.full((max(1, cap.bit_length()), cap), -torch.inf,
                         dtype=dtype, device=device) if with_st else None)
        return DeltaBuffer(s, z, cf, s, z, cf, st, cap)


def _merge_sorted(cap: int, keys, vals, new_k, new_v):
    """Merge a batch into the sentinel-padded sorted log, keeping shape.

    Valid entries sort before the sentinels, so slicing back to ``cap``
    drops padding only (the caller guarantees fill + batch <= cap).  The
    sort is stable: existing entries stay first on ties, as ``jnp.argsort``
    keeps them in the reference.
    """
    k = torch.cat([keys, new_k])
    v = torch.cat([vals, new_v])
    order = torch.argsort(k, stable=True)
    return k[order][:cap], v[order][:cap]


def _prefix_sum(vals):
    """Exclusive prefix-sum array ((cap+1,)) over the sorted log's values."""
    return torch.cat([vals.new_zeros(1), torch.cumsum(vals, dim=0)])


def _sparse_table(vals, *, cap: int):
    """(L, cap) sparse table over the sorted log (``build_sparse_table``
    semantics: st[j, i] = max(vals[i : i+2^j]), -inf past the end)."""
    rows = [vals]
    for j in range(1, max(1, cap.bit_length())):
        half = 1 << (j - 1)
        prev = rows[-1]
        shifted = torch.cat([prev[half:], prev.new_full((half,), -torch.inf)])
        rows.append(torch.maximum(prev, shifted))
    return torch.stack(rows)


def _append_1d(keys, vals, new_k, new_v, *, cap: int, with_st: bool):
    """Append a batch: the merged sorted log, its exclusive prefix sums and,
    for the 'cuda' MAX/MIN correction (K6), its sparse table.  Returns
    (keys, vals, cf, st-or-None)."""
    k, v = _merge_sorted(cap, keys, vals, new_k, new_v)
    cf = _prefix_sum(v)
    st = _sparse_table(v, cap=cap) if with_st else None
    return k, v, cf, st


@dataclasses.dataclass(frozen=True)
class DeltaBuffer2D:
    """Insert/delete point logs for a 2-key plan, x-sorted.

    Empty slots hold the sentinel in both coordinates and measure 0.  On
    the ``'cuda'`` backend, appends also rebuild each log's merge-sort-tree
    levels ``*_ylv`` (level l = y sorted within blocks of 2^l of the
    x-order), which K9 reads; on the other backends they stay sentinel and
    the whole-log scans K18-K20 (``'cuda_scan'``) or the dense oracles read
    the raw logs.  Measure-carrying plans
    (sum2d/max2d/min2d) log each point's measure (``*_w``, internal space:
    negated for min2d) and, for K10/K11, the per-block inclusive prefix
    sums ``*_wcum`` and the insert log's prefix maxima ``ins_wpmax``.

    Dominance deletes shadow base victims instead (``vic_x``/``vic_y``,
    sentinel-padded, and the victim-masked exact tree ``live_wpmax`` over
    the base points); all three are None until the first such delete.  The
    buffer is immutable: appends build a new one.
    """

    ins_x: torch.Tensor
    ins_y: torch.Tensor
    ins_ylv: torch.Tensor    # (L, cap) per-level block-sorted y
    del_x: torch.Tensor
    del_y: torch.Tensor
    del_ylv: torch.Tensor    # (L, cap)
    cap: int
    # -- measure-carrying plans (sum2d/max2d/min2d) -----------------------
    ins_w: Optional[torch.Tensor] = None      # (cap,) measures; 0 on padding
    del_w: Optional[torch.Tensor] = None
    ins_wcum: Optional[torch.Tensor] = None   # (L, cap) block prefix sums
    del_wcum: Optional[torch.Tensor] = None
    ins_wpmax: Optional[torch.Tensor] = None  # (L, cap) block prefix maxima
    vic_x: Optional[torch.Tensor] = None      # (vcap,) shadowed base points
    vic_y: Optional[torch.Tensor] = None
    live_wpmax: Optional[torch.Tensor] = None  # (L, n) victim-masked tree

    @staticmethod
    def empty(cap: int, dtype: torch.dtype = DTYPE, device=None,
              weighted: bool = False) -> "DeltaBuffer2D":
        levels = max(1, cap.bit_length())
        s = torch.full((cap,), big_sentinel(dtype), dtype=dtype,
                       device=device)
        lv = torch.full((levels, cap), big_sentinel(dtype), dtype=dtype,
                        device=device)
        if not weighted:
            return DeltaBuffer2D(s, s, lv, s, s, lv, cap)
        z = torch.zeros((cap,), dtype=dtype, device=device)
        zlv = torch.zeros((levels, cap), dtype=dtype, device=device)
        return DeltaBuffer2D(s, s, lv, s, s, lv, cap, ins_w=z, del_w=z,
                             ins_wcum=zlv, del_wcum=zlv, ins_wpmax=zlv)


def _mst_levels(ys, *, cap: int):
    """(L, cap) merge-sort-tree levels of the x-sorted log's y values
    (level l = per-block sort with block size 2^l; level 0 = x order)."""
    rows = [ys]
    for l in range(1, max(1, cap.bit_length())):
        b = 1 << l
        rows.append(torch.sort(ys.reshape(cap // b, b), dim=1).values
                    .reshape(-1))
    return torch.stack(rows)


def _mst_levels_w(ys, ws, *, cap: int):
    """Weighted merge-sort-tree levels of the x-sorted log: block-sorted y
    plus the per-block inclusive prefix sums and prefix maxima of the
    weights carried through the same stable sorts.  Returns (ylv, wcum,
    wpmax), each (L, cap)."""
    ylv, wcum, wpmax = [ys], [ws], [ws]
    y, w = ys, ws
    for l in range(1, max(1, cap.bit_length())):
        b = 1 << l
        y2 = y.reshape(cap // b, b)
        perm = torch.argsort(y2, dim=1, stable=True)
        y2 = torch.gather(y2, 1, perm)
        w2 = torch.gather(w.reshape(cap // b, b), 1, perm)
        y, w = y2.reshape(-1), w2.reshape(-1)
        ylv.append(y)
        wcum.append(torch.cumsum(w2, dim=1).reshape(-1))
        wpmax.append(torch.cummax(w2, dim=1).values.reshape(-1))
    return torch.stack(ylv), torch.stack(wcum), torch.stack(wpmax)


def _append_2d(bx, by, bw, nx, ny, nw, *, cap: int, levels: bool,
               weighted: bool):
    """Append a batch of points: the merged x-sorted log and, when the
    'cuda' corrections read them (``levels``), its merge-sort-tree levels
    (weighted logs: with prefix sums and maxima).  Returns (x, y, w, ylv,
    wcum, wpmax), None for what was not built (``bw``/``nw`` are ignored
    unless ``weighted``)."""
    x = torch.cat([bx, nx])
    order = torch.argsort(x, stable=True)[:cap]   # existing first on ties
    x, y = x[order], torch.cat([by, ny])[order]
    w = ylv = wcum = wpmax = None
    if weighted:
        w = torch.cat([bw, nw])[order]
        if levels:
            ylv, wcum, wpmax = _mst_levels_w(y, w, cap=cap)
    elif levels:
        ylv = _mst_levels(y, cap=cap)
    return x, y, w, ylv, wcum, wpmax


# ---------------------------------------------------------------------------
# exact delta corrections (in the query path)
# ---------------------------------------------------------------------------

def _delta_sum(lq, uq, keys, vals, cf, *, backend: str):
    if backend == "cuda":
        # K5: two binary searches into the append-maintained prefix sums
        return delta_sum_gather(lq, uq, keys, cf)
    if backend == "cuda_scan":
        # K16: a membership test against every slot of the log
        return delta_sum(lq, uq, keys, vals)
    if backend == "ref":
        return _ref.delta_sum_ref(lq, uq, keys, vals)
    # torch: the log is sorted and cf precomputed -> two searchsorted lookups
    return (cf[torch.searchsorted(keys, uq, right=True)]
            - cf[torch.searchsorted(keys, lq, right=True)])


def _delta_max(lq, uq, keys, vals, st, *, backend: str):
    if backend == "cuda":
        # K6: locate the covered span of the sorted log, O(1) range max
        return delta_max_gather(lq, uq, keys, st)
    if backend == "cuda_scan":
        # K17: a masked max over every slot of the log
        return delta_max(lq, uq, keys, vals)
    # torch + ref: dense masked max over the (small) buffer
    return _ref.delta_max_ref(lq, uq, keys, vals)


def _delta_count2d(lx, ux, ly, uy, kx, ky, ylv, *, backend: str):
    if backend == "cuda":
        # K9: merge-sort-tree dominance counts, O(log^2 cap) a corner
        return delta_count2d_gather(lx, ux, ly, uy, kx, ylv)
    if backend == "cuda_scan":
        # K18: a membership test against every slot of the log
        return delta_count2d(lx, ux, ly, uy, kx, ky)
    # torch + ref: dense membership over the (small) log
    return _ref.delta_count2d_ref(lx, ux, ly, uy, kx, ky)


def _delta_sum2d(lx, ux, ly, uy, kx, ky, wv, ylv, wcum, *, backend: str):
    if backend == "cuda":
        # K10: the weighted merge-sort-tree prefix sums
        return delta_sum2d_gather(lx, ux, ly, uy, kx, ylv, wcum)
    if backend == "cuda_scan":
        # K19: the members' measures added in slot order
        return delta_sum2d(lx, ux, ly, uy, kx, ky, wv)
    return _ref.delta_sum2d_ref(lx, ux, ly, uy, kx, ky, wv)


def _delta_dommax2d(u, v, kx, ky, wv, ylv, wpmax, *, backend: str):
    if backend == "cuda":
        # K11: the weighted merge-sort-tree prefix maxima
        return delta_dommax2d_gather(u, v, kx, ylv, wpmax)
    if backend == "cuda_scan":
        # K20: a masked max over every slot of the log
        return delta_dommax2d(u, v, kx, ky, wv)
    return _ref.delta_dommax2d_ref(u, v, kx, ky, wv)


# ---------------------------------------------------------------------------
# dynamic executors: static approximation + exact delta correction +
# Q_rel acceptance + refinement
# ---------------------------------------------------------------------------

def _exec_dyn_sum(plan: IndexPlan, buf: DeltaBuffer, lq, uq, *, backend: str,
                  eps_rel: Optional[float]):
    lqc = torch.maximum(lq, plan.domain_lo)
    uqc = torch.maximum(uq, plan.domain_lo)
    static = raw_sum(plan, lqc, uqc, backend=backend)
    # exact correction over (lq, uq] — unclamped: buffered keys may lie
    # outside the static domain
    corr = (_delta_sum(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_cf,
                       backend=backend)
            - _delta_sum(lq, uq, buf.del_keys, buf.del_vals, buf.del_cf,
                         backend=backend))
    approx = static + corr
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    # Lemma 5.2 holds over the updated dataset: |approx - truth| <= 2*delta
    # because the delta contribution is exact
    two_d = 2.0 * plan.delta
    ok = ((approx - two_d > 0) &
          (two_d / torch.clamp(approx - two_d, min=1e-300) <= eps_rel))
    truth = truth_sum(plan, lq, uq, backend=backend) + corr
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_dyn_quantile(plan: IndexPlan, buf: DeltaBuffer, q):
    """Certified quantile over the *updated* CF G = F + (ins - del).

    G is the CF of the live multiset (deletes remove existing rows), hence
    monotone; only F is fitted.  The loop inverts F against the
    delta-corrected rank target and re-certifies with the exact buffer
    correction evaluated at the candidate key: at convergence the
    key-certified facts about F plus the exact B(x) give
    G(x_hi) >= rank + slack and G(x_lo) <= rank - slack.  Plain torch for
    every backend, as the reference runs it as plain XLA for every backend.
    """
    dt = plan.dtype
    qc = torch.clamp(q, 0.0, 1.0)
    err, Bnd, keys, nk = quantile_tables(plan)
    kw = dict(B=Bnd, seg_lo=plan.seg_lo, seg_hi=plan.seg_hi,
              coeffs=plan.coeffs, h=plan.h)
    delta = float(plan.delta)

    # total live mass and rank slack over the updated multiset
    M, slack = quantile_mass(plan, buf.ins_cf[-1] - buf.del_cf[-1])
    r = qc * M
    tiny = 1e-9 * (torch.abs(r) + 1.0)

    def corr(x):
        # exact buffered mass at or below x (exclusive prefix sums; the
        # sentinel-padded tails contribute zero)
        return (buf.ins_cf[bsearch_count(buf.ins_keys, x, side="right")]
                - buf.del_cf[bsearch_count(buf.del_keys, x, side="right")])

    live = buf.ins_keys < big_sentinel(dt) / 2
    dom_hi = plan.seg_hi[plan.h - 1]
    dom_lo = plan.seg_lo[0]
    # unconditional fallbacks: >=/<= every live key of the updated set
    fb_top = torch.maximum(
        dom_hi, torch.where(live, buf.ins_keys, -torch.inf).max())
    fb_lo = torch.minimum(
        dom_lo, torch.where(live, buf.ins_keys, torch.inf).min())

    # raw fitted estimate: fixed-point on the delta-corrected rank
    zeros = torch.zeros_like(err)
    xm, okm = invert_cf(r, "hi", seg_err=zeros, delta=0.0, slack=0.0,
                        raw=True, **kw)
    xm = torch.where(okm, xm, dom_hi)
    for _ in range(2):
        xm2, okm = invert_cf(r - corr(xm), "hi", seg_err=zeros, delta=0.0,
                             slack=0.0, raw=True, **kw)
        xm = torch.where(okm, xm2, dom_hi)

    # upper: find x_hi with F(x_hi) >= tF and tF + B(x_hi) >= r + slack
    r_hi = r + slack
    tF = r_hi - corr(xm)
    x_hi, ok_hi = xm, torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    for _ in range(4):
        x_hi, ok_v = invert_cf(tF, "hi", seg_err=err, delta=delta, slack=0.0,
                               ref_keys=keys, n=nk, **kw)
        need = r_hi - corr(x_hi)
        ok_hi = (need <= tF + tiny) & ok_v
        tF = torch.maximum(tF, need)
    x_hi = torch.where(ok_hi, x_hi, fb_top)

    # lower: every base key <= x_lo has F <= tL (the invert_cf 'lo'
    # contract, flagged by ok_v), so G(x_lo) <= max(tL, 0) + B(x_lo) <=
    # r - slack at convergence; G monotone => x_lo precedes every rank-r
    # crossing
    r_lo = r - slack
    tL = r_lo - corr(xm)
    x_lo, ok_lo = xm, torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    for _ in range(4):
        x_lo, ok_v = invert_cf(tL, "lo", seg_err=err, delta=delta, slack=0.0,
                               **kw)
        need = r_lo - corr(x_lo)
        ok_lo = (need >= torch.clamp(tL, min=0.0) - tiny) & ok_v
        tL = torch.minimum(tL, need)
    x_lo = torch.where(ok_lo, x_lo, fb_lo)

    return torch.clamp(xm, x_lo, x_hi), x_lo, x_hi


def _exec_dyn_extremum(plan: IndexPlan, buf: DeltaBuffer, lq, uq, *,
                       backend: str, eps_rel: Optional[float]):
    """MAX space throughout; the delete log is never read (extremal deletes
    shadow a victim — ``buf.vic_keys``/``buf.live_st`` — see DeltaBuffer)."""
    lqc = torch.maximum(lq, plan.domain_lo)
    uqc = torch.maximum(uq, plan.domain_lo)
    static = raw_extremum(plan, lqc, uqc, backend=backend)
    ins = _delta_max(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_st,
                     backend=backend)
    approx = torch.maximum(static, ins)
    neg = plan.agg == "min"
    if buf.vic_keys is not None:
        # victim-shadowed path: a range covering a deleted base row cannot
        # trust the fitted approximation (the victim may be the maximum) —
        # refine against the victim-masked exact sparse table instead
        base_exact = sparse_table_range_max(
            buf.live_st, *key_span(plan.ref_keys, lq, uq, backend,
                                   plan.ref_tree))
        exact = torch.maximum(base_exact, ins)
        vk = buf.vic_keys
        threat = ((lq[:, None] <= vk[None, :]) &
                  (vk[None, :] <= uq[:, None])).any(dim=1)
        if eps_rel is None:
            ans = torch.where(threat, exact, approx)
            if neg:
                ans = -ans
            return ans, ans, threat
        ok = (~threat) & (approx >= plan.delta * (1.0 + 1.0 / eps_rel))
        ans = torch.where(ok, approx, exact)
        if neg:
            ans, approx = -ans, -approx
        return ans, approx, ~ok
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    # Lemma 5.4: max(static +- delta, exact) stays within delta of the truth
    ok = approx >= plan.delta * (1.0 + 1.0 / eps_rel)
    truth = torch.maximum(truth_extremum(plan, lq, uq, backend=backend), ins)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def _exec_dyn_rect2d(plan: IndexPlan2D, buf: DeltaBuffer2D, lx, ux, ly, uy,
                     *, backend: str, eps_rel: Optional[float]):
    """2-key COUNT or SUM over (lx, ux] x (ly, uy]: the twin of the
    reference's ``_exec_dyn_count2d`` and ``_exec_dyn_sum2d``, which differ
    only in the correction and the truth they read.  The raw path runs on
    corners clamped to the root, the exact correction and the Q_rel truth
    on the raw ones (buffered points may lie outside the root)."""
    x0, x1, y0, y1 = plan.root
    lxc, uxc = (torch.clamp(q, x0, x1) for q in (lx, ux))
    lyc, uyc = (torch.clamp(q, y0, y1) for q in (ly, uy))
    static = raw_count2d(plan, lxc, uxc, lyc, uyc, backend=backend)
    if plan.agg == "sum2d":
        corr = (_delta_sum2d(lx, ux, ly, uy, buf.ins_x, buf.ins_y, buf.ins_w,
                             buf.ins_ylv, buf.ins_wcum, backend=backend)
                - _delta_sum2d(lx, ux, ly, uy, buf.del_x, buf.del_y,
                               buf.del_w, buf.del_ylv, buf.del_wcum,
                               backend=backend))
    else:
        corr = (_delta_count2d(lx, ux, ly, uy, buf.ins_x, buf.ins_y,
                               buf.ins_ylv, backend=backend)
                - _delta_count2d(lx, ux, ly, uy, buf.del_x, buf.del_y,
                                 buf.del_ylv, backend=backend))
    approx = static + corr
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    ok = approx >= 4.0 * plan.delta * (1.0 + 1.0 / eps_rel)   # Lemma 6.4
    truth = (truth_sum2d if plan.agg == "sum2d" else truth_count2d)(
        plan, lx, ux, ly, uy, backend=backend) + corr
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_dyn_dommax2d(plan: IndexPlan2D, buf: DeltaBuffer2D, u, v, *,
                       backend: str, eps_rel: Optional[float]):
    """Dominance MAX/MIN, in MAX space throughout; the delete log is never
    read (dominance deletes shadow a victim: ``buf.vic_x``/``vic_y``/
    ``live_wpmax``)."""
    x0, x1, y0, y1 = plan.root
    static = raw_eval2d(plan, torch.clamp(u, x0, x1), torch.clamp(v, y0, y1),
                        backend=backend)
    ins = _delta_dommax2d(u, v, buf.ins_x, buf.ins_y, buf.ins_w, buf.ins_ylv,
                          buf.ins_wpmax, backend=backend)
    approx = torch.maximum(static, ins)
    neg = plan.agg == "min2d"
    if buf.vic_x is not None:
        # victim-shadowed path: a corner dominating a deleted base point
        # cannot trust the fit (the victim may be the maximum) — refine it
        # against the victim-masked merge-sort tree
        (i,) = _x_ranks(plan, backend, u)
        base_exact = mst_weighted_prefix(plan.ref_xs, plan.ref_ys_levels,
                                         buf.live_wpmax, i, v, mode="max")
        exact = torch.maximum(base_exact, ins)
        threat = ((buf.vic_x[None, :] <= u[:, None]) &
                  (buf.vic_y[None, :] <= v[:, None])).any(dim=1)
        if eps_rel is None:
            ans = torch.where(threat, exact, approx)
            if neg:
                ans = -ans
            return ans, ans, threat
        ok = (~threat) & (approx >= plan.delta * (1.0 + 1.0 / eps_rel))
        ans = torch.where(ok, approx, exact)
        if neg:
            ans, approx = -ans, -approx
        return ans, approx, ~ok
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    ok = approx >= plan.delta * (1.0 + 1.0 / eps_rel)
    truth = torch.maximum(truth_dommax2d(plan, u, v, backend=backend), ins)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


# ---------------------------------------------------------------------------
# serving-executor factories: the unit behind serve/engine.py's cache
# ---------------------------------------------------------------------------

def fused_executor(agg: str, dynamic: bool, *, backend: str,
                   eps_rel: Optional[float], deg: int):
    """A plain callable ``fn(plan, buf, *padded_ranges)`` with every static
    argument closed over — the unit the serving engine caches per (table,
    guarantee, bucket), captured as one CUDA graph on the card.

    ``buf`` is the table's ``DeltaBuffer``/``DeltaBuffer2D`` for dynamic
    tables and an empty tuple for static ones (the argument slot is kept so
    one cache shape serves both).  The function returns the raw executor
    triple ``(ans, approx, refined)`` over the padded bucket; the caller
    slices real rows back out.  Dispatch mirrors ``execute_*`` and the
    dynamic engines' queries exactly — including the deg > 3 extremum
    downgrade to ``'torch'`` — so answers are bit-identical to the session
    path.
    """
    from .engine import (_exec_extremum, _exec_extremum2d, _exec_rect2d,
                         _exec_sum)
    if agg in ("max", "min") and deg > 3 and backend in (
            "cuda", "cuda_scan", "ref"):
        backend = "torch"   # no in-kernel closed form past deg 3
    statics = dict(backend=backend, eps_rel=eps_rel)
    if dynamic:
        ex = {"sum": _exec_dyn_sum, "count": _exec_dyn_sum,
              "max": _exec_dyn_extremum, "min": _exec_dyn_extremum,
              "count2d": _exec_dyn_rect2d, "sum2d": _exec_dyn_rect2d,
              "max2d": _exec_dyn_dommax2d,
              "min2d": _exec_dyn_dommax2d}[agg]

        def fn(plan, buf, *qs):
            return ex(plan, buf, *qs, **statics)
    else:
        ex = {"sum": _exec_sum, "count": _exec_sum,
              "max": _exec_extremum, "min": _exec_extremum,
              "count2d": _exec_rect2d, "sum2d": _exec_rect2d,
              "max2d": _exec_extremum2d, "min2d": _exec_extremum2d}[agg]

        def fn(plan, buf, *qs):
            del buf
            return ex(plan, *qs, **statics)
    return fn


def fused_quantile_executor(dynamic: bool, *, backend: str, deg: int):
    """The QUANTILE counterpart of ``fused_executor``: a plain callable
    ``fn(plan, buf, q)`` returning the certified (answer, lo, hi) triple
    over the padded fraction bucket.  Q_abs-only — there is no Q_rel
    refinement path (the certificate *is* the guarantee).  A dynamic table
    inverts through ``_exec_dyn_quantile`` (plain torch on every backend,
    as ``DynamicEngine.quantile`` does); a static plan without exact arrays
    takes the ``'torch'`` path, as ``execute_quantile`` routes it."""
    del deg   # quantile inversion has no degree-gated backend downgrade
    from .engine import CARD_BACKENDS, _exec_quantile
    if dynamic:
        def fn(plan, buf, q):
            return _exec_dyn_quantile(plan, buf, q)
    else:
        def fn(plan, buf, q):
            del buf
            b = ("torch" if backend in CARD_BACKENDS and plan.ref_keys is None
                 else backend)
            return _exec_quantile(plan, q, backend=b)
    return fn


# ---------------------------------------------------------------------------
# merge pass: apply the buffered ops, refit only the dirty segments (host)
# ---------------------------------------------------------------------------

def _merge_1d(index: PolyFitIndex1D, keys: np.ndarray, meas: np.ndarray,
              ins_k: np.ndarray, ins_v: np.ndarray,
              del_k: np.ndarray, del_v: np.ndarray, *, device
              ) -> Tuple[PolyFitIndex1D, np.ndarray, np.ndarray]:
    """Merge buffered ops into (keys, meas) and selectively refit.

    Returns (new_index on ``device``, new_keys, new_meas) with measures in
    internal space.  Only segments whose ``locate`` span contains a changed
    key are re-segmented (greedy GS on the affected windows); clean
    SUM/COUNT segments get their constant coefficient shifted by the exact
    upstream CF delta, which preserves their certified E(I).
    """
    agg, deg, delta = index.agg, index.deg, index.delta
    extremal = agg in ("max", "min")
    n_old = len(keys)

    # -- resolve tombstones against pending inserts, then the base data ----
    removed = np.zeros(n_old, bool)
    ins_removed = np.zeros(len(ins_k), bool)
    for key, val in zip(del_k, del_v):
        cand = np.where(~ins_removed & (ins_k == key) & (ins_v == val))[0]
        if len(cand):
            ins_removed[cand[0]] = True
            continue
        i0 = np.searchsorted(keys, key, side="left")
        i1 = np.searchsorted(keys, key, side="right")
        live = np.where(~removed[i0:i1] & (meas[i0:i1] == val))[0]
        if not len(live):
            live = np.where(~removed[i0:i1])[0]
        if not len(live):
            raise KeyError(f"delete of key {key!r}: no live occurrence")
        removed[i0 + live[0]] = True

    keep = ~removed
    kept_old = np.where(keep)[0]
    ik = ins_k[~ins_removed]
    iv = ins_v[~ins_removed]
    all_k = np.concatenate([keys[keep], ik])
    all_v = np.concatenate([meas[keep], iv])
    order = np.argsort(all_k, kind="stable")   # base entries first on ties
    new_k, new_m = all_k[order], all_v[order]
    if len(new_k) == 0:
        raise ValueError("merge would empty the dataset")

    # old position -> new position, for the CF shift of clean segments
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    old_to_new = np.full(n_old, -1, np.int64)
    old_to_new[kept_old] = inv[: len(kept_old)]

    # -- mark dirty segments (locate() rule: searchsorted right - 1) -------
    seg_lo = _host(index.seg_lo)
    seg_hi = _host(index.seg_hi)
    coeffs = _host(index.coeffs)
    seg_start = _host(index.seg_start)
    seg_err = (np.asarray(index.seg_err) if index.seg_err is not None
               else np.full(len(seg_lo), delta))
    h = len(seg_lo)
    changed = np.concatenate([ins_k, del_k])
    dirty = np.zeros(h, bool)
    dirty[np.clip(np.searchsorted(seg_lo, changed, side="right") - 1,
                  0, h - 1)] = True
    # duplicate keys straddling a boundary can leave a "clean" segment whose
    # anchor position was removed — refit it rather than shift blindly
    for s in range(h):
        if not dirty[s] and old_to_new[seg_start[s]] < 0:
            dirty[s] = True

    old_F = np.cumsum(meas) if not extremal else meas
    new_F = np.cumsum(new_m) if not extremal else new_m
    ins_sorted = np.sort(ik)
    keep_cum = np.concatenate([[0], np.cumsum(keep)])

    def new_boundary(p: int) -> int:
        """New-array position of old boundary position p (start of seg)."""
        if p >= n_old:
            return len(new_k)
        # kept base keys before p + inserted keys sorting strictly before
        # keys[p] (stable merge puts equal inserted keys after the base run)
        return int(keep_cum[p]) + int(np.searchsorted(ins_sorted, keys[p],
                                                      side="left"))

    fitter = FastAcceptFitter(exact=fit_minimax_lp, delta=delta,
                              post=_continuum_post if extremal else None)
    segs: List[PolyModel] = []
    i = 0
    while i < h:
        if not dirty[i]:
            c = coeffs[i].copy()
            if not extremal:
                np_pos = old_to_new[seg_start[i]]
                c[0] += new_F[np_pos] - old_F[seg_start[i]]
            segs.append(PolyModel(float(seg_lo[i]), float(seg_hi[i]), c,
                                  float(seg_err[i])))
            i += 1
            continue
        j = i
        while j < h and dirty[j]:
            j += 1
        start = 0 if i == 0 else new_boundary(int(seg_start[i]))
        end = len(new_k) if j >= h else new_boundary(int(seg_start[j]))
        if end > start:
            segs.extend(greedy_segmentation(new_k[start:end],
                                            new_F[start:end], deg, delta,
                                            fitter=fitter))
        i = j

    new_index = assemble_index_1d(segs, new_k, new_m, agg, deg, delta,
                                  keep_exact=True, device=device)
    return new_index, new_k, new_m


# ---------------------------------------------------------------------------
# the dynamic engine
# ---------------------------------------------------------------------------

class _DeltaBufferedEngine:
    """Shared delta-buffer bookkeeping + (background) refit machinery.

    Subclasses implement ``_snapshot()`` (immutable view of the data + op
    logs for the merge thread) and ``_merge(snap, mark)`` (the merge pass,
    ending in a locked ``_install``); thread lifecycle, drain-until-empty
    waiting, residual-op marks and error surfacing live here once.
    """

    _refit_error: Optional[BaseException] = None

    def _init_dynamic(self, *, backend: str, capacity: int, min_bucket: int,
                      auto_refit: bool, background: bool) -> None:
        check_pow2("capacity", capacity)
        check_pow2("min_bucket", min_bucket)
        self.backend = backend
        self.capacity = capacity
        self.min_bucket = min_bucket
        self.auto_refit = auto_refit
        self.background = background
        self.refit_count = 0
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._install_listeners: List = []
        # (ins, del) log lengths captured by the in-flight merge snapshot;
        # None when no merge is running.  Extremal deletes that NaN-cancel
        # a pending insert the snapshot already copied must be replayed at
        # install (the merge bakes the un-cancelled copy into the new base).
        self._merge_mark: Optional[Tuple[int, int]] = None

    def add_install_listener(self, fn) -> None:
        """Register ``fn(preview)`` to run on the merge thread with the
        about-to-be-installed plan *before* the atomic install; listener
        errors propagate as refit errors (the install does not happen)."""
        self._install_listeners.append(fn)

    def _notify_install_listeners(self, preview) -> None:
        for fn in list(self._install_listeners):
            fn(preview)

    @property
    def n_pending(self) -> int:
        return self._n_pending

    def snapshot(self):
        """The current immutable (plan, delta-buffer) pair, as one atomic
        read — the state queries execute against."""
        return self._state

    def _ensure_room(self, m: int) -> None:
        if m > self.capacity:
            raise ValueError(f"batch of {m} exceeds buffer capacity "
                             f"{self.capacity}; split the batch")
        if self._n_pending + m > self.capacity:
            self.refit(wait=True)   # drains every pending op (see refit)

    def flush(self) -> None:
        """Synchronously merge all buffered ops into a fresh plan."""
        self.refit(wait=True)

    def refit(self, wait: Optional[bool] = None) -> None:
        """Run (or join) a merge pass.  ``wait=False`` returns immediately
        with the merge running on a daemon thread; queries keep executing
        against the old (plan, buffer) snapshot until the atomic install.

        ``wait=True`` drains *every* pending op before returning: a joined
        thread may be a stale background merge whose snapshot predates ops
        logged since (they are replayed into the fresh buffer as
        residuals), so keep merging until nothing is pending.  MAX/MIN
        delete correctness relies on this — a residual tombstone would sit
        in a buffer the extremum executor never reads."""
        wait = (not self.background) if wait is None else wait
        t = self._start_refit()
        if wait:
            while t is not None:
                t.join()
                self._raise_refit_error()
                t = self._start_refit()
        self._raise_refit_error()

    def _raise_refit_error(self) -> None:
        if self._refit_error is not None:
            err, self._refit_error = self._refit_error, None
            raise err

    def _has_forced_work(self) -> bool:
        """Subclass hook: True when a merge must run even with zero pending
        buffered ops (the LSM shadow-fraction fold, which compacts
        tombstone-heavy levels that carry no new inserts)."""
        return False

    def _start_refit(self) -> Optional[threading.Thread]:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self._thread
            if self._n_pending == 0 and not self._has_forced_work():
                return None
            snap = self._snapshot()
            mark = (len(self._ins_log), len(self._del_log))
            t = threading.Thread(target=self._merge_and_install,
                                 args=(snap, mark), daemon=True)
            self._thread = t
        t.start()
        return t

    def _merge_and_install(self, snap, mark) -> None:
        try:
            self._merge(snap, mark)
        except BaseException as e:   # surface on the caller's next refit()
            self._refit_error = e
        finally:
            self._thread = None

    def _require_agg(self, *aggs) -> None:
        if self._agg not in aggs:
            raise ValueError(f"a {self._agg} table does not answer "
                             f"{'/'.join(aggs)} queries")

    @staticmethod
    def _flatten(log: List[Tuple[np.ndarray, ...]], width: int = 2):
        """The host log's ``width`` columns, each concatenated over its
        batches."""
        if not log:
            return tuple(np.zeros((0,)) for _ in range(width))
        return tuple(np.concatenate([e[i] for e in log])
                     for i in range(width))


class DynamicEngine(_DeltaBufferedEngine):
    """Updatable 1-D plan: buffered inserts/deletes, exact correction in
    the query path, selective (optionally background) refit.

    Single-writer: ``insert``/``delete``/``refit`` are serialized by an
    internal lock; queries are lock-free against an immutable
    (plan, buffer) snapshot, so a refit never blocks them.  The plan, the
    buffer and every merged plan live on the index's device; ``backend``
    defaults to ``'cuda'`` there when it is a CUDA device and ``'torch'``
    on the CPU, and the card backends (``'cuda'``, ``'cuda_scan'``) raise
    on a CPU index.
    """

    def __init__(self, index: PolyFitIndex1D, *, backend: Optional[str] = None,
                 capacity: int = 1024, min_bucket: int = 64,
                 auto_refit: bool = True, background: bool = False,
                 drift_floor: float = 0.05):
        if index.exact_sum is None and index.exact_max is None:
            raise ValueError("DynamicEngine requires an index built with "
                             "keep_exact=True (merge needs the raw data)")
        self.device = index.seg_lo.device
        self._init_dynamic(backend=resolve_backend(backend, self.device),
                           capacity=capacity, min_bucket=min_bucket,
                           auto_refit=auto_refit, background=background)
        self.drift_floor = drift_floor
        self._agg = index.agg
        if index.exact_sum is not None:
            keys = _host(index.exact_sum.keys)
            cf = _host(index.exact_sum.cf)
            meas = np.diff(np.concatenate([[0.0], cf]))
        else:
            keys = _host(index.exact_max.keys)
            meas = _host(index.exact_max.measures)   # internal space
        self._install(index, keys, meas)

    # -- state ----------------------------------------------------------

    def _install(self, index: PolyFitIndex1D, keys: np.ndarray,
                 meas: np.ndarray, residual_ins: Optional[list] = None,
                 residual_del: Optional[list] = None,
                 residual_vic: Optional[list] = None,
                 plan: Optional[IndexPlan] = None) -> None:
        """Swap in a fresh (index, plan, empty-or-replayed buffer).

        ``plan`` lets the merge thread pass the plan it already built and
        uploaded, so the installed object is the one the install listeners
        saw."""
        with self._lock:
            self._index = index
            self._keys = keys
            self._meas = meas
            self._seg_lo_host = _host(index.seg_lo)
            err = (np.asarray(index.seg_err) if index.seg_err is not None
                   else np.zeros(index.h))
            self._budget = np.maximum(index.delta - err,
                                      self.drift_floor * index.delta)
            self._drift = np.zeros(index.h)
            self._ins_log: List[Tuple[np.ndarray, np.ndarray]] = []
            self._del_log: List[Tuple[np.ndarray, np.ndarray]] = []
            self._n_pending = 0
            self._vic: List[int] = []
            self._residual_vic: List[Tuple[float, float]] = []
            self._merge_mark = None
            if plan is None:
                plan = build_plan(index)
            # the insert-log sparse table is only read by K6, so only the
            # 'cuda' backend pays its upkeep ('cuda_scan' reads the log)
            buf = DeltaBuffer.empty(
                self.capacity, plan.dtype, plan.device,
                with_st=(self._agg in ("max", "min")
                         and self.backend == "cuda"))
            self._state = (plan, buf)
            for k, v in (residual_ins or []):
                if len(k):
                    self._log_ops(k, v, delete=False)
            if self._agg in ("max", "min"):
                # extremal residuals re-resolve through the victim path so
                # the fresh buffer's shadow mask covers them immediately
                nan_dirty = False
                for karr, varr in (residual_del or []):
                    for k, v in zip(karr, varr):
                        nan_dirty |= self._delete_extremal_resolved(
                            float(k), float(v))
                for k, v in (residual_vic or []):
                    nan_dirty |= self._delete_extremal_resolved(k, v)
                if nan_dirty:
                    self._rebuild_ins_buf()
                if self._vic:
                    self._refresh_vic_buf()
            else:
                for k, v in (residual_del or []):
                    if len(k):
                        self._log_ops(k, v, delete=True)

    @property
    def plan(self) -> IndexPlan:
        return self._state[0]

    @property
    def index(self) -> PolyFitIndex1D:
        return self._index

    @property
    def agg(self) -> str:
        return self._agg

    # -- updates --------------------------------------------------------

    def _log_ops(self, keys: np.ndarray, vals: np.ndarray,
                 delete: bool) -> None:
        """Append a batch to the device buffer + host log + drift (locked)."""
        if self._n_pending + len(keys) > self.capacity:
            # the merge would silently drop the largest keys past cap;
            # overflowing here means the single-writer contract was broken
            raise RuntimeError("delta buffer overflow: concurrent writers "
                               "bypassed _ensure_room")
        plan, buf = self._state
        dt, dev = plan.dtype, plan.device
        pk = torch.as_tensor(keys, dtype=dt, device=dev)
        pv = torch.as_tensor(vals, dtype=dt, device=dev)
        if delete:
            dk, dv, dcf, _ = _append_1d(buf.del_keys, buf.del_vals, pk, pv,
                                        cap=buf.cap, with_st=False)
            buf = dataclasses.replace(buf, del_keys=dk, del_vals=dv,
                                      del_cf=dcf)
            self._del_log.append((keys, vals))
        else:
            ik, iv, icf, st = _append_1d(buf.ins_keys, buf.ins_vals, pk, pv,
                                         cap=buf.cap,
                                         with_st=buf.ins_st is not None)
            buf = dataclasses.replace(buf, ins_keys=ik, ins_vals=iv,
                                      ins_cf=icf, ins_st=st)
            self._ins_log.append((keys, vals))
        self._state = (plan, buf)
        self._n_pending += len(keys)
        if delete and self._agg in ("max", "min"):
            # extremal tombstones leave the fitted function and its
            # certificate untouched (the victim shadow answers exactly),
            # so they ride the capacity trigger only, never drift
            return
        seg = np.clip(np.searchsorted(self._seg_lo_host, keys, side="right")
                      - 1, 0, len(self._seg_lo_host) - 1)
        np.add.at(self._drift, seg, np.abs(vals))

    def insert(self, keys, measures=None) -> None:
        """Buffer a batch of new (key, measure) records."""
        # always copy: the host log owns these arrays (extremal deletes
        # NaN-cancel pending inserts in place)
        keys = np.atleast_1d(np.array(keys, np.float64))
        if measures is None:
            if self._agg != "count":
                raise ValueError("measures required unless agg='count'")
            measures = np.ones_like(keys)
        measures = np.broadcast_to(
            np.asarray(measures, np.float64), keys.shape).copy()
        if self._agg == "count":
            measures = np.ones_like(keys)
        if self._agg == "min":
            measures = -measures
        self._ensure_room(len(keys))
        with self._lock:
            self._log_ops(keys, measures, delete=False)
            trigger = self._should_refit()
        if trigger:
            self.refit(wait=not self.background)

    def delete(self, keys) -> None:
        """Buffer delete tombstones for existing records (KeyError if a key
        has no live occurrence).  MAX/MIN deletes shadow their victim (the
        buffer's ``vic_keys``/``live_st`` mask) instead of merging eagerly:
        queries covering the victim refine against the victim-masked exact
        sparse table, and the removal rides the next ordinary merge."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        self._ensure_room(len(keys))
        if self._agg in ("max", "min"):
            with self._lock:
                nan_dirty = False
                for k in keys:
                    nan_dirty |= self._delete_extremal_one(float(k))
                if nan_dirty:
                    self._rebuild_ins_buf()
                self._refresh_vic_buf()
                trigger = self._should_refit()
            if trigger:
                self.refit(wait=not self.background)
            return
        with self._lock:
            vals = []
            batch_tomb: dict = {}   # duplicates within this batch advance
            for k in keys:          # the victim cursor too
                off = batch_tomb.get(float(k), 0)
                vals.append(self._find_victim(float(k), extra_tomb=off))
                batch_tomb[float(k)] = off + 1
            self._log_ops(keys, np.array(vals), delete=True)
            trigger = self._should_refit()
        if trigger:
            self.refit(wait=not self.background)

    def _delete_extremal_one(self, key: float) -> bool:
        """Resolve one extremal delete: shadow the leftmost unshadowed base
        occurrence (victim mask + ordinary tombstone for the next merge),
        else NaN-cancel a pending insert.  Returns True when a pending
        insert was cancelled (the device insert log needs a rebuild)."""
        i0 = np.searchsorted(self._keys, key, side="left")
        i1 = np.searchsorted(self._keys, key, side="right")
        vic_set = set(self._vic)
        for pos in range(i0, i1):
            if pos not in vic_set:
                self._vic.append(pos)
                self._log_ops(np.array([key]),
                              np.array([float(self._meas[pos])]),
                              delete=True)
                return False
        for e, (karr, varr) in enumerate(self._ins_log):
            hit = np.where((karr == key) & ~np.isnan(karr))[0]
            if len(hit):
                j = int(hit[0])
                val = float(varr[j])
                karr[j] = varr[j] = np.nan
                self._n_pending -= 1
                if (self._merge_mark is not None
                        and e < self._merge_mark[0]):
                    # the in-flight merge copied this entry before the mark
                    # and will bake it into the new base — replay there
                    self._residual_vic.append((key, val))
                return True
        raise KeyError(f"delete of key {key!r}: no live occurrence")

    def _delete_extremal_resolved(self, key: float, val: float) -> bool:
        """Replay a residual extremal delete against the freshly installed
        base (value-matched victim preferred, then a pending insert, then
        any live occurrence).  Locked; returns True on a NaN-cancel."""
        i0 = np.searchsorted(self._keys, key, side="left")
        i1 = np.searchsorted(self._keys, key, side="right")
        vic_set = set(self._vic)
        cand = [p for p in range(i0, i1) if p not in vic_set]
        pos = next((p for p in cand if self._meas[p] == val),
                   cand[0] if cand else None)
        if pos is not None:
            self._vic.append(pos)
            self._log_ops(np.array([key]),
                          np.array([float(self._meas[pos])]), delete=True)
            return False
        for karr, varr in self._ins_log:
            hit = np.where((karr == key) & (varr == val)
                           & ~np.isnan(karr))[0]
            if len(hit):
                j = int(hit[0])
                karr[j] = varr[j] = np.nan
                self._n_pending -= 1
                return True
        raise KeyError(f"delete of key {key!r}: no live occurrence")

    def _refresh_vic_buf(self) -> None:
        """Rebuild the buffer's victim mask (sorted shadow keys + the
        victim-masked exact sparse table) and swap it in atomically."""
        plan, buf = self._state
        if not self._vic:
            if buf.vic_keys is not None:
                buf = dataclasses.replace(buf, vic_keys=None, live_st=None)
                self._state = (plan, buf)
            return
        nv = len(self._vic)
        vcap = self.capacity
        while vcap < nv:
            vcap *= 2
        vk = np.full((vcap,), big_sentinel(torch.float64))
        vk[:nv] = np.sort(self._keys[np.asarray(self._vic)])
        m = np.array(self._meas, np.float64, copy=True)
        m[np.asarray(self._vic)] = -np.inf
        to = lambda a: torch.as_tensor(a, dtype=plan.dtype, device=plan.device)
        buf = dataclasses.replace(buf, vic_keys=to(vk),
                                  live_st=to(build_sparse_table(m)))
        self._state = (plan, buf)

    def _rebuild_ins_buf(self) -> None:
        """Rebuild the device insert log from the non-NaN host entries
        (one append), after a pending insert was cancelled."""
        plan, buf = self._state
        dt, dev = plan.dtype, plan.device
        with_st = buf.ins_st is not None
        fresh = DeltaBuffer.empty(self.capacity, dt, dev, with_st=with_st)
        ik, iv = self._flatten(self._ins_log)
        if len(ik):
            alive = ~np.isnan(ik)
            ik, iv = ik[alive], iv[alive]
        if len(ik):
            nk, nv_, ncf, nst = _append_1d(
                fresh.ins_keys, fresh.ins_vals,
                torch.as_tensor(ik, dtype=dt, device=dev),
                torch.as_tensor(iv, dtype=dt, device=dev), cap=self.capacity,
                with_st=with_st)
        else:
            nk, nv_, ncf, nst = (fresh.ins_keys, fresh.ins_vals,
                                 fresh.ins_cf, fresh.ins_st)
        buf = dataclasses.replace(buf, ins_keys=nk, ins_vals=nv_,
                                  ins_cf=ncf, ins_st=nst)
        self._state = (plan, buf)

    def _find_victim(self, key: float, extra_tomb: int = 0) -> float:
        """Measure (internal space) of the occurrence a tombstone removes:
        base occurrences first (left to right), then pending inserts."""
        tomb = extra_tomb + sum(int(np.sum(k == key))
                                for k, _ in self._del_log)
        i0 = np.searchsorted(self._keys, key, side="left")
        i1 = np.searchsorted(self._keys, key, side="right")
        pool = list(self._meas[i0:i1])
        for k, v in self._ins_log:
            pool.extend(v[k == key])
        if tomb >= len(pool):
            raise KeyError(f"delete of key {key!r}: no live occurrence")
        return float(pool[tomb])

    def _should_refit(self) -> bool:
        if not self.auto_refit:
            return False
        return (self._n_pending >= self.capacity
                or bool((self._drift > self._budget).any()))

    # -- merge / refit (lifecycle in _DeltaBufferedEngine) ----------------

    def _snapshot(self):
        # deep-copy the log arrays: extremal deletes NaN-cancel pending
        # inserts *in place* on the host log, which must not race the merge
        # thread's reads of this snapshot
        self._merge_mark = (len(self._ins_log), len(self._del_log))
        self._residual_vic = []
        return (self._index, self._keys, self._meas,
                [(k.copy(), v.copy()) for k, v in self._ins_log],
                [(k.copy(), v.copy()) for k, v in self._del_log])

    def _merge(self, snap, mark) -> None:
        index, keys, meas, ins_log, del_log = snap
        ik, iv = self._flatten(ins_log)
        if len(ik):
            alive = ~np.isnan(ik)   # NaN-cancelled pending inserts
            ik, iv = ik[alive], iv[alive]
        dk, dv = self._flatten(del_log)
        new_index, new_k, new_m = _merge_1d(index, keys, meas, ik, iv, dk, dv,
                                            device=self.device)
        # build and upload the plan OFF the lock, and let the upload finish
        # before the swap: a query must never read a plan mid-copy
        new_plan = build_plan(new_index)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._notify_install_listeners(new_plan)
        with self._lock:
            residual_ins = [(k[~np.isnan(k)], v[~np.isnan(k)])
                            for k, v in self._ins_log[mark[0]:]]
            residual_del = self._del_log[mark[1]:]
            residual_vic = list(self._residual_vic)
            self._install(new_index, new_k, new_m, residual_ins,
                          residual_del, residual_vic, plan=new_plan)
            self.refit_count += 1

    # -- queries ---------------------------------------------------------

    def sum(self, lq, uq, eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("sum", "count")
        plan, buf = self._state
        if eps_rel is not None and plan.ref_cf is None:
            raise ValueError("Q_rel refinement requires exact arrays")
        (lq, uq), n = _prepare(lq, uq, min_bucket=self.min_bucket, plan=plan)
        ans, approx, refined = _exec_dyn_sum(plan, buf, lq, uq,
                                             backend=self.backend,
                                             eps_rel=eps_rel)
        return QueryResult(ans[:n], approx[:n], refined[:n])

    count = sum

    def quantile(self, q) -> QuantileResult:
        """Certified quantile fractions against the live plan-plus-buffer
        state: the delta buffer enters through its exact prefix-sum
        correction, so no flush is needed."""
        self._require_agg("sum", "count")
        plan, buf = self._state
        if plan.deg < 1:
            raise ValueError("quantile inversion needs a plan with deg >= 1")
        q, n = prepare_fractions(q, plan, self.min_bucket)
        ans, lo, hi = _exec_dyn_quantile(plan, buf, q)
        return QuantileResult(ans[:n], lo[:n], hi[:n])

    def extremum(self, lq, uq, eps_rel: Optional[float] = None) -> QueryResult:
        """MAX/MIN over [lq, uq].  Plans of degree > 3 take the ``'torch'``
        path whatever the backend, counted in
        ``execute_extremum.torch_routes`` as the static path counts them."""
        self._require_agg("max", "min")
        plan, buf = self._state
        if eps_rel is not None and plan.ref_st is None:
            raise ValueError("Q_rel refinement requires exact arrays")
        backend = self.backend
        if backend in ("cuda", "cuda_scan", "ref") and plan.deg > 3:
            backend = "torch"   # no in-kernel closed form past deg 3
            execute_extremum.torch_routes += 1
        (lq, uq), n = _prepare(lq, uq, min_bucket=self.min_bucket, plan=plan)
        ans, approx, refined = _exec_dyn_extremum(plan, buf, lq, uq,
                                                  backend=backend,
                                                  eps_rel=eps_rel)
        return QueryResult(ans[:n], approx[:n], refined[:n])

    def query(self, lq, uq, eps_rel: Optional[float] = None) -> QueryResult:
        if self._agg in ("sum", "count"):
            return self.sum(lq, uq, eps_rel=eps_rel)
        return self.extremum(lq, uq, eps_rel=eps_rel)


class DynamicEngine2D(_DeltaBufferedEngine):
    """Updatable 2-key plan (COUNT/SUM rectangles, dominance MAX/MIN
    corners): buffered point inserts and deletes with the exact correction
    in the query path (K9-K11 on ``'cuda'``, K18-K20 on ``'cuda_scan'``);
    the merge runs
    ``selective_refit_2d``, touching only the leaves the changed points'
    dominance boundaries cross (its stats in ``last_refit_stats``).

    Single-writer, lock-free queries and (optionally background) merges as
    in ``DynamicEngine``; the plan, the buffer and every merged plan live
    on the index's device, and ``backend`` defaults as there.
    """

    def __init__(self, index: PolyFitIndex2D, *,
                 backend: Optional[str] = None, capacity: int = 1024,
                 min_bucket: int = 64, auto_refit: bool = True,
                 background: bool = False):
        if index.exact is None:
            raise ValueError("DynamicEngine2D requires keep_exact=True")
        self.device = index.device
        self._init_dynamic(backend=resolve_backend(backend, self.device),
                           capacity=capacity, min_bucket=min_bucket,
                           auto_refit=auto_refit, background=background)
        self._agg = index.agg
        self.last_refit_stats: Optional[dict] = None
        px = _host(index.exact.xs)
        py = _host(index.exact.ys_levels[0])
        if self._weighted:
            if index.measures_sorted is None:
                raise ValueError(f"a {self._agg} DynamicEngine2D needs an "
                                 "index built with measures")
            pw = np.asarray(index.measures_sorted)
        else:
            pw = np.ones_like(px)
        self._install(index, px, py, pw)

    @property
    def _weighted(self) -> bool:
        return self._agg != "count2d"

    @property
    def _extremal(self) -> bool:
        return self._agg in ("max2d", "min2d")

    # -- state ----------------------------------------------------------

    def _install(self, index: PolyFitIndex2D, px: np.ndarray, py: np.ndarray,
                 pw: np.ndarray, residual_ins: Optional[list] = None,
                 residual_del: Optional[list] = None,
                 residual_vic: Optional[list] = None,
                 plan: Optional[IndexPlan2D] = None) -> None:
        """Swap in a fresh (index, plan, empty-or-replayed buffer); the base
        points ``px, py, pw`` are x-sorted, aligned with the plan's
        refinement tree."""
        with self._lock:
            self._index = index
            self._px = px
            self._py = py
            self._pw = pw
            self._ins_log: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
            self._del_log: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
            self._n_pending = 0
            self._vic: List[int] = []
            self._residual_vic: List[Tuple[float, float, float]] = []
            self._merge_mark = None
            if plan is None:
                plan = build_plan_2d(index)
            buf = DeltaBuffer2D.empty(self.capacity, plan.dtype, plan.device,
                                      weighted=self._weighted)
            self._state = (plan, buf)
            for x, y, w in (residual_ins or []):
                if len(x):
                    self._log_ops(x, y, w, delete=False)
            if self._extremal:
                nan_dirty = False
                for xa, ya, wa in (residual_del or []):
                    for x, y, w in zip(xa, ya, wa):
                        nan_dirty |= self._delete_extremal_resolved(
                            float(x), float(y), float(w))
                for x, y, w in (residual_vic or []):
                    nan_dirty |= self._delete_extremal_resolved(x, y, w)
                if nan_dirty:
                    self._rebuild_ins_buf()
                if self._vic:
                    self._refresh_vic_buf()
            else:
                for x, y, w in (residual_del or []):
                    if len(x):
                        self._log_ops(x, y, w, delete=True)

    @property
    def plan(self) -> IndexPlan2D:
        return self._state[0]

    @property
    def index(self) -> PolyFitIndex2D:
        return self._index

    @property
    def agg(self) -> str:
        return self._agg

    # -- updates --------------------------------------------------------

    def _append(self, buf: DeltaBuffer2D, xs, ys, ws, delete: bool):
        """``buf`` with a batch appended to its insert or delete log (the
        merge-sort-tree levels only where K9-K11 read them)."""
        dt, dev = buf.ins_x.dtype, buf.ins_x.device
        to = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        p = "del_" if delete else "ins_"
        old = lambda f: getattr(buf, p + f)
        x, y, w, ylv, wcum, wpmax = _append_2d(
            old("x"), old("y"), old("w"), to(xs), to(ys),
            to(ws) if self._weighted else None, cap=buf.cap,
            levels=self.backend == "cuda", weighted=self._weighted)
        new = {"x": x, "y": y, "w": w}
        if ylv is not None:
            new["ylv"] = ylv
        if wcum is not None:
            new["wcum"] = wcum
        if wpmax is not None and not delete:
            new["wpmax"] = wpmax
        return dataclasses.replace(buf, **{p + f: t for f, t in new.items()})

    def _log_ops(self, xs: np.ndarray, ys: np.ndarray, ws: np.ndarray,
                 delete: bool) -> None:
        """Append a batch to the device buffer and the host log (locked)."""
        if self._n_pending + len(xs) > self.capacity:
            raise RuntimeError("delta buffer overflow: concurrent writers "
                               "bypassed _ensure_room")
        plan, buf = self._state
        self._state = (plan, self._append(buf, xs, ys, ws, delete))
        (self._del_log if delete else self._ins_log).append((xs, ys, ws))
        self._n_pending += len(xs)

    def insert(self, xs, ys, ws=None) -> None:
        """Buffer new points; ``ws`` are the measures of sum2d/max2d/min2d
        tables (count2d counts points, and takes none).

        A dominance insert *below the frozen extremal floor* merges
        eagerly: the plan's clamp over-reports every corner that dominates
        only the new point, and no monotone correction covers it —
        ``selective_refit_2d`` re-freezes the floor and refits exactly the
        leaves the old clamp touched."""
        # always copy: the host log owns these arrays (dominance deletes
        # NaN-cancel pending inserts in place)
        xs = np.atleast_1d(np.array(xs, np.float64))
        ys = np.atleast_1d(np.array(ys, np.float64))
        if not self._weighted:
            if ws is not None:
                raise ValueError("measures only apply to sum2d/max2d/min2d")
            ws = np.ones_like(xs)
        else:
            if ws is None:
                raise ValueError(f"measures required for agg={self._agg!r}")
            ws = np.broadcast_to(
                np.asarray(ws, np.float64), xs.shape).copy()
            if self._agg == "min2d":
                ws = -ws
        self._ensure_room(len(xs))
        with self._lock:
            self._log_ops(xs, ys, ws, delete=False)
            trigger = self.auto_refit and self._n_pending >= self.capacity
            floor = self._index.extremal_floor if self._extremal else None
            below_floor = floor is not None and bool((ws < floor).any())
        if below_floor:
            self.refit(wait=True)
        elif trigger:
            self.refit(wait=not self.background)

    def delete(self, xs, ys) -> None:
        """Buffer delete tombstones for existing points (KeyError when a
        point has no live occurrence).  Dominance MAX/MIN deletes shadow
        their victim (``vic_x``/``vic_y``/``live_wpmax``) instead of
        merging: corners dominating it refine against the victim-masked
        merge-sort tree, and the removal rides the next ordinary merge."""
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        ys = np.atleast_1d(np.asarray(ys, np.float64))
        self._ensure_room(len(xs))
        with self._lock:
            if self._extremal:
                nan_dirty = False
                for x, y in zip(xs, ys):
                    nan_dirty |= self._delete_extremal_one(float(x),
                                                           float(y))
                if nan_dirty:
                    self._rebuild_ins_buf()
                self._refresh_vic_buf()
            else:
                ws = []
                batch_tomb: dict = {}   # duplicates within the batch too
                for x, y in zip(xs, ys):
                    pt = (float(x), float(y))
                    ws.append(self._find_victim(
                        *pt, extra_tomb=batch_tomb.get(pt, 0)))
                    batch_tomb[pt] = batch_tomb.get(pt, 0) + 1
                self._log_ops(xs, ys, np.asarray(ws), delete=True)
            trigger = self.auto_refit and self._n_pending >= self.capacity
        if trigger:
            self.refit(wait=not self.background)

    def _shadow(self, pos: int) -> None:
        """Shadow base point ``pos``: victim mask plus an ordinary
        tombstone for the next merge (locked)."""
        self._vic.append(pos)
        self._log_ops(np.array([self._px[pos]]), np.array([self._py[pos]]),
                      np.array([float(self._pw[pos])]), delete=True)

    def _delete_extremal_one(self, x: float, y: float) -> bool:
        """Resolve one dominance delete: shadow the leftmost unshadowed base
        occurrence of (x, y), else NaN-cancel a pending insert.  Returns
        True on a NaN-cancel (the device insert log needs a rebuild)."""
        i0 = np.searchsorted(self._px, x, side="left")
        i1 = np.searchsorted(self._px, x, side="right")
        vic_set = set(self._vic)
        for pos in range(i0, i1):
            if self._py[pos] == y and pos not in vic_set:
                self._shadow(pos)
                return False
        for e, (xa, ya, wa) in enumerate(self._ins_log):
            hit = np.where((xa == x) & (ya == y) & ~np.isnan(xa))[0]
            if len(hit):
                j = int(hit[0])
                w = float(wa[j])
                xa[j] = ya[j] = wa[j] = np.nan
                self._n_pending -= 1
                if (self._merge_mark is not None
                        and e < self._merge_mark[0]):
                    # the in-flight merge copied this entry before the mark
                    # and will bake it into the new base — replay there
                    self._residual_vic.append((x, y, w))
                return True
        raise KeyError(f"delete of point ({x!r}, {y!r}): not present")

    def _delete_extremal_resolved(self, x: float, y: float,
                                  w: float) -> bool:
        """Replay a residual dominance delete against the fresh base
        (measure-matched victim preferred, then a pending insert, then any
        live occurrence).  Locked; returns True on a NaN-cancel."""
        i0 = np.searchsorted(self._px, x, side="left")
        i1 = np.searchsorted(self._px, x, side="right")
        vic_set = set(self._vic)
        cand = [p for p in range(i0, i1)
                if self._py[p] == y and p not in vic_set]
        pos = next((p for p in cand if self._pw[p] == w),
                   cand[0] if cand else None)
        if pos is not None:
            self._shadow(pos)
            return False
        for xa, ya, wa in self._ins_log:
            hit = np.where((xa == x) & (ya == y) & (wa == w)
                           & ~np.isnan(xa))[0]
            if len(hit):
                j = int(hit[0])
                xa[j] = ya[j] = wa[j] = np.nan
                self._n_pending -= 1
                return True
        raise KeyError(f"delete of point ({x!r}, {y!r}): not present")

    def _refresh_vic_buf(self) -> None:
        """Rebuild the buffer's victim mask (the shadowed points and the
        victim-masked weighted merge-sort tree) and swap it in."""
        plan, buf = self._state
        if not self._vic:
            if buf.vic_x is not None:
                self._state = (plan, dataclasses.replace(
                    buf, vic_x=None, vic_y=None, live_wpmax=None))
            return
        nv = len(self._vic)
        vcap = self.capacity
        while vcap < nv:
            vcap *= 2
        vic = np.asarray(self._vic)
        big = big_sentinel(torch.float64)
        vx = np.full((vcap,), big)
        vy = np.full((vcap,), big)
        vx[:nv] = self._px[vic]
        vy[:nv] = self._py[vic]
        ws = np.array(self._pw, np.float64, copy=True)
        ws[vic] = -np.inf
        # self._px is x-sorted, so the tree's stable argsort is the identity
        # and its positions align with plan.ref_*
        t = MergeSortTree.build(self._px, self._py, ws=ws)
        to = lambda a: torch.as_tensor(a, dtype=plan.dtype, device=plan.device)
        self._state = (plan, dataclasses.replace(
            buf, vic_x=to(vx), vic_y=to(vy), live_wpmax=to(t.wpmax_levels)))

    def _rebuild_ins_buf(self) -> None:
        """Rebuild the device insert log from the non-NaN host entries (one
        append), after a pending insert was cancelled."""
        plan, buf = self._state
        fresh = DeltaBuffer2D.empty(self.capacity, plan.dtype, plan.device,
                                    weighted=self._weighted)
        ix, iy, iw = self._flatten(self._ins_log, 3)
        alive = ~np.isnan(ix)
        if alive.any():
            fresh = self._append(fresh, ix[alive], iy[alive], iw[alive],
                                 delete=False)
        self._state = (plan, dataclasses.replace(
            buf, ins_x=fresh.ins_x, ins_y=fresh.ins_y, ins_w=fresh.ins_w,
            ins_ylv=fresh.ins_ylv, ins_wcum=fresh.ins_wcum,
            ins_wpmax=fresh.ins_wpmax))

    def _find_victim(self, x: float, y: float, extra_tomb: int = 0) -> float:
        """Measure (internal space) of the occurrence a tombstone removes:
        base occurrences first (x-order), then pending inserts; KeyError
        when every occurrence is already tombstoned."""
        tomb = extra_tomb + sum(int(np.sum((lx == x) & (ly == y)))
                                for lx, ly, _ in self._del_log)
        i0 = np.searchsorted(self._px, x, side="left")
        i1 = np.searchsorted(self._px, x, side="right")
        pool = list(self._pw[i0:i1][self._py[i0:i1] == y])
        for lx, ly, lw in self._ins_log:
            pool.extend(lw[(lx == x) & (ly == y)])
        if tomb >= len(pool):
            raise KeyError(f"delete of point ({x!r}, {y!r}): not present")
        return float(pool[tomb])

    # -- merge / refit (lifecycle in _DeltaBufferedEngine) ----------------

    def _snapshot(self):
        # deep-copy the log arrays: dominance deletes NaN-cancel pending
        # inserts in place on the host log
        self._merge_mark = (len(self._ins_log), len(self._del_log))
        self._residual_vic = []
        return (self._index, self._px, self._py, self._pw,
                [tuple(a.copy() for a in e) for e in self._ins_log],
                [tuple(a.copy() for a in e) for e in self._del_log])

    def _merge(self, snap, mark) -> None:
        index, px, py, pw, ins_log, del_log = snap
        ix, iy, iw = (np.array(a) for a in self._flatten(ins_log, 3))
        dx, dy, dw = self._flatten(del_log, 3)
        keep = np.ones(len(px), bool)
        for x, y, w in zip(dx, dy, dw):
            # a tombstone cancels a matching pending insert first, then the
            # base occurrence carrying the victim's measure
            m = np.where((ix == x) & (iy == y) & (iw == w)
                         & ~np.isnan(ix))[0]
            if len(m):
                ix[m[0]] = iy[m[0]] = iw[m[0]] = np.nan
                continue
            cand = np.where(keep & (px == x) & (py == y) & (pw == w))[0]
            if not len(cand):
                cand = np.where(keep & (px == x) & (py == y))[0]
            if not len(cand):
                raise KeyError(f"delete of point ({x!r}, {y!r})")
            keep[cand[0]] = False
        alive = ~np.isnan(ix)
        new_px = np.concatenate([px[keep], ix[alive]])
        new_py = np.concatenate([py[keep], iy[alive]])
        new_pw = np.concatenate([pw[keep], iw[alive]])
        if len(new_px) == 0:
            raise ValueError("merge would empty the dataset")
        # net changes only: an insert+delete pair that cancelled inside the
        # buffer never touched the fitted function
        removed = ~keep
        cx = np.concatenate([ix[alive], px[removed]])
        cy = np.concatenate([iy[alive], py[removed]])
        cw = np.concatenate([iw[alive], -pw[removed]])
        new_index, stats = selective_refit_2d(index, new_px, new_py, new_pw,
                                              cx, cy, cw)
        order = np.argsort(new_px, kind="stable")
        # build and upload the plan OFF the lock, and let the upload finish
        # before the swap: a query must never read a plan mid-copy
        new_plan = build_plan_2d(new_index)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._notify_install_listeners(new_plan)
        with self._lock:
            residual_ins = [tuple(a[~np.isnan(e[0])] for a in e)
                            for e in self._ins_log[mark[0]:]]
            residual_del = self._del_log[mark[1]:]
            residual_vic = list(self._residual_vic)
            self._install(new_index, new_px[order], new_py[order],
                          new_pw[order], residual_ins, residual_del,
                          residual_vic, plan=new_plan)
            self.last_refit_stats = stats
            self.refit_count += 1

    # -- queries ---------------------------------------------------------

    def _run(self, executor, ranges, eps_rel, exact) -> QueryResult:
        plan, buf = self._state
        if eps_rel is not None and getattr(plan, exact) is None:
            raise ValueError("Q_rel refinement requires exact arrays")
        qs, n = _prepare(*ranges, min_bucket=self.min_bucket, plan=plan)
        ans, approx, refined = executor(plan, buf, *qs, backend=self.backend,
                                        eps_rel=eps_rel)
        return QueryResult(ans[:n], approx[:n], refined[:n])

    def count2d(self, lx, ux, ly, uy,
                eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("count2d")
        return self._run(_exec_dyn_rect2d, (lx, ux, ly, uy), eps_rel,
                         "ref_xs")

    def sum2d(self, lx, ux, ly, uy,
              eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("sum2d")
        return self._run(_exec_dyn_rect2d, (lx, ux, ly, uy), eps_rel,
                         "ref_xs")

    def extremum2d(self, u, v,
                   eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("max2d", "min2d")
        return self._run(_exec_dyn_dommax2d, (u, v), eps_rel, "ref_wpmax")

    def query(self, *ranges, eps_rel: Optional[float] = None) -> QueryResult:
        if self._agg == "count2d":
            return self.count2d(*ranges, eps_rel=eps_rel)
        if self._agg == "sum2d":
            return self.sum2d(*ranges, eps_rel=eps_rel)
        return self.extremum2d(*ranges, eps_rel=eps_rel)
