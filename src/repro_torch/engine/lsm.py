"""LSM-tiered PolyFit: a geometric ladder of immutable plans.

The twin of ``repro.engine.lsm``.  The single delta buffer of
``DynamicEngine`` has two cliffs: a full merge stalls, and an extremal
delete waits for the next merge.  The logarithmic method turns the index
into a hierarchy of geometrically-sized immutable levels: slot ``s`` holds
at most ``capacity * growth**s`` rows, each level is one ordinary
``IndexPlan``/``IndexPlan2D`` fitted once with ``build_index_*`` and never
touched again, and a query fuses the O(log n) per-level evaluations
exactly —

* SUM/COUNT partials **add** across levels; per-level tombstones are exact
  side arrays (sorted keys + prefix sums, or a merge-sort tree over the
  deleted points), so their subtraction adds **no** error and the
  certified bound composes additively over the *data* plans only:
  ``B = sum_k FACTOR * delta_k`` (``composed_bound``).
* MAX/MIN take a **max** across levels; a deleted extremum is shadowed by a
  per-level victim mask (``vic_keys`` + a victim-masked exact sparse table
  or merge-sort tree) — queries whose range covers a victim take the
  level's exact answer, every other query the untouched fitted plan, and
  **no delete ever merges eagerly**.

Kernels, per level and for the level-0 buffer, as the flat engines route
them: each level's raw answer is K2 (SUM/COUNT), K3 (MAX/MIN), K7
(rectangles) or K8 (corners, and the out-of-root corner corrections of a
rectangle level) on ``'cuda'``, K14, K15, K12 and K13 on ``'cuda_scan'``;
the buffer's exact correction is K5, K6, K9, K10 or K11 on ``'cuda'``, the
whole-log scans K16-K20 on ``'cuda_scan'``; the sorted-key and x-rank
searches of the exact answers (Q_rel truths and the extremal levels'
live maxima) run K1 on both card backends.  Tombstone corrections are
plain torch searches, as the reference runs them as plain XLA.

Compactions are the only writes that touch fitted structures: when the
policy fires, levels ``0..s`` (buffer included) merge into one fresh plan
for slot ``s`` on the merge thread — work proportional to the compacted
rows, never a full-ladder refit — and install atomically.  The trigger is
cost-based (``CompactionPolicy``), with capacity as the hard backstop.

Per-level answers are bit-identical to the flat ``execute_*`` executors
for in-domain queries: every multi-level correction (the below-domain
first-key addend, the out-of-root corner corrections, the validity masks)
is exactly ``+0.0`` / identity when the query lies inside the level's
domain, so a one-level ladder reproduces the flat engine bit for bit.
The epoch ring of ``engine/window.py`` runs its windows through
``execute_lsm`` too.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import DTYPE, resolve_device
from ..core.exact import build_sparse_table, sparse_table_range_max
from ..core.index import build_index_1d
from ..core.index2d import (MergeSortTree, build_index_2d, mst_cf_sum,
                            mst_weighted_prefix)
from ..core.queries import QueryResult
from .dynamic import (DeltaBuffer, DeltaBuffer2D, _append_1d, _append_2d,
                      _DeltaBufferedEngine, _delta_count2d, _delta_dommax2d,
                      _delta_max, _delta_sum, _delta_sum2d)
from .engine import (_bucket_size, _pad_bucket, _x_ranks, check_pow2,
                     execute_extremum, key_span, pad_fills, raw_count2d,
                     raw_eval2d, raw_extremum, raw_sum, resolve_backend,
                     truth_count2d, truth_sum, truth_sum2d)
from .plan import (IndexPlan, IndexPlan2D, big_sentinel, build_plan,
                   build_plan_2d)

__all__ = ["LsmLevel", "LsmLevel2D", "LsmPlan", "LsmPlan2D", "LsmEngine",
           "LsmEngine2D", "CompactionPolicy", "composed_bound",
           "execute_lsm", "level_executor", "combine_levels"]

_EXTREMAL = ("max", "min", "max2d", "min2d")


# ---------------------------------------------------------------------------
# one immutable level = one fitted plan + exact delete side arrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LsmLevel:
    """One immutable 1-D level: the fitted plan plus delete shadows.

    ``tomb_keys``/``tomb_cf`` (SUM/COUNT) are the level's tombstoned
    records — sorted keys + inclusive prefix sums of the deleted measures;
    their range sum is subtracted exactly, adding no error.
    ``vic_keys``/``live_st`` (MAX/MIN) mask deleted extrema: ``vic_keys`` is
    the sentinel-padded sorted victim-key array the threat test scans,
    ``live_st`` the exact sparse table with victim slots at -inf (None
    until the first victim: the plan's ``ref_st`` serves).  The fitted plan
    itself is never modified — level identity is plan identity.
    """

    plan: IndexPlan
    tomb_keys: Optional[torch.Tensor]   # (t,) sorted; None when no tombs
    tomb_cf: Optional[torch.Tensor]     # (t,) inclusive prefix sums
    vic_keys: Optional[torch.Tensor]    # (vcap,) sorted, sentinel-padded
    live_st: Optional[torch.Tensor]     # (L, n) victim-masked sparse table
    slot: int


@dataclasses.dataclass(frozen=True)
class LsmLevel2D:
    """One immutable 2-D level (rect COUNT/SUM or dominance MAX/MIN).

    Tombstones are a merge-sort tree over the deleted points (weights 1 for
    count2d), subtracted through the exact 4-corner ``mst_cf_sum``; victims
    mirror the 1-D scheme with a dominance threat test and a victim-masked
    ``live_wpmax`` (None until the first victim: the plan's ``ref_wpmax``
    serves).
    """

    plan: IndexPlan2D
    tomb_xs: Optional[torch.Tensor]          # (t,)
    tomb_ys_levels: Optional[torch.Tensor]   # (L, t)
    tomb_wcum: Optional[torch.Tensor]        # (L, t)
    vic_x: Optional[torch.Tensor]            # (vcap,) sentinel-padded
    vic_y: Optional[torch.Tensor]            # (vcap,)
    live_wpmax: Optional[torch.Tensor]       # (L, n) victim-masked
    slot: int


@dataclasses.dataclass(frozen=True)
class LsmPlan:
    """The immutable level ladder, ascending slot order (newest first)."""

    levels: Tuple[LsmLevel, ...]
    agg: str

    @property
    def device(self) -> torch.device:
        return self.levels[0].plan.device

    @property
    def deltas(self) -> Tuple[float, ...]:
        return tuple(lvl.plan.delta for lvl in self.levels)

    def size_bytes(self) -> int:
        """The levels' index sizes, summed (the paper's metric a level)."""
        return sum(lvl.plan.size_bytes() for lvl in self.levels)


@dataclasses.dataclass(frozen=True)
class LsmPlan2D(LsmPlan):
    """The immutable 2-D level ladder, ascending slot order."""

    levels: Tuple[LsmLevel2D, ...]


def composed_bound(agg: str, deltas) -> float:
    """Certified |A - R| bound of the fused multi-level answer.

    Tombstone/victim corrections are exact, so only the data plans
    contribute: additive aggregates sum the per-level Lemma bounds,
    extremal ones take the worst level."""
    from ..api.budget import BOUND_FACTOR   # lazy: api imports engine
    f = BOUND_FACTOR[agg]
    if agg in _EXTREMAL:
        return f * max(deltas)
    return f * sum(deltas)


# ---------------------------------------------------------------------------
# per-level cores: flat raw evaluation + exact boundary corrections.
# Every correction is exactly +0.0 / identity for in-domain queries, so a
# single-level ladder is bit-identical to the flat executors per backend.
# ---------------------------------------------------------------------------

def _cf_at(keys, cf, q):
    """Inclusive prefix CF at q: sum of measures with key <= q."""
    idx = torch.searchsorted(keys, q, right=True)
    return torch.cat([cf.new_zeros(1), cf])[idx]


def _tomb_sum_1d(lvl: LsmLevel, lq, uq):
    return (_cf_at(lvl.tomb_keys, lvl.tomb_cf, uq)
            - _cf_at(lvl.tomb_keys, lvl.tomb_cf, lq))


def _level_sum(lvl: LsmLevel, lq, uq, *, backend: str, with_truth: bool):
    """(partial, truth?) for SUM/COUNT over (lq, uq] against one level."""
    p = lvl.plan
    lo = p.seg_lo[0]
    lqc = torch.maximum(lq, lo)
    uqc = torch.maximum(uq, lo)
    part = raw_sum(p, lqc, uqc, backend=backend)
    # the fitted CF is inclusive: clamping lq up to the level's first key
    # subtracts ~P(lo) ~= m0, excluding that key's measure from queries
    # that start below this level's domain — add it back (exactly +0.0
    # when the query is in-domain, preserving flat bit-identity)
    m0 = p.ref_cf[0]
    part = part + torch.where((lq < lo) & (uq >= lo), m0,
                              torch.zeros((), dtype=p.dtype, device=p.device))
    if lvl.tomb_keys is not None:
        part = part - _tomb_sum_1d(lvl, lq, uq)
    if not with_truth:
        return (part,)
    truth = truth_sum(p, lq, uq, backend=backend)
    if lvl.tomb_keys is not None:
        truth = truth - _tomb_sum_1d(lvl, lq, uq)
    return part, truth


def _threat_1d(vic, lq, uq):
    if vic is None:
        return torch.zeros(lq.shape, dtype=torch.bool, device=lq.device)
    vk = vic[None, :]
    return ((lq[:, None] <= vk) & (vk <= uq[:, None])).any(dim=1)


def _level_extremum(lvl: LsmLevel, lq, uq, *, backend: str,
                    with_truth: bool):
    """(partial, exact, threat) for MAX over [lq, uq] (MAX space).

    The exact live maximum is always computed: it both refines Q_rel
    rejections and answers threatened queries (range covers a victim),
    where the fitted plan may over-report a deleted extremum."""
    del with_truth   # extremal levels always carry their exact answer
    p = lvl.plan
    lo = p.seg_lo[0]
    hi = p.seg_hi[p.h - 1]
    lqc = torch.clamp(lq, lo, hi)
    uqc = torch.clamp(uq, lo, hi)
    raw = raw_extremum(p, lqc, uqc, backend=backend)
    st = lvl.live_st if lvl.live_st is not None else p.ref_st
    exact = sparse_table_range_max(
        st, *key_span(p.ref_keys, lq, uq, backend, p.ref_tree))
    # a level contributes -inf when it has no live key in range: the fitted
    # staircase is only certified where the level holds data, and a
    # key-free level's segment value would out-shout a smaller true maximum
    # living in another level.  The mask is exact (sparse-table emptiness)
    # and the identity branch is taken for every query that covers a live
    # key, preserving single-level flat bit-identity.
    valid = (uq >= lo) & (lq <= hi) & (exact > -torch.inf)
    # the continuum certificate holds the fitted staircase within delta at
    # the level's own keys and critical points; at an endpoint between two
    # keys of this level (a key of another level) the polynomial may lean
    # towards the next key, outside the range.  The exact live maximum is
    # at hand, so the part is held within delta of it: the identity
    # wherever the certificate reaches (the reference leaves it unheld)
    raw = torch.clamp(raw, exact - p.delta, exact + p.delta)
    part = torch.where(valid, raw, -torch.inf)
    return part, exact, _threat_1d(lvl.vic_keys, lq, uq)


def _tomb_rect_2d(lvl: LsmLevel2D, lx, ux, ly, uy, dtype):
    cf = lambda u, v: mst_cf_sum(lvl.tomb_xs, lvl.tomb_ys_levels,
                                 lvl.tomb_wcum, u, v)
    return (cf(ux, uy) - cf(lx, uy) - cf(ux, ly) + cf(lx, ly)).to(dtype)


def _level_rect(lvl: LsmLevel2D, lx, ux, ly, uy, *, backend: str,
                with_truth: bool):
    """(partial, truth?) for rect COUNT/SUM against one 2-D level.

    Clamped-corner scheme: the flat 4-corner evaluation runs on
    root-clamped corners (bit-identical in-domain), then each corner whose
    raw coordinate lies *below* the level's root gets its clamped
    evaluation subtracted back out — CF at such a corner is exactly 0,
    while the clamp left ~CF(root-edge) in the sum."""
    p = lvl.plan
    x0, x1, y0, y1 = p.root
    lxc, uxc = (torch.clamp(q, x0, x1) for q in (lx, ux))
    lyc, uyc = (torch.clamp(q, y0, y1) for q in (ly, uy))
    part = raw_count2d(p, lxc, uxc, lyc, uyc, backend=backend)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for u, v, uc, vc, s in ((ux, uy, uxc, uyc, 1.0), (lx, uy, lxc, uyc, -1.0),
                            (ux, ly, uxc, lyc, -1.0), (lx, ly, lxc, lyc, 1.0)):
        e = raw_eval2d(p, uc, vc, backend=backend)
        part = part + torch.where((u < x0) | (v < y0), -s * e, zero)
    if lvl.tomb_xs is not None:
        part = part - _tomb_rect_2d(lvl, lx, ux, ly, uy, p.dtype)
    if not with_truth:
        return (part,)
    truth = (truth_sum2d if p.agg == "sum2d" else truth_count2d)(
        p, lx, ux, ly, uy, backend=backend)
    if lvl.tomb_xs is not None:
        truth = truth - _tomb_rect_2d(lvl, lx, ux, ly, uy, p.dtype)
    return part, truth


def _level_dommax(lvl: LsmLevel2D, u, v, *, backend: str, with_truth: bool):
    """(partial, exact, threat) for dominance MAX at (u, v) (MAX space)."""
    del with_truth
    p = lvl.plan
    x0, x1, y0, y1 = p.root
    uc = torch.clamp(u, x0, x1)
    vc = torch.clamp(v, y0, y1)
    raw = raw_eval2d(p, uc, vc, backend=backend)
    wp = lvl.live_wpmax if lvl.live_wpmax is not None else p.ref_wpmax
    (i,) = _x_ranks(p, backend, u)
    exact = mst_weighted_prefix(p.ref_xs, p.ref_ys_levels, wp, i, v,
                                mode="max").to(p.dtype)
    # as in 1-D: a level whose dominated set is empty contributes -inf (the
    # fitted staircase's extremal-floor clamp would otherwise report
    # ~level-min for corners dominating nothing in this level — including
    # a fresh buffered point below every level floor, which the exact
    # level-0 correction answers alone)
    valid = (u >= x0) & (v >= y0) & (exact > -torch.inf)
    part = torch.where(valid, raw, -torch.inf)
    if lvl.vic_x is not None:
        threat = ((lvl.vic_x[None, :] <= u[:, None])
                  & (lvl.vic_y[None, :] <= v[:, None])).any(dim=1)
    else:
        threat = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    return part, exact, threat


_LEVEL_CORES = {
    "sum": _level_sum, "count": _level_sum,
    "max": _level_extremum, "min": _level_extremum,
    "count2d": _level_rect, "sum2d": _level_rect,
    "max2d": _level_dommax, "min2d": _level_dommax,
}


def level_executor(agg: str, *, backend: str, with_truth: bool):
    """A plain callable ``fn(level, *padded_queries)`` with all statics
    closed over — the per-level unit a serving engine caches by (table,
    guarantee, bucket, slot), so a compaction evicts only the rebuilt
    levels' executables."""
    core = _LEVEL_CORES[agg]

    def fn(lvl, *qs):
        return core(lvl, *qs, backend=backend, with_truth=with_truth)
    return fn


def _run_level(lvl, *qs, agg: str, backend: str, with_truth: bool):
    return _LEVEL_CORES[agg](lvl, *qs, backend=backend,
                             with_truth=with_truth)


# ---------------------------------------------------------------------------
# cross-level combiners
# ---------------------------------------------------------------------------

def _buf_corr_additive(buf, qs, *, agg: str, backend: str, dtype):
    """Exact level-0 (delta buffer) contribution, answer space.  Only the
    insert side exists: deletes of buffered inserts cancel in place, and
    deletes of level rows become per-level tombstones/victims."""
    if agg in ("sum", "count"):
        lq, uq = qs
        return _delta_sum(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_cf,
                          backend=backend)
    lx, ux, ly, uy = qs
    if agg == "count2d":
        return _delta_count2d(lx, ux, ly, uy, buf.ins_x, buf.ins_y,
                              buf.ins_ylv, backend=backend).to(dtype)
    return _delta_sum2d(lx, ux, ly, uy, buf.ins_x, buf.ins_y, buf.ins_w,
                        buf.ins_ylv, buf.ins_wcum, backend=backend)


def _buf_corr_extremal(buf, qs, *, agg: str, backend: str):
    """Exact level-0 insert maximum, MAX space."""
    if agg in ("max", "min"):
        lq, uq = qs
        return _delta_max(lq, uq, buf.ins_keys, buf.ins_vals, buf.ins_st,
                          backend=backend)
    u, v = qs
    return _delta_dommax2d(u, v, buf.ins_x, buf.ins_y, buf.ins_w,
                           buf.ins_ylv, buf.ins_wpmax, backend=backend)


def _combine_additive(parts, truths, buf, qs, *, agg: str, backend: str,
                      eps_rel: Optional[float], bound: float):
    """SUM/COUNT/rect2d fusion: per-level partials add; the composed bound
    drives the same acceptance shape the flat executors use (identical
    floats for a one-level ladder)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    corr = None
    if buf is not None:
        corr = _buf_corr_additive(buf, qs, agg=agg, backend=backend,
                                  dtype=total.dtype)
        total = total + corr
    if eps_rel is None:
        return total, total, torch.zeros(total.shape, dtype=torch.bool,
                                          device=total.device)
    if agg in ("sum", "count"):
        # Lemma 5.2 shape with the composed bound B = sum_k 2*delta_k
        ok = ((total - bound > 0)
              & (bound / torch.clamp(total - bound, min=1e-300) <= eps_rel))
    else:
        # Lemma 6.4 shape with B = sum_k 4*delta_k
        ok = total >= bound * (1.0 + 1.0 / eps_rel)
    truth = truths[0]
    for t in truths[1:]:
        truth = truth + t
    if corr is not None:
        truth = truth + corr
    return torch.where(ok, total, truth), total, ~ok


def _combine_extremal(parts, exacts, threats, buf, qs, *, agg: str,
                      backend: str, eps_rel: Optional[float], bound: float):
    """MAX/MIN fusion (MAX space in, answer space out): partials max across
    levels; any threatened level (range covers a victim) forces the exact
    answer — which is free, because every level carries its exact live
    maximum."""
    approx = parts[0]
    exact = exacts[0]
    threat = threats[0]
    for p, e, t in zip(parts[1:], exacts[1:], threats[1:]):
        approx = torch.maximum(approx, p)
        exact = torch.maximum(exact, e)
        threat = threat | t
    if buf is not None:
        ins = _buf_corr_extremal(buf, qs, agg=agg, backend=backend)
        approx = torch.maximum(approx, ins)
        exact = torch.maximum(exact, ins)
    neg = agg in ("min", "min2d")
    if eps_rel is None:
        ans = torch.where(threat, exact, approx)
        if neg:
            ans, approx = -ans, -approx
        return ans, approx, threat
    # Lemma 5.4 shape with B = max_k delta_k; threats always refine
    ok = (~threat) & (approx >= bound * (1.0 + 1.0 / eps_rel))
    ans = torch.where(ok, approx, exact)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def combine_levels(agg: str, level_outs, buf, qs, *, backend: str,
                   eps_rel: Optional[float], bound: float):
    """Fuse per-level core outputs (+ optional delta buffer) into the final
    (ans, approx, refined) triple."""
    if agg in _EXTREMAL:
        parts, exacts, threats = zip(*level_outs)
        return _combine_extremal(parts, exacts, threats, buf, tuple(qs),
                                 agg=agg, backend=backend, eps_rel=eps_rel,
                                 bound=bound)
    parts = tuple(o[0] for o in level_outs)
    truths = (tuple(o[1] for o in level_outs)
              if eps_rel is not None else ())
    return _combine_additive(parts, truths, buf, tuple(qs), agg=agg,
                             backend=backend, eps_rel=eps_rel, bound=bound)


# ---------------------------------------------------------------------------
# the multi-level executor (session, window ring and engines route here)
# ---------------------------------------------------------------------------

def execute_lsm(lsm: LsmPlan, buf, ranges, *, backend: Optional[str] = None,
                eps_rel: Optional[float] = None, min_bucket: int = 64,
                level_runner=None) -> QueryResult:
    """Execute a query batch against an ``LsmPlan``/``LsmPlan2D`` ladder
    plus an optional level-0 delta buffer.

    ``level_runner(i, level, *padded_queries)`` overrides the per-level
    evaluation (a serving engine's cached per-level executables); the
    default is the module-level core.  MAX/MIN ladders holding a level of
    degree > 3 take the ``'torch'`` path whatever the backend, as the flat
    engine routes them (counted in ``execute_extremum.torch_routes``)."""
    agg = lsm.agg
    backend = resolve_backend(backend, lsm.device)
    if agg in ("max", "min") and backend in ("cuda", "cuda_scan", "ref") \
            and any(lvl.plan.deg > 3 for lvl in lsm.levels):
        backend = "torch"   # no in-kernel closed form past deg 3
        execute_extremum.torch_routes += 1
    check_pow2("min_bucket", min_bucket)
    dev = lsm.device
    qs = [torch.as_tensor(q, dtype=DTYPE, device=dev).reshape(-1)
          for q in ranges]
    n = qs[0].shape[0]
    size = _bucket_size(n, min_bucket)
    fills = pad_fills(lsm.levels[0].plan)
    qs = [_pad_bucket(q, size, torch.as_tensor(f, dtype=DTYPE, device=dev)
                      .reshape(1)) for q, f in zip(qs, fills)]
    with_truth = eps_rel is not None
    if level_runner is None:
        def level_runner(i, lvl, *padded):
            return _run_level(lvl, *padded, agg=agg, backend=backend,
                              with_truth=with_truth)
    outs = [level_runner(i, lvl, *qs) for i, lvl in enumerate(lsm.levels)]
    ans, approx, refined = combine_levels(
        agg, outs, buf, qs, backend=backend, eps_rel=eps_rel,
        bound=composed_bound(agg, lsm.deltas))
    return QueryResult(ans[:n], approx[:n], refined[:n])


# ---------------------------------------------------------------------------
# cost-based compaction policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompactionPolicy:
    """Compact when the accumulated buffered-query overhead has paid for
    the merge, with capacity (and a watermark fraction of it) as hard
    backstops.  ``from_bench`` reads the coefficients from measured update
    records: merge cost scales per compacted row, buffered-query overhead
    per (query x buffered row)."""

    watermark: float = 0.5
    merge_us_per_row: float = 75.0
    query_overhead_us_per_row: float = 1e-3
    shadow_fraction: float = 0.25
    source: str = "defaults"

    @classmethod
    def from_bench(cls, path: Optional[str] = None, *,
                   dim: int = 1) -> "CompactionPolicy":
        """The policy of the update records at ``path``, else of
        ``BENCH_torch_updates.json`` in the working directory or at the
        repository root (the port's own records), else the defaults."""
        cands = ([Path(path)] if path else []) + [
            Path.cwd() / "BENCH_torch_updates.json",
            Path(__file__).resolve().parents[3] / "BENCH_torch_updates.json",
        ]
        for p in cands:
            try:
                records = json.loads(p.read_text())
            except (OSError, ValueError):
                continue
            merge_us = overhead = None
            for rec in records:
                meta = rec.get("meta", {})
                if int(meta.get("dim", 1)) != dim:
                    continue
                n = meta.get("n") or meta.get("n2")
                cap = meta.get("capacity")
                full = post = None
                for r in rec.get("results", []):
                    us = r.get("us_per_query")
                    if us is None:
                        continue
                    name = r.get("name", "")
                    if ".merge." in name and n:
                        merge_us = max(merge_us or 0.0, us / float(n))
                    if ".query_full." in name:
                        full = max(full or 0.0, us)
                    if ".query_postmerge." in name:
                        post = max(post or 0.0, us)
                if full is not None and post is not None and cap:
                    overhead = max(overhead or 0.0,
                                   max(0.0, full - post) / float(cap))
            if merge_us is not None:
                return cls(merge_us_per_row=merge_us,
                           query_overhead_us_per_row=overhead or 1e-3,
                           source=str(p))
        return cls()

    def should_compact(self, *, n_pending: int, capacity: int,
                       queries_since: int, rows_to_compact: int) -> bool:
        if n_pending <= 0:
            return False
        if n_pending >= capacity or n_pending >= self.watermark * capacity:
            return True
        debt = queries_since * self.query_overhead_us_per_row * n_pending
        return debt >= self.merge_us_per_row * max(rows_to_compact, 1)

    def should_fold(self, *, shadow_rows: int, live_rows: int) -> bool:
        """Fold a level whose tombstone/victim mass dominates its live
        mass: shadow rows are carried by every query over the level yet
        answer nothing, so past the fraction the one-time merge pays for
        itself — and without it the mass is carried *forever* (deletes
        never merge on their own)."""
        if shadow_rows <= 0:
            return False
        return shadow_rows >= self.shadow_fraction * max(live_rows, 1)


# ---------------------------------------------------------------------------
# host-side level bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostLevel:
    """Mutable host mirror of one immutable level: the raw sorted columns
    (internal measure space, positions aligned with ``plan.ref_*``), the
    fitted index, the cached device level, and the delete shadows as
    ``(pos, *record)`` tuples.  The device *plan* object is reused across
    shadow refreshes — deletes never change it."""

    slot: int
    cols: Tuple[np.ndarray, ...]
    index: object
    level: object = None
    tomb: List[tuple] = dataclasses.field(default_factory=list)
    vic: List[tuple] = dataclasses.field(default_factory=list)

    def live_rows(self) -> int:
        return len(self.cols[0]) - len(self.tomb) - len(self.vic)

    def shadowed(self) -> set:
        return {r[0] for r in self.tomb} | {r[0] for r in self.vic}


def _pow2_at_least(n: int) -> int:
    return max(1, 1 << (max(n, 1) - 1).bit_length())


class _LsmBase(_DeltaBufferedEngine):
    """Shared LSM lifecycle: the geometric slot ladder, delete shadowing,
    NaN-cancel of buffered inserts, level compaction with residual replay,
    and the cost-based trigger.  Subclasses supply the dim-specific hooks
    (column arity, index and plan construction, level refresh, buffer
    appends).

    Writes are serialized by the inherited lock; queries are lock-free
    against the immutable ``(LsmPlan, DeltaBuffer)`` snapshot in
    ``self._state``.  Deletes NEVER merge: they shadow a row of the oldest
    level holding it (tombstone for additive aggregates, victim mask for
    extremal ones) or cancel a pending buffered insert in place — the
    worst-case delete cost is one shadow-structure rebuild, not a refit.
    Levels and the buffer live on ``device`` (the card by default), and
    ``backend`` defaults to ``'cuda'`` there and ``'torch'`` on the CPU.
    """

    def _init_lsm(self, *, agg: str, backend: Optional[str], capacity: int,
                  growth: int, min_bucket: int, auto_refit: bool,
                  background: bool, policy, dim: int, device) -> None:
        if growth < 2:
            raise ValueError(f"growth must be >= 2, got {growth}")
        self.device = resolve_device(device)
        self._init_dynamic(backend=resolve_backend(backend, self.device),
                           capacity=capacity, min_bucket=min_bucket,
                           auto_refit=auto_refit, background=background)
        self._agg = agg
        self.growth = int(growth)
        self.policy = policy or CompactionPolicy.from_bench(dim=dim)
        self.compaction_count = 0
        self._levels: dict = {}
        self._ins_log: List[Tuple[np.ndarray, ...]] = []
        self._del_log: List[tuple] = []   # always empty (refit-mark compat)
        self._n_pending = 0
        self._queries_since = 0
        self._merging_slots: set = set()
        self._merge_mark_ins = 0
        self._residual_shadow: List[tuple] = []

    # -- basic accessors --------------------------------------------------

    @property
    def agg(self) -> str:
        return self._agg

    @property
    def _extremal(self) -> bool:
        return self._agg in _EXTREMAL

    @property
    def plan(self):
        """The installed multi-level plan (``LsmPlan``/``LsmPlan2D``)."""
        return self._state[0]

    @property
    def n_levels(self) -> int:
        return len(self._levels)

    @property
    def n(self) -> int:
        """Live rows across the ladder + buffered inserts."""
        return (sum(h.live_rows() for h in self._levels.values())
                + self._n_pending)

    def _ladder(self):
        return self._make_plan(tuple(self._levels[s].level
                                     for s in sorted(self._levels)))

    # -- construction -----------------------------------------------------

    def _initial_install(self, cols: Tuple[np.ndarray, ...]) -> None:
        if len(cols[0]) == 0:
            raise ValueError("an LSM engine needs at least one record")
        s = 1
        while len(cols[0]) > self.capacity * self.growth ** s:
            s += 1
        host = self._build_host(s, cols)
        with self._lock:
            self._levels = {s: host}
            self._state = (self._ladder(), self._empty_buf())

    # -- geometric slot ladder --------------------------------------------

    def _pick_slot(self) -> int:
        """Smallest slot whose geometric budget holds the buffer plus every
        level at or below it (the logarithmic-method invariant: slot s
        carries at most capacity * growth**s rows)."""
        s = 1
        while True:
            rows = self._n_pending + sum(
                h.live_rows() for k, h in self._levels.items() if k <= s)
            if rows <= self.capacity * self.growth ** s:
                return s
            s += 1

    def _shadow_slots(self) -> set:
        """Slots whose delete-shadow mass crossed the fold fraction."""
        return {s for s, h in self._levels.items()
                if self.policy.should_fold(
                    shadow_rows=len(h.tomb) + len(h.vic),
                    live_rows=h.live_rows())}

    def _has_forced_work(self) -> bool:
        # a shadow-heavy level must fold even with zero pending inserts
        return bool(self._shadow_slots())

    def _should_compact(self) -> bool:
        if self._shadow_slots():
            return True
        s = self._pick_slot()
        rows = self._n_pending + sum(
            h.live_rows() for k, h in self._levels.items() if k <= s)
        return self.policy.should_compact(
            n_pending=self._n_pending, capacity=self.capacity,
            queries_since=self._queries_since, rows_to_compact=rows)

    # -- inserts ----------------------------------------------------------

    def _log_ins(self, *cols) -> None:
        if self._n_pending + len(cols[0]) > self.capacity:
            raise RuntimeError("delta buffer overflow: concurrent writers "
                               "bypassed _ensure_room")
        ladder, buf = self._state
        buf = self._buf_append(buf, *cols)
        self._ins_log.append(tuple(cols))
        self._state = (ladder, buf)
        self._n_pending += len(cols[0])

    def _insert_batch(self, cols: Tuple[np.ndarray, ...]) -> None:
        self._raise_refit_error()
        self._ensure_room(len(cols[0]))
        with self._lock:
            self._log_ins(*cols)
            trigger = self.auto_refit and self._should_compact()
        if trigger:
            self.refit(wait=not self.background)

    # -- deletes (never merge) --------------------------------------------

    def _delete_batch(self, recs: List) -> None:
        """Shadow each record: oldest level holding it first (largest
        slot), then the pending-insert log (cancelled in place by
        NaN-marking).  Raises KeyError on a record with no live
        occurrence; records earlier in the batch stay applied."""
        self._raise_refit_error()
        with self._lock:
            dirty: set = set()
            nan_dirty = False
            try:
                for r in recs:
                    nan_dirty |= self._delete_one(r, dirty)
            finally:
                for slot in dirty:
                    h = self._levels[slot]
                    h.level = self._refresh_level(h)
                buf = self._state[1]
                if nan_dirty:
                    buf = self._rebuild_buf()
                self._state = (self._ladder(), buf)
            trigger = self.auto_refit and bool(self._shadow_slots())
        if trigger:
            self.refit(wait=not self.background)

    def _delete_one(self, rec, dirty: set) -> bool:
        for slot in sorted(self._levels, reverse=True):   # oldest first
            h = self._levels[slot]
            pos = self._find_in_level(h, rec)
            if pos is None:
                continue
            record = self._level_record(h, pos)
            (h.vic if self._extremal else h.tomb).append((pos,) + record)
            dirty.add(slot)
            if slot in self._merging_slots:
                # this row was copied into the in-flight compaction before
                # we shadowed it; re-apply the shadow on the fresh level
                self._residual_shadow.append(record)
            return False
        hit = self._find_in_ins(rec)
        if hit is not None:
            e, j = hit
            record = self._nan_mark(e, j)
            self._n_pending -= 1
            if self._merging_slots and e < self._merge_mark_ins:
                # the merge snapshot copied this entry un-cancelled
                self._residual_shadow.append(record)
            return True
        raise KeyError(f"delete of {rec!r}: no live occurrence")

    def _rebuild_buf(self):
        """Fresh device buffer from the surviving (non-NaN) insert log —
        one append, so a cancel costs one append like an insert."""
        buf = self._empty_buf()
        cols = [[] for _ in range(self._ncols)]
        for e in self._ins_log:
            alive = ~np.isnan(np.asarray(e[0]))
            if alive.any():
                for i, c in enumerate(e):
                    cols[i].append(np.asarray(c)[alive])
        if cols[0]:
            buf = self._buf_append(buf, *(np.concatenate(c) for c in cols))
        return buf

    # -- compaction (merge lifecycle in _DeltaBufferedEngine) -------------

    def _snapshot(self):
        # under self._lock (called from _start_refit)
        s = self._pick_slot()
        # shadow-heavy levels fold regardless of their slot; growing the
        # target slot until the geometric budget holds everything included
        # preserves the ladder invariant (each bump may pull in more slots
        # <= s, so recompute until it settles)
        forced = self._shadow_slots()
        while True:
            include = sorted({k for k in self._levels if k <= s} | forced)
            rows = self._n_pending + sum(
                self._levels[k].live_rows() for k in include)
            if rows <= self.capacity * self.growth ** s:
                break
            s += 1
        ins = [tuple(np.array(a, copy=True) for a in e)
               for e in self._ins_log]
        hosts = []
        for slot in include:
            h = self._levels[slot]
            cols = tuple(np.array(c, copy=True) for c in h.cols)
            hosts.append((slot, cols, sorted(h.shadowed())))
        self._merging_slots = {slot for slot, _, _ in hosts}
        self._merge_mark_ins = len(self._ins_log)
        self._residual_shadow = []
        return (s, ins, hosts)

    def _merge_rows(self, ins_log, hosts) -> Tuple[np.ndarray, ...]:
        parts: List[List[np.ndarray]] = [[] for _ in range(self._ncols)]
        for _, cols, dead in hosts:
            keep = np.ones(len(cols[0]), bool)
            if dead:
                keep[np.asarray(dead, int)] = False
            for i, c in enumerate(cols):
                parts[i].append(c[keep])
        for e in ins_log:
            alive = ~np.isnan(np.asarray(e[0]))
            for i, c in enumerate(e):
                parts[i].append(np.asarray(c)[alive])
        cols = tuple(np.concatenate(p) if p else np.zeros(0)
                     for p in parts)
        order = np.argsort(cols[0], kind="stable")
        return tuple(c[order] for c in cols)

    def _merge(self, snap, mark) -> None:
        s, ins_log, hosts = snap
        cols = self._merge_rows(ins_log, hosts)
        # the fit runs OFF-lock on the merge thread: work proportional to
        # the compacted rows, never a full-ladder refit
        new_host = self._build_host(s, cols) if len(cols[0]) else None
        if self.device.type == "cuda":
            # let the new level's upload finish before the swap: a query
            # must never read a plan mid-copy
            torch.cuda.synchronize(self.device)
        with self._lock:
            preview_levels = {slot: h.level
                              for slot, h in self._levels.items()
                              if slot not in self._merging_slots}
            listeners = list(self._install_listeners)
        if new_host is not None:
            preview_levels[s] = new_host.level
        if preview_levels and listeners:
            # plan-swap hook: listeners see the incoming ladder here, still
            # on the merge thread, before the install
            self._notify_install_listeners(self._make_plan(tuple(
                preview_levels[k] for k in sorted(preview_levels))))
        with self._lock:
            if new_host is not None:
                for record in self._residual_shadow:
                    self._apply_shadow(new_host, record)
                if self._residual_shadow:
                    new_host.level = self._refresh_level(new_host)
            elif self._residual_shadow:
                raise RuntimeError("internal: residual delete shadows with "
                                   "an empty compaction output")
            levels = {slot: h for slot, h in self._levels.items()
                      if slot not in self._merging_slots}
            if new_host is not None:
                levels[s] = new_host
            if not levels:
                raise ValueError("compaction would empty the dataset")
            residual_ins = self._ins_log[mark[0]:]
            self._levels = levels
            self._ins_log = []
            self._del_log = []
            self._n_pending = 0
            self._merging_slots = set()
            self._merge_mark_ins = 0
            self._residual_shadow = []
            self._queries_since = 0
            self._state = (self._ladder(), self._empty_buf())
            for e in residual_ins:
                alive = ~np.isnan(np.asarray(e[0]))
                if alive.any():
                    self._log_ins(*(np.asarray(c)[alive] for c in e))
            self.refit_count += 1
            self.compaction_count += 1

    # -- queries ----------------------------------------------------------

    def _query(self, ranges, eps_rel):
        self._queries_since += 1
        lsm, buf = self._state   # one atomic snapshot
        return execute_lsm(lsm, buf, ranges, backend=self.backend,
                           eps_rel=eps_rel, min_bucket=self.min_bucket)

    def _to(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=DTYPE, device=self.device)


class LsmEngine(_LsmBase):
    """LSM-tiered 1-D PolyFit (COUNT/SUM/MAX/MIN): a mutable delta buffer
    plus a geometric ladder of immutable fitted plans.  Worst-case update
    cost is bounded by the compacted size (never a full refit); extremal
    deletes shadow their victim and never merge."""

    _ncols = 2

    def __init__(self, keys, measures=None, *, agg: str = "sum",
                 deg: int = 2, delta: float = 100.0,
                 backend: Optional[str] = None, capacity: int = 1024,
                 growth: int = 4, min_bucket: int = 64,
                 auto_refit: bool = True, background: bool = False,
                 policy=None, device=None):
        if agg not in ("sum", "count", "max", "min"):
            raise ValueError(f"unknown 1-D aggregate {agg!r}")
        self.deg = deg
        self.delta = delta
        self._init_lsm(agg=agg, backend=backend, capacity=capacity,
                       growth=growth, min_bucket=min_bucket,
                       auto_refit=auto_refit, background=background,
                       policy=policy, dim=1, device=device)
        keys = np.array(np.atleast_1d(np.asarray(keys, np.float64)))
        meas = self._norm_measures(keys, measures)
        order = np.argsort(keys, kind="stable")
        self._initial_install((keys[order], meas[order]))

    # -- dim hooks --------------------------------------------------------

    def _norm_measures(self, keys, measures) -> np.ndarray:
        if measures is None:
            if self._agg != "count":
                raise ValueError("measures required unless agg='count'")
            return np.ones_like(keys)
        m = np.broadcast_to(np.asarray(measures, np.float64),
                            keys.shape).copy()
        if self._agg == "count":
            m = np.ones_like(keys)
        if self._agg == "min":
            m = -m   # internal MAX space, mirroring the static index
        return m

    def _build_host(self, slot: int, cols) -> _HostLevel:
        keys, meas = cols
        if self._agg == "count":
            raw = None
        elif self._agg == "min":
            raw = -meas   # build negates again into internal space
        else:
            raw = meas
        index = build_index_1d(keys, raw, self._agg, deg=self.deg,
                               delta=self.delta, keep_exact=True,
                               device=self.device)
        h = _HostLevel(slot=slot, cols=(keys, meas), index=index)
        h.level = self._refresh_level(h)
        return h

    def _refresh_level(self, h: _HostLevel) -> LsmLevel:
        plan = h.level.plan if h.level is not None else build_plan(h.index)
        big = big_sentinel(plan.dtype)
        if self._extremal:
            vic_keys = live_st = None
            if h.vic:
                nv = len(h.vic)
                vcap = max(self.capacity, _pow2_at_least(nv))
                vk = np.full(vcap, big)
                vk[:nv] = np.sort(np.float64([r[1] for r in h.vic]))
                vic_keys = self._to(vk)
                meas = np.array(h.cols[1], np.float64, copy=True)
                meas[[r[0] for r in h.vic]] = -np.inf
                live_st = self._to(build_sparse_table(meas))
            return LsmLevel(plan=plan, tomb_keys=None, tomb_cf=None,
                            vic_keys=vic_keys, live_st=live_st, slot=h.slot)
        tomb_keys = tomb_cf = None
        if h.tomb:
            nt = len(h.tomb)
            tcap = _pow2_at_least(nt)
            order = np.argsort(np.float64([r[1] for r in h.tomb]),
                               kind="stable")
            tk = np.full(tcap, big)
            tv = np.zeros(tcap)
            tk[:nt] = np.float64([r[1] for r in h.tomb])[order]
            tv[:nt] = np.float64([r[2] for r in h.tomb])[order]
            tomb_keys = self._to(tk)
            tomb_cf = self._to(np.cumsum(tv))
        return LsmLevel(plan=plan, tomb_keys=tomb_keys, tomb_cf=tomb_cf,
                        vic_keys=None, live_st=None, slot=h.slot)

    def _find_in_level(self, h: _HostLevel, key) -> Optional[int]:
        i0 = np.searchsorted(h.cols[0], key, side="left")
        i1 = np.searchsorted(h.cols[0], key, side="right")
        dead = h.shadowed()
        for pos in range(i0, i1):
            if pos not in dead:
                return pos
        return None

    def _level_record(self, h: _HostLevel, pos: int) -> tuple:
        return (float(h.cols[0][pos]), float(h.cols[1][pos]))

    def _find_in_ins(self, key) -> Optional[Tuple[int, int]]:
        for e, (k, _) in enumerate(self._ins_log):
            j = np.where((k == key) & ~np.isnan(k))[0]
            if len(j):
                return e, int(j[0])
        return None

    def _nan_mark(self, e: int, j: int) -> tuple:
        k, v = self._ins_log[e]
        record = (float(k[j]), float(v[j]))
        k[j] = np.nan
        v[j] = np.nan
        return record

    def _apply_shadow(self, h: _HostLevel, record: tuple) -> None:
        key, val = record
        dead = h.shadowed()
        i0 = np.searchsorted(h.cols[0], key, side="left")
        i1 = np.searchsorted(h.cols[0], key, side="right")
        cand = [p for p in range(i0, i1) if p not in dead]
        if not cand:
            raise KeyError(f"residual delete of key {key!r}: not present "
                           "in the compacted level")
        match = [p for p in cand if float(h.cols[1][p]) == val]
        pos = (match or cand)[0]
        (h.vic if self._extremal else h.tomb).append(
            (pos, key, float(h.cols[1][pos])))

    def _make_plan(self, levels) -> LsmPlan:
        return LsmPlan(levels=levels, agg=self._agg)

    def _empty_buf(self) -> DeltaBuffer:
        # the insert-log sparse table is only read by K6 ('cuda')
        return DeltaBuffer.empty(
            self.capacity, DTYPE, self.device,
            with_st=(self._extremal and self.backend == "cuda"))

    def _buf_append(self, buf: DeltaBuffer, keys, vals) -> DeltaBuffer:
        ik, iv, icf, st = _append_1d(buf.ins_keys, buf.ins_vals,
                                     self._to(keys), self._to(vals),
                                     cap=buf.cap,
                                     with_st=buf.ins_st is not None)
        return dataclasses.replace(buf, ins_keys=ik, ins_vals=iv,
                                   ins_cf=icf, ins_st=st)

    # -- public API -------------------------------------------------------

    def insert(self, keys, measures=None) -> None:
        """Buffer a batch of new (key, measure) records."""
        keys = np.array(np.atleast_1d(np.asarray(keys, np.float64)))
        meas = self._norm_measures(keys, measures)
        self._insert_batch((keys, meas))

    def delete(self, keys) -> None:
        """Delete one live occurrence per key — tombstone/victim shadowing
        only, NEVER a merge (KeyError if a key has no live occurrence)."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        self._delete_batch([float(k) for k in keys])

    def sum(self, lq, uq, eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("sum", "count")
        return self._query((lq, uq), eps_rel)

    count = sum

    def extremum(self, lq, uq,
                 eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("max", "min")
        return self._query((lq, uq), eps_rel)

    def query(self, lq, uq, eps_rel: Optional[float] = None) -> QueryResult:
        return self._query((lq, uq), eps_rel)


class LsmEngine2D(_LsmBase):
    """LSM-tiered 2-D PolyFit (rect COUNT/SUM, dominance MAX/MIN).

    The ``LsmEngine`` lifecycle over (x, y[, w]) point columns.  Dominance
    MAX/MIN inserts below the extremal floor need NO eager refit here
    (unlike ``DynamicEngine2D``): the level cores mask
    empty-dominated-set levels to -inf and the buffered point's exact
    correction answers alone."""

    _ncols = 3

    def __init__(self, px, py, measures=None, *, agg: str = "count2d",
                 deg: int = 3, delta: float = 100.0, grid: int = 8,
                 max_depth: int = 12, backend: Optional[str] = None,
                 capacity: int = 1024, growth: int = 4, min_bucket: int = 64,
                 auto_refit: bool = True, background: bool = False,
                 policy=None, device=None):
        if agg not in ("count2d", "sum2d", "max2d", "min2d"):
            raise ValueError(f"unknown 2-D aggregate {agg!r}")
        self.deg = deg
        self.delta = delta
        self.grid = grid
        self.max_depth = max_depth
        self._init_lsm(agg=agg, backend=backend, capacity=capacity,
                       growth=growth, min_bucket=min_bucket,
                       auto_refit=auto_refit, background=background,
                       policy=policy, dim=2, device=device)
        px = np.array(np.atleast_1d(np.asarray(px, np.float64)))
        py = np.array(np.atleast_1d(np.asarray(py, np.float64)))
        pw = self._norm_measures(px, measures)
        order = np.argsort(px, kind="stable")
        self._initial_install((px[order], py[order], pw[order]))

    @property
    def _weighted(self) -> bool:
        return self._agg != "count2d"

    # -- dim hooks --------------------------------------------------------

    def _norm_measures(self, px, ws) -> np.ndarray:
        if not self._weighted:
            if ws is not None:
                raise ValueError("measures only apply to sum2d/max2d/min2d")
            return np.ones_like(px)
        if ws is None:
            raise ValueError(f"measures required for agg={self._agg!r}")
        w = np.broadcast_to(np.asarray(ws, np.float64), px.shape).copy()
        if self._agg == "min2d":
            w = -w
        return w

    def _build_host(self, slot: int, cols) -> _HostLevel:
        px, py, pw = cols
        if self._agg == "count2d":
            raw = None
        elif self._agg == "min2d":
            raw = -pw   # build negates again into internal space
        else:
            raw = pw
        index = build_index_2d(px, py, raw, self._agg, deg=self.deg,
                               delta=self.delta, grid=self.grid,
                               max_depth=self.max_depth, keep_exact=True,
                               device=self.device)
        h = _HostLevel(slot=slot, cols=(px, py, pw), index=index)
        h.level = self._refresh_level(h)
        return h

    def _refresh_level(self, h: _HostLevel) -> LsmLevel2D:
        plan = (h.level.plan if h.level is not None
                else build_plan_2d(h.index))
        big = big_sentinel(plan.dtype)
        if self._extremal:
            vic_x = vic_y = live_wpmax = None
            if h.vic:
                nv = len(h.vic)
                vcap = max(self.capacity, _pow2_at_least(nv))
                vx = np.full(vcap, big)
                vy = np.full(vcap, big)
                vx[:nv] = np.float64([r[1] for r in h.vic])
                vy[:nv] = np.float64([r[2] for r in h.vic])
                vic_x = self._to(vx)
                vic_y = self._to(vy)
                ws = np.array(h.cols[2], np.float64, copy=True)
                ws[[r[0] for r in h.vic]] = -np.inf
                t = MergeSortTree.build(h.cols[0], h.cols[1], ws=ws,
                                        device=self.device)
                live_wpmax = t.wpmax_levels
            return LsmLevel2D(plan=plan, tomb_xs=None, tomb_ys_levels=None,
                              tomb_wcum=None, vic_x=vic_x, vic_y=vic_y,
                              live_wpmax=live_wpmax, slot=h.slot)
        tomb_xs = tomb_ys_levels = tomb_wcum = None
        if h.tomb:
            nt = len(h.tomb)
            tcap = _pow2_at_least(nt)
            tx = np.full(tcap, big)
            ty = np.full(tcap, big)
            tw = np.zeros(tcap)
            tx[:nt] = np.float64([r[1] for r in h.tomb])
            ty[:nt] = np.float64([r[2] for r in h.tomb])
            tw[:nt] = np.float64([r[3] for r in h.tomb])
            t = MergeSortTree.build(tx, ty, ws=tw, device=self.device)
            tomb_xs, tomb_ys_levels, tomb_wcum = (t.xs, t.ys_levels,
                                                  t.wcum_levels)
        return LsmLevel2D(plan=plan, tomb_xs=tomb_xs,
                          tomb_ys_levels=tomb_ys_levels, tomb_wcum=tomb_wcum,
                          vic_x=None, vic_y=None, live_wpmax=None,
                          slot=h.slot)

    def _find_in_level(self, h: _HostLevel, rec) -> Optional[int]:
        x, y = rec
        i0 = np.searchsorted(h.cols[0], x, side="left")
        i1 = np.searchsorted(h.cols[0], x, side="right")
        dead = h.shadowed()
        for pos in range(i0, i1):
            if pos not in dead and h.cols[1][pos] == y:
                return pos
        return None

    def _level_record(self, h: _HostLevel, pos: int) -> tuple:
        return (float(h.cols[0][pos]), float(h.cols[1][pos]),
                float(h.cols[2][pos]))

    def _find_in_ins(self, rec) -> Optional[Tuple[int, int]]:
        x, y = rec
        for e, (lx, ly, _) in enumerate(self._ins_log):
            j = np.where((lx == x) & (ly == y) & ~np.isnan(lx))[0]
            if len(j):
                return e, int(j[0])
        return None

    def _nan_mark(self, e: int, j: int) -> tuple:
        lx, ly, lw = self._ins_log[e]
        record = (float(lx[j]), float(ly[j]), float(lw[j]))
        lx[j] = np.nan
        ly[j] = np.nan
        lw[j] = np.nan
        return record

    def _apply_shadow(self, h: _HostLevel, record: tuple) -> None:
        x, y, w = record
        dead = h.shadowed()
        i0 = np.searchsorted(h.cols[0], x, side="left")
        i1 = np.searchsorted(h.cols[0], x, side="right")
        cand = [p for p in range(i0, i1)
                if p not in dead and h.cols[1][p] == y]
        if not cand:
            raise KeyError(f"residual delete of point ({x!r}, {y!r}): not "
                           "present in the compacted level")
        match = [p for p in cand if float(h.cols[2][p]) == w]
        pos = (match or cand)[0]
        (h.vic if self._extremal else h.tomb).append(
            (pos, x, float(h.cols[1][pos]), float(h.cols[2][pos])))

    def _make_plan(self, levels) -> LsmPlan2D:
        return LsmPlan2D(levels=levels, agg=self._agg)

    def _empty_buf(self) -> DeltaBuffer2D:
        return DeltaBuffer2D.empty(self.capacity, DTYPE, self.device,
                                   weighted=self._weighted)

    def _buf_append(self, buf: DeltaBuffer2D, xs, ys, ws) -> DeltaBuffer2D:
        # the merge-sort-tree levels are only read by K9-K11 ('cuda')
        lv = self.backend == "cuda"
        x, y, w, ylv, wcum, wpmax = _append_2d(
            buf.ins_x, buf.ins_y, buf.ins_w, self._to(xs), self._to(ys),
            self._to(ws) if self._weighted else None, cap=buf.cap,
            levels=lv, weighted=self._weighted)
        return dataclasses.replace(
            buf, ins_x=x, ins_y=y,
            ins_w=w if self._weighted else None,
            ins_ylv=ylv if lv else buf.ins_ylv,
            ins_wcum=wcum if (lv and self._weighted) else buf.ins_wcum,
            ins_wpmax=(wpmax if (lv and self._weighted)
                       else buf.ins_wpmax))

    # -- public API -------------------------------------------------------

    def insert(self, xs, ys, ws=None) -> None:
        """Buffer new points (``ws`` = measures for sum2d/max2d/min2d)."""
        xs = np.array(np.atleast_1d(np.asarray(xs, np.float64)))
        ys = np.array(np.atleast_1d(np.asarray(ys, np.float64)))
        ws = self._norm_measures(xs, ws)
        self._insert_batch((xs, ys, ws))

    def delete(self, xs, ys) -> None:
        """Delete one live occurrence per point — shadowing only, NEVER a
        merge (KeyError if a point has no live occurrence)."""
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        ys = np.atleast_1d(np.asarray(ys, np.float64))
        self._delete_batch([(float(x), float(y)) for x, y in zip(xs, ys)])

    def count2d(self, lx, ux, ly, uy,
                eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("count2d")
        return self._query((lx, ux, ly, uy), eps_rel)

    def sum2d(self, lx, ux, ly, uy,
              eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("sum2d")
        return self._query((lx, ux, ly, uy), eps_rel)

    def extremum2d(self, u, v,
                   eps_rel: Optional[float] = None) -> QueryResult:
        self._require_agg("max2d", "min2d")
        return self._query((u, v), eps_rel)

    def query(self, *ranges, eps_rel: Optional[float] = None) -> QueryResult:
        return self._query(ranges, eps_rel)
