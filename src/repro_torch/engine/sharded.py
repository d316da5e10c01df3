"""Sharded plans: segment tables partitioned into contiguous key ranges.

The twin of ``repro.engine.sharded``.  ``shard_plan`` splits an
``IndexPlan``'s segment table (and its exact refinement arrays) into S
contiguous key ranges — shard ``s`` owns segments ``[off_s, off_{s+1})``
and therefore every key in ``[seg_lo[off_s], seg_lo[off_{s+1}])`` — and
stacks the per-shard slices on a leading axis; each shard then computes
only the part of an answer its key range owns:

* **SUM/COUNT** — the raw answer is ``F(uq) - F(lq)`` (Eq. 14); each
  endpoint is evaluated by exactly one owner shard (the other shards'
  values are masked to 0), the owner-masked values are summed across the
  shards (one nonzero term each), and the final subtraction runs on the
  combined totals — the operation sequence of the unsharded executor, so
  answers are **bit-identical**, not merely close.  Clamping each query to
  a shard's range and summing partial sums would not be: segment fits are
  discontinuous at boundaries, so telescoping F over shard edges adds up
  to ``2*delta*(S-1)`` of spurious error.
* **MAX/MIN** — Eq. 17 decomposes exactly: the boundary segments' closed-
  form extrema are computed by the shards owning ``lq``/``uq`` (the
  arithmetic of ``core.queries.max_eval_segments``), interior segments
  reduce through per-shard sparse tables, and a max across the shards
  combines them; floating-point ``max`` is exact, so this too is
  bit-identical.
* **Exact refinement / delta buffers** — the refinement CF arrays and the
  ``DeltaBuffer`` logs are partitioned by the same key ranges.  Prefix-CF
  lookups read *global* prefix values stored at local positions (the
  owner-masked sum again), masked buffer maxima combine by max, so Q_rel
  refinement and post-insert/delete dynamic answers stay bit-identical.
  Victims of extremal deletes (``DeltaBuffer.vic_keys``/``live_st``) are
  partitioned the same way: the victim-masked measures split by the
  refinement keys' ranges, the victim keys replicated; the reference's
  sharded executor leaves them out, the port's unsharded one reads them,
  so the twin reads them too.

2-D plans (``shard_plan_2d``) partition the Morton-ordered leaf table into
contiguous z-ranges; only the leaf-table evaluation is sharded (the owner
shard gathers a corner's leaf row, the rows combine by the owner-masked
sum, and the bivariate Horner runs on the combined row), while the cut
grids, the merge-sort-tree refinement arrays and the delta buffer are read
whole.  LSM ladders (``shard_lsm_plan``/``shard_lsm_plan_2d``) shard
every level's fitted plan and fuse across levels through
``engine.lsm.combine_levels`` (Q_abs only).

All S shards live on one device, on the leading axis of each stacked
tensor, as in the reference's ``ShardedPlan``; the reference's
``shard_map`` body becomes a Python loop that runs one shard at a time
over the same helpers the unsharded ``'torch'`` backend calls (the twin of
``'xla'``), and the collectives become ``torch.stack(...).sum(0)`` of the
owner-masked values and ``torch.stack(...).amax(0)``.  That arithmetic is
the reference's semantics, not a fallback: its shard body runs the XLA
primitives whatever the engine backend, so this module launches none of
the CUDA kernels, and its answers equal the unsharded ``'torch'`` answers
exactly.  Placing the shards on several cards is a later item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import DTYPE
from ..core.exact import build_sparse_table, sparse_table_range_max
from ..core.index2d import bivariate_horner, mst_weighted_prefix
from ..core.poly import eval_segments, locate, scale_unit
from ..core.queries import QueryResult, poly_max_on_interval
from ..kernels import ref as _ref
from ..kernels.locate import INT_SENTINEL, bsearch_count, interleave2
from .dynamic import (DeltaBuffer, DeltaBuffer2D, _exec_dyn_dommax2d,
                      _exec_dyn_quantile, _exec_dyn_rect2d)
from .engine import (QuantileResult, _bucket_size, _exec_extremum2d,
                     _exec_rect2d, _no_refine, _pad_bucket, _x_ranks,
                     check_pow2, execute_quantile, key_span, pad_fills,
                     prepare_fractions, truth_count2d, truth_dommax2d,
                     truth_sum2d)
from .lsm import (_threat_1d, _tomb_rect_2d, _tomb_sum_1d, combine_levels,
                  composed_bound)
from .plan import IndexPlan, IndexPlan2D, big_sentinel

__all__ = ["ShardedPlan", "ShardedDelta", "ShardedEngine", "shard_plan",
           "shard_buffer", "ShardedPlan2D", "ShardedEngine2D",
           "shard_plan_2d", "ShardedLsmPlan", "ShardedLsmPlan2D",
           "shard_lsm_plan", "shard_lsm_plan_2d", "execute_lsm_sharded"]


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """Per-shard slices of an ``IndexPlan``, stacked on a leading S axis.

    ``bounds`` (host metadata) are the S+1 owning-range edges
    ``(-inf, seg_lo[off_1], ..., +inf)``; ``rlo``/``rhi`` carry the same
    values as per-shard tensors for the ownership masks.  ``ref_cf`` holds
    *global* inclusive-prefix values at local positions (entry ``i`` of
    shard ``s`` is ``CF[a_s + i]`` of the unsharded array), so an owner
    shard's lookup returns exactly the unsharded value.  ``ref_edges``
    (the port's own) are the S+1 offsets at which the refinement keys
    split, which ``shard_buffer`` splits a victim-masked table at.
    """

    # -- host metadata ---------------------------------------------------
    agg: str
    deg: int
    delta: float
    h: int                    # true global segment count
    n: int
    nshards: int
    domain_lo: float
    bounds: Tuple[float, ...]  # S+1 owning-range edges
    # -- per-shard range/offset tensors (S,) -----------------------------
    rlo: torch.Tensor
    rhi: torch.Tensor
    off: torch.Tensor         # int32 global index of the first owned segment
    hloc: torch.Tensor        # int32 owned segment count
    # -- stacked segment tables (S, Hs[, deg+1]) -------------------------
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    coeffs: torch.Tensor
    seg_agg: Optional[torch.Tensor]   # max/min only
    st: Optional[torch.Tensor]        # (S, L, Hs) local sparse tables
    # -- sharded exact-refinement arrays ---------------------------------
    ref_keys: Optional[torch.Tensor]  # (S, R) sentinel-padded key slices
    ref_cf: Optional[torch.Tensor]    # (S, R+1) global-prefix CF slices
    ref_st: Optional[torch.Tensor]    # (S, L2, R) local measure tables
    ref_edges: Optional[Tuple[int, ...]] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device


@dataclasses.dataclass(frozen=True)
class ShardedDelta:
    """Per-shard slices of a ``DeltaBuffer``, partitioned by the plan's
    owning key ranges.  ``ins_cf``/``del_cf`` hold *global* exclusive
    prefix sums at local positions (the trick of ``ShardedPlan.ref_cf``).
    ``vic_keys`` (replicated) and ``live_st`` (the victim-masked measures
    split at the plan's ``ref_edges``, one sparse table a shard) mirror the
    buffer's victim shadows; None while it has none."""

    ins_keys: torch.Tensor   # (S, C) sentinel-padded
    ins_vals: torch.Tensor   # (S, C)
    ins_cf: torch.Tensor     # (S, C+1)
    del_keys: torch.Tensor
    del_vals: torch.Tensor
    del_cf: torch.Tensor
    cap: int
    vic_keys: Optional[torch.Tensor] = None   # (vcap,)
    live_st: Optional[torch.Tensor] = None    # (S, L2, R)

    @property
    def dtype(self) -> torch.dtype:
        return self.ins_vals.dtype


# ---------------------------------------------------------------------------
# host-side partitioning
# ---------------------------------------------------------------------------

def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def _pad2(rows, length, fill, device):
    """Stack host rows padded to ``length`` along their first axis, on
    ``device``."""
    out = np.full((len(rows), length) + rows[0].shape[1:], fill,
                  rows[0].dtype)   # empty slices still carry the dtype
    for s, r in enumerate(rows):
        out[s, : len(r)] = r
    return torch.as_tensor(out, device=device)


def _split_tables(meas, edges, r, device):
    """(S, L, r) stack of the sparse tables over ``meas[a:b]`` for each
    pair of consecutive ``edges``, each slice padded to ``r`` with -inf."""
    return torch.as_tensor(np.stack([
        build_sparse_table(np.concatenate(
            [meas[a:b], np.full(r - (b - a), -np.inf)]))
        for a, b in zip(edges[:-1], edges[1:])]), device=device)


def shard_plan(plan: IndexPlan, nshards: int, device=None) -> ShardedPlan:
    """Partition a 1-D plan's segment table into ``nshards`` contiguous
    key ranges (balanced by segment count), shard-local sparse tables and
    refinement slices included, on ``device`` (the plan's by default).
    Plans with fewer segments than shards leave the surplus shards empty
    (they own the degenerate range [+inf, +inf) and contribute the sum/max
    identity).  An ``LsmPlan`` ladder routes to ``shard_lsm_plan`` (every
    level sharded independently)."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    if hasattr(plan, "levels"):
        return shard_lsm_plan(plan, nshards, device)
    device = plan.device if device is None else torch.device(device)
    h = plan.h
    dt = plan.dtype
    big = big_sentinel(dt)
    seg_lo = _host(plan.seg_lo)[:h]
    seg_hi = _host(plan.seg_hi)[:h]
    coeffs = _host(plan.coeffs)[:h]
    seg_agg = _host(plan.seg_agg)[:h]
    cuts = np.round(np.linspace(0, h, nshards + 1)).astype(np.int64)
    inner = np.where(cuts[1:-1] < h,
                     seg_lo[np.minimum(cuts[1:-1], h - 1)], np.inf)
    bounds = np.concatenate([[-np.inf], inner, [np.inf]])

    spans = list(zip(cuts[:-1], cuts[1:]))
    hs = max(int(b - a) for a, b in spans)
    extremal = plan.agg in ("max", "min")
    st = None
    if extremal:
        st = _split_tables(seg_agg, cuts, hs, device)

    ref_keys = ref_cf = ref_st = edges = None
    if plan.ref_keys is not None:
        keys = _host(plan.ref_keys)
        splits = np.searchsorted(keys, bounds[1:-1], side="left")
        edges = np.concatenate([[0], splits, [len(keys)]]).astype(np.int64)
        k_rows = [keys[a:b] for a, b in zip(edges[:-1], edges[1:])]
        r = max(len(kr) for kr in k_rows)
        ref_keys = _pad2(k_rows, r, big, device)
        if plan.ref_cf is not None:
            pcf = np.concatenate([[0.0], _host(plan.ref_cf)])
            # local slice of the *global* padded prefix CF; the tail repeats
            # the last value (owner lookups never index past their length)
            rows = []
            for a, b in zip(edges[:-1], edges[1:]):
                sl = pcf[a: b + 1]
                rows.append(np.concatenate(
                    [sl, np.full(r + 1 - len(sl), sl[-1])]))
            ref_cf = torch.as_tensor(np.stack(rows), device=device)
        if plan.ref_st is not None:
            meas = _host(plan.ref_st[0])   # level 0 = raw measures
            ref_st = _split_tables(meas, edges, r, device)

    return ShardedPlan(
        agg=plan.agg, deg=plan.deg, delta=plan.delta, h=h, n=plan.n,
        nshards=nshards, domain_lo=float(seg_lo[0]),
        bounds=tuple(float(b) for b in bounds),
        rlo=torch.as_tensor(bounds[:-1], dtype=dt, device=device),
        rhi=torch.as_tensor(bounds[1:], dtype=dt, device=device),
        off=torch.as_tensor(cuts[:-1], dtype=torch.int32, device=device),
        hloc=torch.as_tensor(np.diff(cuts), dtype=torch.int32,
                             device=device),
        seg_lo=_pad2([seg_lo[a:b] for a, b in spans], hs, big, device),
        seg_hi=_pad2([seg_hi[a:b] for a, b in spans], hs, big, device),
        coeffs=_pad2([coeffs[a:b] for a, b in spans], hs, 0.0, device),
        seg_agg=(_pad2([seg_agg[a:b] for a, b in spans], hs, -np.inf,
                       device) if extremal else None),
        st=st, ref_keys=ref_keys, ref_cf=ref_cf, ref_st=ref_st,
        ref_edges=None if edges is None else tuple(int(e) for e in edges),
    )


def shard_buffer(buf: DeltaBuffer, splan: ShardedPlan) -> ShardedDelta:
    """Partition a delta buffer by the plan's owning key ranges.

    Sentinel slots sort past every real key and land on the last shard with
    value 0 (they fail every membership/ownership test).  The CF slices keep
    global prefix values so owner lookups reproduce the unsharded arithmetic
    bit for bit.  A buffer's victim-masked table splits at the plan's
    refinement-key edges.
    """
    cap = buf.cap
    inner = np.asarray(splan.bounds[1:-1])
    big = big_sentinel(splan.dtype)
    device = splan.device

    def split(keys, vals, cf):
        k, v, c = _host(keys), _host(vals), _host(cf)
        edges = np.concatenate(
            [[0], np.searchsorted(k, inner, side="left"), [cap]]
        ).astype(np.int64)
        krs, vrs, crs = [], [], []
        for a, b in zip(edges[:-1], edges[1:]):
            krs.append(k[a:b])
            vrs.append(v[a:b])
            sl = c[a: b + 1]
            crs.append(np.concatenate(
                [sl, np.full(cap + 1 - len(sl), sl[-1])]))
        return (_pad2(krs, cap, big, device), _pad2(vrs, cap, 0.0, device),
                torch.as_tensor(np.stack(crs), device=device))

    ik, iv, icf = split(buf.ins_keys, buf.ins_vals, buf.ins_cf)
    dk, dv, dcf = split(buf.del_keys, buf.del_vals, buf.del_cf)
    vic = live = None
    if buf.vic_keys is not None:
        vic = buf.vic_keys.to(device)
        edges = splan.ref_edges
        live = _split_tables(_host(buf.live_st[0]), edges,
                             splan.ref_keys.shape[1], device)
    return ShardedDelta(ik, iv, icf, dk, dv, dcf, cap, vic, live)


# ---------------------------------------------------------------------------
# per-shard helpers: each runs the unsharded arithmetic on one shard's row
# of the stacked tensors; the owner-masked sum and the max across shards
# stand in for the reference's psum and pmax
# ---------------------------------------------------------------------------

def _own(q, rlo, rhi):
    return (q >= rlo) & (q < rhi)


def _sum_owned(vals, owns, zero=0.0):
    """The reference's ``psum`` of owner-masked values: one nonzero term a
    lane, so the sum reproduces the owner's value exactly."""
    return torch.stack([torch.where(o, v, zero)
                        for v, o in zip(vals, owns)]).sum(0)


def _max_shards(parts):
    """The reference's ``pmax``: a max across the shards (exact)."""
    return torch.stack(parts).amax(0)


def _owners(sp, q):
    return [_own(q, sp.rlo[s], sp.rhi[s]) for s in range(sp.nshards)]


def _sum_endpoints(sp: ShardedPlan, lqc, uqc):
    """(F(lq), F(uq)) totals — each endpoint evaluated by its owner only."""
    S = range(sp.nshards)
    ev = lambda q, s: eval_segments(q, sp.seg_lo[s], sp.seg_hi[s],
                                    sp.coeffs[s])
    fl = _sum_owned([ev(lqc, s) for s in S], _owners(sp, lqc))
    fu = _sum_owned([ev(uqc, s) for s in S], _owners(sp, uqc))
    return fl, fu


def _extremum_raw(sp: ShardedPlan, lqc, uqc):
    """Eq. 17 decomposed: owner-computed boundary extrema plus per-shard
    interior sparse-table maxima, combined by a max across the shards."""
    S = range(sp.nshards)
    own_l, own_u = _owners(sp, lqc), _owners(sp, uqc)
    il_loc = [locate(lqc, sp.seg_lo[s]) for s in S]
    iu_loc = [locate(uqc, sp.seg_lo[s]) for s in S]
    off = sp.off.long()
    il = _sum_owned([off[s] + il_loc[s] for s in S], own_l, 0)
    iu = _sum_owned([off[s] + iu_loc[s] for s in S], own_u, 0)
    same = il == iu
    parts = []
    for s in S:
        seg_lo, seg_hi, coeffs = sp.seg_lo[s], sp.seg_hi[s], sp.coeffs[s]
        # left boundary segment: [lq, min(hi_l, uq)] — owner shard only
        i = il_loc[s]
        lo_l, hi_l = seg_lo[i], seg_hi[i]
        ua_l = scale_unit(lqc, lo_l, hi_l)
        ub_l = scale_unit(torch.minimum(hi_l, uqc), lo_l, hi_l)
        m_left = poly_max_on_interval(coeffs[i], ua_l, ub_l)
        m_left = torch.where(lqc <= hi_l, m_left, -torch.inf)
        m_left = torch.where(own_l[s], m_left, -torch.inf)
        # right boundary segment: [max(lo_u, lq), uq] — owner shard only
        j = iu_loc[s]
        lo_u, hi_u = seg_lo[j], seg_hi[j]
        ua_u = scale_unit(torch.maximum(lo_u, lqc), lo_u, hi_u)
        ub_u = scale_unit(uqc, lo_u, hi_u)
        m_right = torch.where(same | ~own_u[s], -torch.inf,
                              poly_max_on_interval(coeffs[j], ua_u, ub_u))
        # interior fully-covered segments owned by this shard
        hloc = sp.hloc[s].long()
        a = torch.minimum(torch.clamp(il + 1 - off[s], min=0), hloc)
        b = torch.minimum(torch.clamp(iu - off[s], min=0), hloc)
        m_mid = sparse_table_range_max(sp.st[s], a, b)
        parts.append(torch.maximum(torch.maximum(m_left, m_right), m_mid))
    return _max_shards(parts)


def _delta_sum_tot(keys, pcf, lq, uq, rlo, rhi):
    """Exact SUM over (lq, uq] from sharded sorted keys and their
    global-prefix slices (a buffer log's, or the plan's refinement CF):
    each endpoint's prefix read by its owner shard."""
    S = range(keys.shape[0])
    at = lambda q: _sum_owned(
        [pcf[s][torch.searchsorted(keys[s], q, right=True)] for s in S],
        [_own(q, rlo[s], rhi[s]) for s in S])
    return at(uq) - at(lq)


def _slice_max_tot(keys, st, lq, uq):
    """Exact MAX over [lq, uq] from sharded sorted keys and one sparse
    table a shard: per-shard slice maxima, max across shards."""
    return _max_shards([
        sparse_table_range_max(
            st[s], torch.searchsorted(keys[s], lq, right=False),
            torch.searchsorted(keys[s], uq, right=True))
        for s in range(keys.shape[0])])


def _truth_sum_tot(sp: ShardedPlan, lq, uq):
    """Exact static SUM over (lq, uq] from the sharded refinement CF."""
    return _delta_sum_tot(sp.ref_keys, sp.ref_cf, lq, uq, sp.rlo, sp.rhi)


def _truth_extremum_tot(sp: ShardedPlan, lq, uq):
    """Exact static MAX over [lq, uq] — per-shard slice maxima."""
    return _slice_max_tot(sp.ref_keys, sp.ref_st, lq, uq)


def _delta_max_tot(keys, vals, lq, uq):
    """Exact buffered MAX over [lq, uq] — the dense masked max of
    ``kernels/ref.py`` on each shard's slice (chunked over queries, so no
    (S, Q, cap) tensor is formed), max across shards."""
    return _max_shards([_ref.delta_max_ref(lq, uq, keys[s], vals[s])
                        for s in range(keys.shape[0])])


# ---------------------------------------------------------------------------
# sharded executors (the unsharded executors' operation order, shard by
# shard); each returns (answer, approx, refined)
# ---------------------------------------------------------------------------

def _clamp_lo(sp: ShardedPlan, q):
    return torch.maximum(q, q.new_tensor(sp.domain_lo))


def _sum_accept(approx, delta, eps_rel):
    """Lemma 5.2 test: 2d / (A - 2d) <= eps_rel (requires A > 2d)."""
    two_d = 2.0 * delta
    return ((approx - two_d > 0) &
            (two_d / torch.clamp(approx - two_d, min=1e-300) <= eps_rel))


def _exec_shard_sum(sp: ShardedPlan, lq, uq, *, eps_rel: Optional[float]):
    fl, fu = _sum_endpoints(sp, _clamp_lo(sp, lq), _clamp_lo(sp, uq))
    approx = fu - fl
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    ok = _sum_accept(approx, sp.delta, eps_rel)
    truth = _truth_sum_tot(sp, lq, uq)
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_shard_extremum(sp: ShardedPlan, lq, uq, *,
                         eps_rel: Optional[float]):
    approx = _extremum_raw(sp, _clamp_lo(sp, lq), _clamp_lo(sp, uq))
    neg = sp.agg == "min"
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    ok = approx >= sp.delta * (1.0 + 1.0 / eps_rel)
    truth = _truth_extremum_tot(sp, lq, uq)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def _exec_shard_dyn_sum(sp: ShardedPlan, sb: ShardedDelta, lq, uq, *,
                        eps_rel: Optional[float]):
    fl, fu = _sum_endpoints(sp, _clamp_lo(sp, lq), _clamp_lo(sp, uq))
    static = fu - fl
    # exact correction over (lq, uq] — unclamped, as in _exec_dyn_sum
    corr = (_delta_sum_tot(sb.ins_keys, sb.ins_cf, lq, uq, sp.rlo, sp.rhi)
            - _delta_sum_tot(sb.del_keys, sb.del_cf, lq, uq, sp.rlo,
                             sp.rhi))
    approx = static + corr
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    ok = _sum_accept(approx, sp.delta, eps_rel)
    truth = _truth_sum_tot(sp, lq, uq) + corr
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_shard_dyn_extremum(sp: ShardedPlan, sb: ShardedDelta, lq, uq, *,
                             eps_rel: Optional[float]):
    """MAX space throughout; the delete log is never read (extremal deletes
    shadow a victim, as in ``_exec_dyn_extremum``)."""
    static = _extremum_raw(sp, _clamp_lo(sp, lq), _clamp_lo(sp, uq))
    ins = _delta_max_tot(sb.ins_keys, sb.ins_vals, lq, uq)
    approx = torch.maximum(static, ins)
    neg = sp.agg == "min"
    if sb.vic_keys is not None:
        # a range covering a deleted base row refines against the
        # victim-masked exact table
        exact = torch.maximum(_slice_max_tot(sp.ref_keys, sb.live_st, lq,
                                             uq), ins)
        threat = _threat_1d(sb.vic_keys, lq, uq)
        if eps_rel is None:
            ans = torch.where(threat, exact, approx)
            if neg:
                ans = -ans
            return ans, ans, threat
        ok = (~threat) & (approx >= sp.delta * (1.0 + 1.0 / eps_rel))
        ans = torch.where(ok, approx, exact)
        if neg:
            ans, approx = -ans, -approx
        return ans, approx, ~ok
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    ok = approx >= sp.delta * (1.0 + 1.0 / eps_rel)
    truth = torch.maximum(_truth_extremum_tot(sp, lq, uq), ins)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def _prepare(qs, fills, device, min_bucket: int):
    """Float64 query tensors on ``device``, padded to the power-of-two
    bucket with ``fills``; returns (padded, count)."""
    qs = [torch.as_tensor(q, dtype=DTYPE, device=device).reshape(-1)
          for q in qs]
    n = qs[0].shape[0]
    size = _bucket_size(n, min_bucket)
    return [_pad_bucket(q, size, torch.as_tensor(f, dtype=DTYPE,
                                                 device=device).reshape(1))
            for q, f in zip(qs, fills)], n


def _cut(out, n: int) -> QueryResult:
    return QueryResult(out[0][:n], out[1][:n], out[2][:n])


def _require_exact(cond: bool) -> None:
    if not cond:
        raise ValueError("Q_rel refinement requires a plan built with "
                         "with_exact=True")


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

class ShardedEngine:
    """Executes queries against key-range-partitioned 1-D plans.

    ``shard(plan)`` partitions (and caches) a plan; ``sum``/``extremum``
    accept either an ``IndexPlan`` (sharded on first use) or a prepared
    ``ShardedPlan``.  Passing ``buf=`` a ``DeltaBuffer`` (e.g. a
    ``DynamicEngine``'s live buffer) folds buffered updates in exactly,
    keeping dynamic answers bit-identical to the unsharded ``'torch'``
    path.  ``device`` places the partitions (each plan's own by default).
    """

    def __init__(self, nshards: int, *, device=None, min_bucket: int = 64):
        check_pow2("nshards", nshards)
        check_pow2("min_bucket", min_bucket)
        self.nshards = nshards
        self.device = None if device is None else torch.device(device)
        self.min_bucket = min_bucket
        self._plan_cache: dict = {}
        self._buf_cache: dict = {}

    # -- partition caches ------------------------------------------------

    def shard(self, plan) -> ShardedPlan:
        if isinstance(plan, ShardedPlan):
            return plan
        if hasattr(plan, "levels") or isinstance(plan, ShardedLsmPlan):
            return _lsm_cache_shard(self, plan, shard_lsm_plan)
        hit = self._plan_cache.get(id(plan))
        if hit is None or hit[0] is not plan:
            self._plan_cache = {id(plan): (plan, shard_plan(
                plan, self.nshards, self.device))}
            hit = self._plan_cache[id(plan)]
        return hit[1]

    def _shard_buf(self, splan: ShardedPlan,
                   buf: DeltaBuffer) -> ShardedDelta:
        # a partition is only valid for the owning ranges it was split
        # with, so the (single-entry) cache keys on buffer identity AND
        # the plan's bounds
        hit = self._buf_cache.get(id(buf))
        if hit is None or hit[0] is not buf or hit[1] != splan.bounds:
            self._buf_cache = {
                id(buf): (buf, splan.bounds, shard_buffer(buf, splan))}
            hit = self._buf_cache[id(buf)]
        return hit[2]

    # -- queries ---------------------------------------------------------

    def _run(self, plan, lq, uq, eps_rel, buf, exec_static, exec_dyn,
             need_ref):
        splan = self.shard(plan)
        if eps_rel is not None:
            _require_exact(getattr(splan, need_ref) is not None)
        args, n = _prepare((lq, uq), (splan.domain_lo,) * 2, splan.device,
                           self.min_bucket)
        if buf is None:
            out = exec_static(splan, *args, eps_rel=eps_rel)
        else:
            out = exec_dyn(splan, self._shard_buf(splan, buf), *args,
                           eps_rel=eps_rel)
        return _cut(out, n)

    def sum(self, plan, lq, uq, eps_rel: Optional[float] = None,
            buf: Optional[DeltaBuffer] = None) -> QueryResult:
        assert plan.agg in ("sum", "count"), plan.agg
        return self._run(plan, lq, uq, eps_rel, buf, _exec_shard_sum,
                         _exec_shard_dyn_sum, "ref_cf")

    count = sum

    def extremum(self, plan, lq, uq, eps_rel: Optional[float] = None,
                 buf: Optional[DeltaBuffer] = None) -> QueryResult:
        assert plan.agg in ("max", "min"), plan.agg
        return self._run(plan, lq, uq, eps_rel, buf, _exec_shard_extremum,
                         _exec_shard_dyn_extremum, "ref_st")

    def quantile(self, plan, qs, buf: Optional[DeltaBuffer] = None):
        """Certified quantiles over an *unsharded* ``IndexPlan``.

        CF inversion is O(Q log H) scalar work — a handful of binary
        searches and closed-form root extractions per query, with no
        per-segment reduction to distribute — so partitioning the segment
        table buys nothing.  The method exists so sharded sessions keep one
        entry point: it routes to the unsharded executors on ``'torch'``
        and rejects plans that have already been partitioned.
        """
        if isinstance(plan, (ShardedPlan, ShardedLsmPlan)) \
                or hasattr(plan, "levels"):
            raise ValueError(
                "quantile inversion runs on the unsharded IndexPlan — "
                "pass the original plan, not a ShardedPlan/LsmPlan "
                "(inversion is O(Q log H) scalar work; there is no "
                "per-segment reduction to shard)")
        if buf is None:
            return execute_quantile(plan, qs, backend="torch",
                                    min_bucket=self.min_bucket)
        if plan.deg < 1:
            raise ValueError("quantile inversion needs a plan with deg >= 1")
        q, n = prepare_fractions(qs, plan, self.min_bucket)
        ans, lo, hi = _exec_dyn_quantile(plan, buf, q)
        return QuantileResult(ans[:n], lo[:n], hi[:n])

    def query(self, plan, lq, uq, eps_rel: Optional[float] = None,
              buf: Optional[DeltaBuffer] = None) -> QueryResult:
        if hasattr(plan, "levels") or isinstance(plan, ShardedLsmPlan):
            return self.query_lsm(plan, lq, uq, eps_rel=eps_rel, buf=buf)
        if plan.agg in ("sum", "count"):
            return self.sum(plan, lq, uq, eps_rel, buf)
        return self.extremum(plan, lq, uq, eps_rel, buf)

    def query_lsm(self, lsm, lq, uq, eps_rel: Optional[float] = None,
                  buf: Optional[DeltaBuffer] = None) -> QueryResult:
        slsm = _lsm_cache_shard(self, lsm, shard_lsm_plan)
        return execute_lsm_sharded(slsm, buf, (lq, uq), eps_rel=eps_rel,
                                   min_bucket=self.min_bucket)


# ---------------------------------------------------------------------------
# 2-D: the Morton-ordered leaf table partitioned by contiguous z-ranges
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlan2D:
    """Per-shard z-range slices of an ``IndexPlan2D``'s Morton leaf table.

    Shard ``s`` owns the leaves whose z-interval starts fall in
    ``[zbounds[s], zbounds[s+1])`` — quadtree leaves are disjoint intervals
    in Z-order, so a (clamped) query corner's Morton code names exactly one
    owner shard.  The dyadic cut grids are read whole (they are O(2^depth)
    scalars and every shard needs them to code corners), as are the
    exact-refinement merge-sort-tree arrays and, in the dynamic executors,
    the (capacity-bounded) delta buffer: the refinement and buffer
    arithmetic is the unsharded executors', and only the leaf-table
    evaluation is sharded.  Sharding the refinement arrays stays open (the
    BIT block structure does not split at arbitrary x cuts).
    """

    # -- host metadata ---------------------------------------------------
    agg: str
    deg: int
    delta: float
    n: int
    n_leaves: int
    nshards: int
    max_depth: int
    root: Tuple[float, float, float, float]
    zbounds: Tuple[int, ...]     # S+1 owning z-range edges
    # -- per-shard ownership + stacked leaf tables (S, ...) ---------------
    zlo: torch.Tensor            # (S,) int32
    zhi: torch.Tensor            # (S,) int32
    leaf_z: torch.Tensor         # (S, Ls) int32 sentinel-padded
    leaf_bounds: torch.Tensor    # (S, Ls, 4)
    leaf_coeffs: torch.Tensor    # (S, Ls, (deg+1)^2)
    # -- arrays every shard reads whole --------------------------------------
    xcuts: torch.Tensor          # (2^depth - 1,)
    ycuts: torch.Tensor
    ref_xs: Optional[torch.Tensor]
    ref_ys_levels: Optional[torch.Tensor]
    ref_wcum: Optional[torch.Tensor]
    ref_wpmax: Optional[torch.Tensor]
    ref_xs_tree: Optional[torch.Tensor] = None   # the port's own (K1's)

    @property
    def dtype(self) -> torch.dtype:
        return self.leaf_coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.leaf_coeffs.device


def shard_plan_2d(plan: IndexPlan2D, nshards: int,
                  device=None) -> ShardedPlan2D:
    """Partition a 2-D plan's Morton-ordered leaf table into ``nshards``
    contiguous z-ranges (balanced by leaf count), on ``device`` (the
    plan's by default).  Plans with fewer leaves than shards leave the
    surplus shards empty (they own the degenerate range [sentinel,
    sentinel) and contribute the sum/max identity).  An ``LsmPlan2D``
    ladder routes to ``shard_lsm_plan_2d``."""
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    if hasattr(plan, "levels"):
        return shard_lsm_plan_2d(plan, nshards, device)
    if plan.leaf_z is None:
        raise ValueError(
            "2-D sharding requires the Morton leaf layout (max_depth <= "
            "MAX_MORTON_DEPTH and strictly increasing cut grids)")
    device = plan.device if device is None else torch.device(device)
    nl = plan.n_leaves
    leaf_z = _host(plan.leaf_z)[:nl]
    bounds = _host(plan.leaf_bounds)[:nl]
    coeffs = _host(plan.leaf_coeffs)[:nl]
    cuts = np.round(np.linspace(0, nl, nshards + 1)).astype(np.int64)
    inner = np.where(cuts[1:-1] < nl,
                     leaf_z[np.minimum(cuts[1:-1], nl - 1)], INT_SENTINEL)
    zb = np.concatenate([[0], inner, [INT_SENTINEL]]).astype(np.int64)
    spans = list(zip(cuts[:-1], cuts[1:]))
    ls = max(int(b - a) for a, b in spans)
    whole = lambda t: None if t is None else t.to(device)

    return ShardedPlan2D(
        agg=plan.agg, deg=plan.deg, delta=plan.delta, n=plan.n,
        n_leaves=nl, nshards=nshards, max_depth=plan.max_depth,
        root=plan.root, zbounds=tuple(int(z) for z in zb),
        zlo=torch.as_tensor(zb[:-1], dtype=torch.int32, device=device),
        zhi=torch.as_tensor(zb[1:], dtype=torch.int32, device=device),
        leaf_z=_pad2([leaf_z[a:b] for a, b in spans], ls, INT_SENTINEL,
                     device),
        leaf_bounds=_pad2([bounds[a:b] for a, b in spans], ls, 0.0, device),
        leaf_coeffs=_pad2([coeffs[a:b] for a, b in spans], ls, 0.0, device),
        xcuts=whole(plan.xcuts), ycuts=whole(plan.ycuts),
        ref_xs=whole(plan.ref_xs), ref_ys_levels=whole(plan.ref_ys_levels),
        ref_wcum=whole(plan.ref_wcum), ref_wpmax=whole(plan.ref_wpmax),
        ref_xs_tree=whole(plan.ref_xs_tree),
    )


def _corner_eval2d_shard(sp: ShardedPlan2D, qx, qy):
    """Single-corner evaluation: the owner shard gathers the corner's leaf
    row, the owner-masked rows are summed (one nonzero row a lane), and
    the bivariate Horner runs on the combined row.

    The z-locate (three binary searches) and the gather are exact integer
    and selection work, and the sum of one owner row plus zeros reproduces
    the owner's bits; ``bivariate_horner`` is the function the quadtree
    descent of the unsharded ``'torch'`` path ends in, on the same
    coefficients and region, so the answers are bit-identical.
    """
    k = (sp.deg + 1) * (sp.deg + 1)
    ix = bsearch_count(sp.xcuts, qx, side="right")
    iy = bsearch_count(sp.ycuts, qy, side="right")
    z = interleave2(ix, iy, sp.max_depth)
    rows, owns = [], []
    for s in range(sp.nshards):
        owns.append(((z >= sp.zlo[s]) & (z < sp.zhi[s]))[:, None])
        row = torch.clamp(bsearch_count(sp.leaf_z[s], z, side="right") - 1,
                          min=0).long()
        rows.append(torch.cat([sp.leaf_coeffs[s][row],
                               sp.leaf_bounds[s][row]], dim=1))
    cb = _sum_owned(rows, owns)
    return bivariate_horner(qx, qy, cb[:, :k], cb[:, k:], sp.deg)


def _rect2d_raw(sp: ShardedPlan2D, lxc, uxc, lyc, uyc):
    """4-corner inclusion-exclusion, each corner through
    ``_corner_eval2d_shard`` — the unsharded op sequence."""
    vals = [_corner_eval2d_shard(sp, qx, qy)
            for qx, qy in ((uxc, uyc), (lxc, uyc), (uxc, lyc), (lxc, lyc))]
    return vals[0] - vals[1] - vals[2] + vals[3]


def _truth_rect2d(sp: ShardedPlan2D, lx, ux, ly, uy):
    """Exact rectangle COUNT/SUM from the whole refinement arrays: the
    unsharded ``'torch'`` truth, unchanged."""
    truth = truth_sum2d if sp.agg == "sum2d" else truth_count2d
    return truth(sp, lx, ux, ly, uy, backend="torch")


def _clamp2d(sp: ShardedPlan2D, qs):
    x0, x1, y0, y1 = sp.root
    lx, ux, ly, uy = qs
    return (torch.clamp(lx, x0, x1), torch.clamp(ux, x0, x1),
            torch.clamp(ly, y0, y1), torch.clamp(uy, y0, y1))


def _exec_shard_rect2d(sp: ShardedPlan2D, lx, ux, ly, uy, *,
                       eps_rel: Optional[float]):
    approx = _rect2d_raw(sp, *_clamp2d(sp, (lx, ux, ly, uy)))
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    ok = approx >= 4.0 * sp.delta * (1.0 + 1.0 / eps_rel)   # Lemma 6.4
    truth = _truth_rect2d(sp, lx, ux, ly, uy)
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_shard_dyn_rect2d(sp: ShardedPlan2D, buf: DeltaBuffer2D,
                           lx, ux, ly, uy, *, eps_rel: Optional[float]):
    static = _rect2d_raw(sp, *_clamp2d(sp, (lx, ux, ly, uy)))
    # the whole buffer's exact correction — the dense arithmetic of the
    # unsharded 'torch' dynamic executor, unclamped
    if sp.agg == "sum2d":
        corr = (_ref.delta_sum2d_ref(lx, ux, ly, uy, buf.ins_x, buf.ins_y,
                                     buf.ins_w)
                - _ref.delta_sum2d_ref(lx, ux, ly, uy, buf.del_x, buf.del_y,
                                       buf.del_w))
    else:
        corr = (_ref.delta_count2d_ref(lx, ux, ly, uy, buf.ins_x, buf.ins_y)
                - _ref.delta_count2d_ref(lx, ux, ly, uy, buf.del_x,
                                         buf.del_y))
    approx = static + corr
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    ok = approx >= 4.0 * sp.delta * (1.0 + 1.0 / eps_rel)
    truth = _truth_rect2d(sp, lx, ux, ly, uy) + corr
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_shard_dommax2d(sp: ShardedPlan2D, u, v, *,
                         eps_rel: Optional[float]):
    x0, x1, y0, y1 = sp.root
    approx = _corner_eval2d_shard(sp, torch.clamp(u, x0, x1),
                                  torch.clamp(v, y0, y1))
    neg = sp.agg == "min2d"
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    ok = approx >= sp.delta * (1.0 + 1.0 / eps_rel)
    truth = truth_dommax2d(sp, u, v, backend="torch")
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def _exec_shard_dyn_dommax2d(sp: ShardedPlan2D, buf: DeltaBuffer2D, u, v,
                             *, eps_rel: Optional[float]):
    """MAX space throughout; dominance deletes shadow victims
    (``buf.vic_x``/``vic_y``/``live_wpmax``), read whole as the unsharded
    executor reads them (the reference's sharded executor leaves them
    out)."""
    x0, x1, y0, y1 = sp.root
    static = _corner_eval2d_shard(sp, torch.clamp(u, x0, x1),
                                  torch.clamp(v, y0, y1))
    ins = _ref.delta_dommax2d_ref(u, v, buf.ins_x, buf.ins_y, buf.ins_w)
    approx = torch.maximum(static, ins)
    neg = sp.agg == "min2d"
    if buf.vic_x is not None:
        (i,) = _x_ranks(sp, "torch", u)
        exact = torch.maximum(mst_weighted_prefix(
            sp.ref_xs, sp.ref_ys_levels, buf.live_wpmax, i, v, mode="max"),
            ins)
        threat = ((buf.vic_x[None, :] <= u[:, None]) &
                  (buf.vic_y[None, :] <= v[:, None])).any(dim=1)
        if eps_rel is None:
            ans = torch.where(threat, exact, approx)
            if neg:
                ans = -ans
            return ans, ans, threat
        ok = (~threat) & (approx >= sp.delta * (1.0 + 1.0 / eps_rel))
        ans = torch.where(ok, approx, exact)
        if neg:
            ans, approx = -ans, -approx
        return ans, approx, ~ok
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    ok = approx >= sp.delta * (1.0 + 1.0 / eps_rel)
    truth = torch.maximum(truth_dommax2d(sp, u, v, backend="torch"), ins)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


class ShardedEngine2D:
    """Executes 2-key queries against z-range-partitioned leaf tables.

    ``shard(plan)`` partitions (and caches) an ``IndexPlan2D``; at
    ``nshards >= 2`` the query methods accept either the raw plan or a
    prepared ``ShardedPlan2D``; ``nshards=1`` runs the unsharded
    ``'torch'`` executors, as the reference's runs its single-device ones,
    so it requires the unsharded plan.  Passing ``buf=`` a live
    ``DeltaBuffer2D`` (e.g. a ``DynamicEngine2D`` snapshot's buffer) folds
    buffered updates in exactly — the buffer is read whole, so dynamic
    answers stay bit-identical to the unsharded ``'torch'`` path.
    """

    def __init__(self, nshards: int, *, device=None, min_bucket: int = 64):
        check_pow2("nshards", nshards)
        check_pow2("min_bucket", min_bucket)
        self.nshards = nshards
        self.device = None if device is None else torch.device(device)
        self.min_bucket = min_bucket
        self._plan_cache: dict = {}

    def shard(self, plan):
        if isinstance(plan, ShardedPlan2D):
            return plan
        if hasattr(plan, "levels") or isinstance(plan, ShardedLsmPlan2D):
            return _lsm_cache_shard(self, plan, shard_lsm_plan_2d)
        hit = self._plan_cache.get(id(plan))
        if hit is None or hit[0] is not plan:
            self._plan_cache = {id(plan): (plan, shard_plan_2d(
                plan, self.nshards, self.device))}
            hit = self._plan_cache[id(plan)]
        return hit[1]

    @staticmethod
    def _require_unsharded(plan) -> None:
        if not isinstance(plan, IndexPlan2D):
            raise ValueError(
                "nshards=1 runs the unsharded executors and needs the "
                "unsharded IndexPlan2D, not a pre-partitioned "
                "ShardedPlan2D")

    def _exec(self, plan, ranges, eps_rel, buf, need_ref, static, dyn,
              sharded_static, sharded_dyn):
        if self.nshards == 1:
            # S = 1 *is* the unsharded path: run its executors directly
            self._require_unsharded(plan)
            sp = plan
        else:
            sp = self.shard(plan)
        if eps_rel is not None:
            _require_exact(getattr(sp, need_ref) is not None)
        args, n = _prepare(ranges, _fills2d(sp), sp.device,
                           self.min_bucket)
        if self.nshards == 1:
            out = (static(plan, *args, backend="torch", eps_rel=eps_rel)
                   if buf is None else
                   dyn(plan, buf, *args, backend="torch", eps_rel=eps_rel))
        elif buf is None:
            out = sharded_static(sp, *args, eps_rel=eps_rel)
        else:
            out = sharded_dyn(sp, buf, *args, eps_rel=eps_rel)
        return _cut(out, n)

    def _rect(self, plan, ranges, eps_rel, buf, want_agg):
        assert plan.agg in want_agg, plan.agg
        return self._exec(plan, ranges, eps_rel, buf, "ref_xs",
                          _exec_rect2d, _exec_dyn_rect2d,
                          _exec_shard_rect2d, _exec_shard_dyn_rect2d)

    def count2d(self, plan, lx, ux, ly, uy,
                eps_rel: Optional[float] = None,
                buf: Optional[DeltaBuffer2D] = None) -> QueryResult:
        return self._rect(plan, (lx, ux, ly, uy), eps_rel, buf,
                          ("count2d",))

    def sum2d(self, plan, lx, ux, ly, uy,
              eps_rel: Optional[float] = None,
              buf: Optional[DeltaBuffer2D] = None) -> QueryResult:
        return self._rect(plan, (lx, ux, ly, uy), eps_rel, buf, ("sum2d",))

    def extremum2d(self, plan, u, v, eps_rel: Optional[float] = None,
                   buf: Optional[DeltaBuffer2D] = None) -> QueryResult:
        assert plan.agg in ("max2d", "min2d"), plan.agg
        return self._exec(plan, (u, v), eps_rel, buf, "ref_wpmax",
                          _exec_extremum2d, _exec_dyn_dommax2d,
                          _exec_shard_dommax2d, _exec_shard_dyn_dommax2d)

    def query(self, plan, *ranges, eps_rel: Optional[float] = None,
              buf: Optional[DeltaBuffer2D] = None) -> QueryResult:
        if hasattr(plan, "levels") or isinstance(plan, ShardedLsmPlan2D):
            return self.query_lsm(plan, *ranges, eps_rel=eps_rel, buf=buf)
        if plan.agg == "count2d":
            return self.count2d(plan, *ranges, eps_rel=eps_rel, buf=buf)
        if plan.agg == "sum2d":
            return self.sum2d(plan, *ranges, eps_rel=eps_rel, buf=buf)
        return self.extremum2d(plan, *ranges, eps_rel=eps_rel, buf=buf)

    def query_lsm(self, lsm, *ranges, eps_rel: Optional[float] = None,
                  buf: Optional[DeltaBuffer2D] = None) -> QueryResult:
        slsm = _lsm_cache_shard(self, lsm, shard_lsm_plan_2d)
        return execute_lsm_sharded(slsm, buf, ranges, eps_rel=eps_rel,
                                   min_bucket=self.min_bucket)


def _fills2d(plan):
    """The pad fills of a 2-D plan (sharded or not), ``pad_fills``'
    values: (x0, x0, y0, y0) for rectangles, (x0, y0) for corners."""
    x0, _, y0, _ = plan.root
    if plan.agg in ("max2d", "min2d"):
        return (x0, y0)
    return (x0, x0, y0, y0)


# ---------------------------------------------------------------------------
# LSM ladders: each immutable level's data plan sharded independently
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedLsmPlan:
    """A 1-D level ladder with every level's fitted ``IndexPlan`` sharded.

    ``levels`` keeps the original ``LsmLevel`` tuple: the exact side arrays
    — tombstone prefix sums, victim keys, live sparse tables, refinement
    keys — are read whole, as the reference replicates them (refinement
    arrays do not split at arbitrary cuts).  Only the per-level
    segment-table evaluation is sharded; the exact boundary corrections
    and the cross-level fusion are the unsharded ``'torch'`` arithmetic,
    so fused answers equal the unsharded ``execute_lsm(backend='torch')``.
    """

    agg: str
    nshards: int
    levels: tuple          # original LsmLevel tuple
    slevels: tuple         # per-level ShardedPlan, same order

    @property
    def dtype(self) -> torch.dtype:
        return self.levels[0].plan.dtype

    @property
    def device(self) -> torch.device:
        return self.slevels[0].device

    @property
    def deltas(self) -> Tuple[float, ...]:
        return tuple(lvl.plan.delta for lvl in self.levels)


@dataclasses.dataclass(frozen=True)
class ShardedLsmPlan2D(ShardedLsmPlan):
    """2-D counterpart of ``ShardedLsmPlan`` (z-range-sharded leaf tables
    per level, merge-sort-tree side arrays read whole)."""


def shard_lsm_plan(lsm, nshards: int, device=None) -> ShardedLsmPlan:
    """Shard every level of an ``LsmPlan`` (1-D) into ``nshards`` key
    ranges.  Levels are partitioned independently — a compaction that
    rebuilds one slot re-shards only that level's fresh plan."""
    return ShardedLsmPlan(
        agg=lsm.agg, nshards=nshards, levels=tuple(lsm.levels),
        slevels=tuple(shard_plan(l.plan, nshards, device)
                      for l in lsm.levels))


def shard_lsm_plan_2d(lsm, nshards: int, device=None) -> ShardedLsmPlan2D:
    """Shard every level of an ``LsmPlan2D`` into ``nshards`` z-ranges."""
    return ShardedLsmPlan2D(
        agg=lsm.agg, nshards=nshards, levels=tuple(lsm.levels),
        slevels=tuple(shard_plan_2d(l.plan, nshards, device)
                      for l in lsm.levels))


def _lsm_cache_shard(engine, lsm, shard_fn):
    """Single-entry per-engine ladder cache keyed on ladder identity."""
    if isinstance(lsm, ShardedLsmPlan):
        return lsm
    cache = getattr(engine, "_lsm_cache", None)
    if cache is None or cache[0] is not lsm:
        engine._lsm_cache = (lsm, shard_fn(lsm, engine.nshards,
                                           engine.device))
        cache = engine._lsm_cache
    return cache[1]


def _lsm_level_sum_sharded(lvl, sp, qs):
    """Sharded twin of ``lsm._level_sum``: the raw range sum runs on the
    owner shards; the m0 below-domain addend and the exact tombstone
    subtraction are the unsharded ones."""
    lq, uq = qs
    part = _exec_shard_sum(sp, lq, uq, eps_rel=None)[0]
    p = lvl.plan
    lo = p.seg_lo[0]
    part = part + torch.where((lq < lo) & (uq >= lo), p.ref_cf[0],
                              torch.zeros((), dtype=p.dtype,
                                          device=part.device))
    if lvl.tomb_keys is not None:
        part = part - _tomb_sum_1d(lvl, lq, uq)
    return (part,)


def _lsm_level_extremum_sharded(lvl, sp, qs):
    """Sharded twin of ``lsm._level_extremum``: the fitted staircase max
    reduces through per-shard sparse tables; the exact live maximum, the
    hold within delta of it (the port's repair of the reference's level)
    and the victim threat test read the level's whole arrays."""
    lq, uq = qs
    p = lvl.plan
    lo = p.seg_lo[0]
    hi = p.seg_hi[p.h - 1]
    lqc = torch.clamp(lq, lo, hi)
    uqc = torch.clamp(uq, lo, hi)
    out = _exec_shard_extremum(sp, lqc, uqc, eps_rel=None)[0]
    raw = -out if p.agg == "min" else out   # back to MAX space
    st = lvl.live_st if lvl.live_st is not None else p.ref_st
    exact = sparse_table_range_max(
        st, *key_span(p.ref_keys, lq, uq, "torch", p.ref_tree))
    valid = (uq >= lo) & (lq <= hi) & (exact > -torch.inf)
    raw = torch.clamp(raw, exact - p.delta, exact + p.delta)
    part = torch.where(valid, raw, -torch.inf)
    return part, exact, _threat_1d(lvl.vic_keys, lq, uq)


def _lsm_level_rect_sharded(lvl, sp, qs):
    """Sharded twin of ``lsm._level_rect``: each clamped corner is one
    owner-gathered sharded evaluation; the below-root corner corrections
    reuse the same corner values, and tombstones subtract exactly."""
    lx, ux, ly, uy = qs
    p = lvl.plan
    x0, x1, y0, y1 = p.root
    lxc, uxc = (torch.clamp(q, x0, x1) for q in (lx, ux))
    lyc, uyc = (torch.clamp(q, y0, y1) for q in (ly, uy))
    v = [_corner_eval2d_shard(sp, a, b)
         for a, b in ((uxc, uyc), (lxc, uyc), (uxc, lyc), (lxc, lyc))]
    part = v[0] - v[1] - v[2] + v[3]
    zero = torch.zeros((), dtype=p.dtype, device=part.device)
    for a, b, e, s in ((ux, uy, v[0], 1.0), (lx, uy, v[1], -1.0),
                       (ux, ly, v[2], -1.0), (lx, ly, v[3], 1.0)):
        part = part + torch.where((a < x0) | (b < y0), -s * e, zero)
    if lvl.tomb_xs is not None:
        part = part - _tomb_rect_2d(lvl, lx, ux, ly, uy, p.dtype)
    return (part,)


def _lsm_level_dommax_sharded(lvl, sp, qs):
    """Sharded twin of ``lsm._level_dommax``."""
    u, v = qs
    p = lvl.plan
    x0, x1, y0, y1 = p.root
    out = _exec_shard_dommax2d(sp, u, v, eps_rel=None)[0]
    raw = -out if p.agg == "min2d" else out   # back to MAX space
    wp = lvl.live_wpmax if lvl.live_wpmax is not None else p.ref_wpmax
    (i,) = _x_ranks(p, "torch", u)
    exact = mst_weighted_prefix(p.ref_xs, p.ref_ys_levels, wp, i, v,
                                mode="max").to(p.dtype)
    valid = (u >= x0) & (v >= y0) & (exact > -torch.inf)
    part = torch.where(valid, raw, -torch.inf)
    if lvl.vic_x is not None:
        threat = ((lvl.vic_x[None, :] <= u[:, None])
                  & (lvl.vic_y[None, :] <= v[:, None])).any(dim=1)
    else:
        threat = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    return part, exact, threat


_LSM_SHARD_CORES = {
    "sum": _lsm_level_sum_sharded, "count": _lsm_level_sum_sharded,
    "max": _lsm_level_extremum_sharded, "min": _lsm_level_extremum_sharded,
    "count2d": _lsm_level_rect_sharded, "sum2d": _lsm_level_rect_sharded,
    "max2d": _lsm_level_dommax_sharded, "min2d": _lsm_level_dommax_sharded,
}


def execute_lsm_sharded(slsm: ShardedLsmPlan, buf, ranges, *, eps_rel=None,
                        min_bucket: int = 64) -> QueryResult:
    """Fuse a query batch across a sharded level ladder (Q_abs only).

    Per-level raw evaluations run sharded; the exact corrections and the
    cross-level combiner (``lsm.combine_levels`` on ``'torch'``) are the
    unsharded ones, so answers equal the unsharded
    ``execute_lsm(..., backend='torch', eps_rel=None)``.  Q_rel refinement
    would need the per-level refinement arrays partitioned — query the
    unsharded ladder for that."""
    if eps_rel is not None:
        raise ValueError(
            "sharded LSM execution is Q_abs-only (per-level fusion over "
            "the levels' whole exact arrays); pass eps_rel=None or query "
            "the unsharded ladder")
    check_pow2("min_bucket", min_bucket)
    qs, n = _prepare(ranges, pad_fills(slsm.levels[0].plan), slsm.device,
                     min_bucket)
    core = _LSM_SHARD_CORES[slsm.agg]
    outs = [core(lvl, sp, qs) for lvl, sp in zip(slsm.levels, slsm.slevels)]
    out = combine_levels(slsm.agg, outs, buf, qs, backend="torch",
                         eps_rel=None,
                         bound=composed_bound(slsm.agg, slsm.deltas))
    return _cut(out, n)
