"""Backend-dispatched query engine: one fused execution path per
(aggregate, backend, batch bucket).

The twin of ``repro.engine.engine`` for one-key SUM/COUNT/MAX/MIN and
QUANTILE and two-key COUNT/SUM rectangles and dominance MAX/MIN.  Backends
pair with the reference's ``BACKENDS``:

* ``'torch'`` (twin of ``'xla'``) — searchsorted locate + gather + Horner,
  sparse-table interior MAX (the reference semantics of ``core.queries``);
  the quadtree descent for 2-D;
* ``'cuda'`` (twin of ``'pallas'``) — the hand-written locate->gather
  kernels K2 (SUM/COUNT) and K3 (MAX/MIN) of ``csrc/``, K4 for QUANTILE
  (certified CF inversion, ``execute_quantile``), and for 2-D plans K7
  (rectangles) and K8 (dominance corners), or K12 and K13, the one-hot
  scans, for plans deeper than 15 levels (no int32 Morton codes);
* ``'cuda_scan'`` (twin of ``'pallas_scan'``) — the hand-written one-hot
  scan kernels: K14 (SUM/COUNT) and K15 (MAX/MIN) test every query against
  every segment, K4 runs its scan mode (every searchsorted a comparison
  sum), and 2-D plans of every depth take K12 and K13; the answers equal
  ``'cuda'``'s bit for bit;
* ``'ref'`` — the plain one-hot oracles of ``kernels/ref.py`` (the one-hot
  searchsorted form of ``core.quantile`` for QUANTILE).

The default is ``'cuda'`` for a plan on a CUDA device and ``'torch'`` for a
plan on the CPU; the two card backends raise for a plan on the CPU.

Each path computes the raw approximation, applies the Lemma 5.2/5.4 Q_rel
acceptance test and merges the exact refinement with ``torch.where`` — the
refinement arrays live in the plan, so there is no host round trip.  The
refinement's searches of the sorted keys run kernel K1 (``locate``, over the
plan's search tree) on the two card backends and the plain
``locate_segments`` on the others.
Batches are padded to power-of-two buckets, as the reference pads them, so
answers match it lane for lane.

Q_abs guarantees need no test: build the index with delta = eps_abs/2 (SUM,
Lemma 5.1), eps_abs (MAX, Lemma 5.3) or eps_abs/4 (2-D COUNT/SUM, Lemma
6.3) and the raw answer already satisfies the bound.  The 2-D Q_rel truth
is the merge-sort tree's prefix counts (``core.index2d.mst_*``), plain
torch ops as the reference runs plain XLA, after K1 finds each corner's
x rank on the card backends.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .. import DTYPE
from ..core.exact import sparse_table_range_max
from ..core.index2d import (mst_count_prefix, mst_weighted_prefix,
                            quadtree_eval_cf)
from ..core.poly import eval_segments, horner
from ..core.quantile import (boundary_array, certified_quantile_shifted,
                             rank_slack)
from ..core.queries import QueryResult, max_eval_segments
from ..kernels import ref as _ref
from ..kernels.leaf_eval2d import (corner_count2d, corner_count2d_gather,
                                   corner_eval2d, corner_eval2d_gather)
from ..kernels.locate import locate, locate_segments
from ..kernels.quantile_invert import quantile_invert
from ..kernels.range_max import range_max, range_max_gather
from ..kernels.range_sum import range_sum, range_sum_gather
from .plan import IndexPlan, IndexPlan2D, big_sentinel, pad_to_multiple

__all__ = ["Engine", "BACKENDS", "QuantileResult", "raw_sum", "raw_extremum",
           "raw_count2d", "raw_eval2d", "truth_sum", "truth_extremum",
           "truth_count2d", "truth_sum2d", "truth_dommax2d", "key_span",
           "check_pow2", "execute_sum", "execute_extremum",
           "execute_quantile", "execute_count2d", "execute_sum2d",
           "execute_extremum2d", "execute", "pad_fills", "resolve_backend",
           "quantile_mass", "quantile_tables", "prepare_fractions"]

BACKENDS = ("torch", "cuda", "cuda_scan", "ref")
# the backends that launch the CUDA kernels
CARD_BACKENDS = ("cuda", "cuda_scan")


class QuantileResult(NamedTuple):
    """Certified quantile triple: ``lo <= answer <= hi`` everywhere, and
    [lo, hi] brackets the exact quantile key."""
    answer: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def check_pow2(name: str, v: int) -> None:
    """Bucket sizes must be powers of two (so smaller ones always divide
    larger ones)."""
    if v < 1 or v & (v - 1):
        raise ValueError(f"{name} must be a power of two, got {v}")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend}")


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """The concrete backend for a plan on ``device``: ``'cuda'`` on a CUDA
    device and ``'torch'`` on the CPU when ``backend`` is None."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    _check_backend(backend)
    if backend in CARD_BACKENDS and device.type != "cuda":
        raise ValueError(f"backend {backend!r} runs the CUDA kernels and "
                         f"needs a plan on a CUDA device, got {device}")
    return backend


def _bucket_size(n: int, min_bucket: int) -> int:
    b = max(min_bucket, 1)
    while b < n:
        b <<= 1
    return b


def _pad_bucket(q: torch.Tensor, size: int, fill: torch.Tensor) -> torch.Tensor:
    p = size - q.shape[0]
    if p == 0:
        return q
    return torch.cat([q, fill.expand(p)])


def pad_fills(plan: Union[IndexPlan, IndexPlan2D]):
    """Per-range-coordinate padding fills for bucketed batches — the values
    the ``execute_*`` entry points pad with."""
    if isinstance(plan, IndexPlan2D):
        x0, _, y0, _ = plan.root
        if plan.agg in ("max2d", "min2d"):
            return (x0, y0)
        return (x0, x0, y0, y0)
    return (plan.domain_lo, plan.domain_lo)


def _locate_keys(keys: torch.Tensor, q: torch.Tensor, backend: str,
                 tree: torch.Tensor):
    """max(#(keys <= q) - 1, 0) per lane: K1 on the card backends (over
    ``tree``, the keys' search tree the plan carries), the plain binary
    search on the others."""
    if backend in CARD_BACKENDS:
        return locate(q, keys, tree)
    return locate_segments(keys, q)


def _count_le(keys: torch.Tensor, q: torch.Tensor, backend: str,
              tree: torch.Tensor):
    """#(keys <= q) per lane: the count is 0 exactly when q lies below the
    first key (or is NaN)."""
    return torch.where(q >= keys[0],
                       _locate_keys(keys, q, backend, tree) + 1, 0)


# ---------------------------------------------------------------------------
# raw-approximation / static-truth primitives
# ---------------------------------------------------------------------------

def raw_sum(plan: IndexPlan, lqc, uqc, *, backend: str):
    """Backend-dispatched raw SUM/COUNT approximation (clamped queries):
    K2 on 'cuda', K14 on 'cuda_scan'."""
    if backend == "cuda":
        return range_sum_gather(lqc, uqc, plan.seg_lo, plan.seg_hi,
                                plan.coeffs, plan.seg_tree)
    if backend == "cuda_scan":
        return range_sum(lqc, uqc, plan.seg_lo, plan.seg_next, plan.seg_hi,
                         plan.coeffs)
    if backend == "ref":
        return _ref.range_sum_ref(lqc, uqc, plan.seg_lo, plan.seg_next,
                                  plan.seg_hi, plan.coeffs)
    return (eval_segments(uqc, plan.seg_lo, plan.seg_hi, plan.coeffs)
            - eval_segments(lqc, plan.seg_lo, plan.seg_hi, plan.coeffs))


def raw_extremum(plan: IndexPlan, lqc, uqc, *, backend: str):
    """Backend-dispatched raw MAX approximation, in MAX space (MIN plans run
    on negated measures end to end): K3 on 'cuda', K15 on 'cuda_scan'."""
    if backend == "cuda":
        return range_max_gather(lqc, uqc, plan.seg_lo, plan.seg_hi,
                                plan.coeffs, plan.st, plan.seg_tree)
    if backend == "cuda_scan":
        return range_max(lqc, uqc, plan.seg_lo, plan.seg_next, plan.seg_hi,
                         plan.coeffs, plan.seg_agg)
    if backend == "ref":
        return _ref.range_max_ref(lqc, uqc, plan.seg_lo, plan.seg_next,
                                  plan.seg_hi, plan.coeffs, plan.seg_agg)
    return max_eval_segments(plan.seg_lo, plan.seg_hi, plan.coeffs,
                             plan.st, lqc, uqc)


def raw_count2d(plan: IndexPlan2D, lxc, uxc, lyc, uyc, *, backend: str):
    """Backend-dispatched raw 2-key COUNT/SUM approximation (clamped
    corners): K7 on 'cuda', K12 on 'cuda_scan' and for plans without
    Morton codes."""
    if backend == "cuda" and plan.leaf_z is not None:
        return corner_count2d_gather(
            lxc, uxc, lyc, uyc, plan.xcuts, plan.ycuts, plan.leaf_z,
            plan.leaf_bounds, plan.leaf_coeffs, plan.deg, plan.max_depth)
    if backend in CARD_BACKENDS:
        # scan path: 'cuda_scan', and plans whose depth exceeds the Morton
        # int32 range
        return corner_count2d(
            lxc, uxc, lyc, uyc, plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0,
            plan.leaf_my1, plan.leaf_bounds, plan.leaf_coeffs, plan.deg)
    if backend == "ref":
        return _ref.corner_count2d_ref(
            lxc, uxc, lyc, uyc, plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0,
            plan.leaf_my1, plan.leaf_bounds, plan.leaf_coeffs, plan.deg)
    ev = lambda u, v: quadtree_eval_cf(
        plan.children, plan.leaf_of, plan.bounds, plan.qt_coeffs,
        plan.leaf_nodes, plan.max_depth, plan.deg, u, v)
    return ev(uxc, uyc) - ev(lxc, uyc) - ev(uxc, lyc) + ev(lxc, lyc)


def raw_eval2d(plan: IndexPlan2D, uc, vc, *, backend: str):
    """Backend-dispatched single-corner evaluation P_{leaf(u,v)}(u, v) —
    the dominance MAX/MIN path (clamped corners): K8 on 'cuda', K13 on
    'cuda_scan' and for plans without Morton codes."""
    if backend == "cuda" and plan.leaf_z is not None:
        return corner_eval2d_gather(
            uc, vc, plan.xcuts, plan.ycuts, plan.leaf_z, plan.leaf_bounds,
            plan.leaf_coeffs, plan.deg, plan.max_depth)
    if backend in CARD_BACKENDS:
        return corner_eval2d(
            uc, vc, plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0,
            plan.leaf_my1, plan.leaf_bounds, plan.leaf_coeffs, plan.deg)
    if backend == "ref":
        return _ref.leaf_eval2d_ref(
            uc, vc, plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0,
            plan.leaf_my1, plan.leaf_bounds, plan.leaf_coeffs, plan.deg)
    return quadtree_eval_cf(plan.children, plan.leaf_of, plan.bounds,
                            plan.qt_coeffs, plan.leaf_nodes, plan.max_depth,
                            plan.deg, uc, vc)


def truth_sum(plan: IndexPlan, lq, uq, *, backend: str):
    """Exact static SUM/COUNT over (lq, uq] from the plan's refinement CF."""
    keys, cf = plan.ref_keys, plan.ref_cf
    cf_at = lambda q: torch.where(
        q >= keys[0], cf[_locate_keys(keys, q, backend, plan.ref_tree)], 0.0)
    return cf_at(uq) - cf_at(lq)


def key_span(keys: torch.Tensor, lq, uq, backend: str,
             tree: torch.Tensor):
    """The span [#(keys < lq), #(keys <= uq)) of the sorted ``keys`` that
    [lq, uq] covers.  #(keys < lq) is #(keys <= the next double below lq):
    the same search (K1 over ``tree``, the keys' search tree, on the card
    backends) serves both ends."""
    i = _count_le(keys, torch.nextafter(lq, lq.new_full((), -torch.inf)),
                  backend, tree)
    return i, _count_le(keys, uq, backend, tree)


def truth_extremum(plan: IndexPlan, lq, uq, *, backend: str):
    """Exact static MAX over [lq, uq] (MAX space) from the refinement
    table."""
    return sparse_table_range_max(plan.ref_st,
                                  *key_span(plan.ref_keys, lq, uq, backend,
                                            plan.ref_tree))


def _x_ranks(plan: IndexPlan2D, backend: str, *qs):
    """#(ref_xs <= q) per lane for each x coordinate (K1 over the plan's
    ``ref_xs_tree`` on the card backends)."""
    return [_count_le(plan.ref_xs, q, backend, plan.ref_xs_tree)
            for q in qs]


def truth_count2d(plan: IndexPlan2D, lx, ux, ly, uy, *, backend: str):
    """Exact static 2-key COUNT over (lx, ux] x (ly, uy] (merge-sort tree)."""
    il, iu = _x_ranks(plan, backend, lx, ux)
    cf = lambda i, v: mst_count_prefix(plan.ref_xs, plan.ref_ys_levels, i, v)
    return (cf(iu, uy) - cf(il, uy) - cf(iu, ly) + cf(il, ly)).to(plan.dtype)


def truth_sum2d(plan: IndexPlan2D, lx, ux, ly, uy, *, backend: str):
    """Exact static 2-key SUM over (lx, ux] x (ly, uy] (weighted tree)."""
    il, iu = _x_ranks(plan, backend, lx, ux)
    cf = lambda i, v: mst_weighted_prefix(plan.ref_xs, plan.ref_ys_levels,
                                          plan.ref_wcum, i, v, mode="sum")
    return (cf(iu, uy) - cf(il, uy) - cf(iu, ly) + cf(il, ly)).to(plan.dtype)


def truth_dommax2d(plan: IndexPlan2D, u, v, *, backend: str):
    """Exact static dominance MAX over {x <= u, y <= v}, in MAX space
    (-inf when the dominated set is empty)."""
    (i,) = _x_ranks(plan, backend, u)
    return mst_weighted_prefix(plan.ref_xs, plan.ref_ys_levels,
                               plan.ref_wpmax, i, v, mode="max").to(
        plan.dtype)


# ---------------------------------------------------------------------------
# fused executors
# ---------------------------------------------------------------------------

def _no_refine(x: torch.Tensor) -> torch.Tensor:
    """The ``refined`` mask of a Q_abs batch: all False."""
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def _exec_sum(plan: IndexPlan, lq, uq, *, backend: str,
              eps_rel: Optional[float]):
    lqc = torch.maximum(lq, plan.domain_lo)
    uqc = torch.maximum(uq, plan.domain_lo)
    approx = raw_sum(plan, lqc, uqc, backend=backend)
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    # Lemma 5.2 test: 2d / (A - 2d) <= eps_rel  (requires A > 2d)
    two_d = 2.0 * plan.delta
    ok = ((approx - two_d > 0) &
          (two_d / torch.clamp(approx - two_d, min=1e-300) <= eps_rel))
    truth = truth_sum(plan, lq, uq, backend=backend)
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_extremum(plan: IndexPlan, lq, uq, *, backend: str,
                   eps_rel: Optional[float]):
    lqc = torch.maximum(lq, plan.domain_lo)
    uqc = torch.maximum(uq, plan.domain_lo)
    approx = raw_extremum(plan, lqc, uqc, backend=backend)
    neg = plan.agg == "min"
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    # Lemma 5.4 test: A >= delta * (1 + 1/eps_rel), in MAX space (MIN runs
    # on negated measures end to end, exactly like core.queries.query_max)
    ok = approx >= plan.delta * (1.0 + 1.0 / eps_rel)
    truth = truth_extremum(plan, lq, uq, backend=backend)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


def _exec_rect2d(plan: IndexPlan2D, lx, ux, ly, uy, *, backend: str,
                 eps_rel: Optional[float]):
    """Shared 4-corner rectangle executor for 2-key COUNT and SUM: the raw
    path runs on clamped corners, the Q_rel truth on the raw ones."""
    x0, x1, y0, y1 = plan.root
    lxc, uxc = (torch.clamp(q, x0, x1) for q in (lx, ux))
    lyc, uyc = (torch.clamp(q, y0, y1) for q in (ly, uy))
    approx = raw_count2d(plan, lxc, uxc, lyc, uyc, backend=backend)
    if eps_rel is None:
        return approx, approx, _no_refine(approx)
    # Lemma 6.4 test: A >= 4*delta*(1 + 1/eps_rel)
    ok = approx >= 4.0 * plan.delta * (1.0 + 1.0 / eps_rel)
    truth = (truth_sum2d if plan.agg == "sum2d" else truth_count2d)(
        plan, lx, ux, ly, uy, backend=backend)
    return torch.where(ok, approx, truth), approx, ~ok


def _exec_extremum2d(plan: IndexPlan2D, u, v, *, backend: str,
                     eps_rel: Optional[float]):
    """Dominance MAX/MIN: one fitted-surface evaluation per corner, in MAX
    space throughout (min2d plans are built on negated measures)."""
    x0, x1, y0, y1 = plan.root
    uc = torch.clamp(u, x0, x1)
    vc = torch.clamp(v, y0, y1)
    approx = raw_eval2d(plan, uc, vc, backend=backend)
    neg = plan.agg == "min2d"
    if eps_rel is None:
        out = -approx if neg else approx
        return out, out, _no_refine(out)
    # Lemma 5.4 shape: A >= delta * (1 + 1/eps_rel), in MAX space
    ok = approx >= plan.delta * (1.0 + 1.0 / eps_rel)
    truth = truth_dommax2d(plan, u, v, backend=backend)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return ans, approx, ~ok


# ---------------------------------------------------------------------------
# the dispatch path: everything public (the Engine shim, the PolyFit
# session facade in repro_torch.api) routes through these functions
# ---------------------------------------------------------------------------

def _prepare(*qs, min_bucket: int, plan):
    """Cast to float64 tensors on the plan's device, padded to the bucket
    with the plan's fills (``pad_fills``)."""
    check_pow2("min_bucket", min_bucket)
    qs = [torch.as_tensor(q, dtype=DTYPE, device=plan.device).reshape(-1)
          for q in qs]
    n = qs[0].shape[0]
    size = _bucket_size(n, min_bucket)
    fills = [torch.as_tensor(f, dtype=DTYPE, device=plan.device).reshape(1)
             for f in pad_fills(plan)]
    return [_pad_bucket(q, size, f) for q, f in zip(qs, fills)], n


def _require_exact(cond: bool):
    if not cond:
        raise ValueError("Q_rel refinement requires a plan built with "
                         "with_exact=True")


def execute_sum(plan: IndexPlan, lq, uq, *, backend: Optional[str] = None,
                eps_rel: Optional[float] = None,
                min_bucket: int = 64) -> QueryResult:
    """1-D SUM/COUNT over (lq, uq] through the fused executor."""
    if plan.agg not in ("sum", "count"):
        raise ValueError(f"execute_sum needs a sum/count plan, got {plan.agg}")
    backend = resolve_backend(backend, plan.device)
    if eps_rel is not None:
        _require_exact(plan.ref_cf is not None)
    (lq, uq), n = _prepare(lq, uq, min_bucket=min_bucket, plan=plan)
    ans, approx, refined = _exec_sum(plan, lq, uq, backend=backend,
                                     eps_rel=eps_rel)
    return QueryResult(ans[:n], approx[:n], refined[:n])


def quantile_mass(plan: IndexPlan, dM=0.0):
    """(M, slack): the total mass rank fractions scale, and the soundness
    slack, for a SUM/COUNT plan plus a buffered mass change ``dM``.

    ``M`` is exact for COUNT and for a SUM plan with exact arrays; without
    them it is the fitted top, off by at most the top segment's error, so
    the slack widens by delta."""
    dt = plan.dtype
    if plan.agg == "count":
        # a fill, not a host copy: the serving engine captures this path
        # into a CUDA graph, which takes no host-to-device copy
        M = torch.full((), float(plan.n), dtype=dt, device=plan.device) + dM
        return M, rank_slack("count", M)
    if plan.ref_cf is not None:
        M0, extra = plan.ref_cf[-1], 0.0      # exact total mass
    else:
        M0 = horner(plan.coeffs[plan.h - 1],
                    torch.ones((), dtype=dt, device=plan.device))
        extra = plan.delta
    M = M0 + dM
    return M, rank_slack("sum", M) + extra


def quantile_tables(plan: IndexPlan):
    """(err, B, keys, nk): the per-segment errors (delta where the plan
    has none), the boundary array, and the exact key grid padded to a
    multiple of 128 with the sentinel holding ``nk`` keys (None, 0 without
    exact arrays)."""
    err = (plan.seg_err if plan.seg_err is not None
           else torch.full_like(plan.seg_lo, plan.delta))
    B = boundary_array(plan.coeffs)
    if plan.ref_keys is None:
        return err, B, None, 0
    keys = pad_to_multiple(plan.ref_keys, 128, big_sentinel(plan.dtype))
    return err, B, keys, plan.n


def prepare_fractions(q, plan: IndexPlan, min_bucket: int):
    """Quantile fractions as a float64 tensor on the plan's device, padded
    with 0.5 to the power-of-two bucket; returns (padded, count)."""
    check_pow2("min_bucket", min_bucket)
    q = torch.as_tensor(q, dtype=DTYPE, device=plan.device).reshape(-1)
    n = q.shape[0]
    return _pad_bucket(q, _bucket_size(n, min_bucket),
                       q.new_full((), 0.5)), n


def _exec_quantile(plan: IndexPlan, q, *, backend: str):
    qc = torch.clamp(q, 0.0, 1.0)
    M, slack = quantile_mass(plan)
    err, B, keys, nk = quantile_tables(plan)
    t = qc * M
    if backend in CARD_BACKENDS:
        return quantile_invert(t, t - slack, t + slack, B, plan.seg_lo,
                               plan.seg_hi, plan.coeffs, err, keys,
                               plan.ref_tree, h=plan.h, n=nk,
                               delta=float(plan.delta),
                               scan=backend == "cuda_scan")
    return certified_quantile_shifted(
        t, t - slack, t + slack, seg_lo=plan.seg_lo, seg_hi=plan.seg_hi,
        coeffs=plan.coeffs, seg_err=err, h=plan.h, delta=float(plan.delta),
        B=B, ref_keys=keys, n=nk, scan=(backend == "ref"))


def execute_quantile(plan: IndexPlan, q, *, backend: Optional[str] = None,
                     min_bucket: int = 64) -> QuantileResult:
    """Certified 1-D QUANTILE by CF inversion.

    ``q`` holds quantile fractions in [0, 1]; works on SUM/COUNT plans
    (COUNT inverts ranks, SUM cumulative measure — the weighted quantile).
    The returned [lo, hi] always brackets the exact quantile key; there is
    no Q_rel path (the certificate is the guarantee).  K4 runs on the
    ``'cuda'`` backend, its scan mode on ``'cuda_scan'``; a plan without
    exact arrays has no key grid to snap to and takes the ``'torch'`` path,
    as the reference takes XLA, counted in
    ``execute_quantile.torch_routes``.
    """
    if plan.agg not in ("sum", "count"):
        raise ValueError("execute_quantile needs a sum/count plan, got "
                         f"{plan.agg}")
    if plan.deg < 1:
        raise ValueError("quantile inversion needs a plan with deg >= 1")
    backend = resolve_backend(backend, plan.device)
    if backend in CARD_BACKENDS and plan.ref_keys is None:
        backend = "torch"   # the kernel's key-grid snap needs ref_keys
        execute_quantile.torch_routes += 1
    q, n = prepare_fractions(q, plan, min_bucket)
    ans, lo, hi = _exec_quantile(plan, q, backend=backend)
    return QuantileResult(ans[:n], lo[:n], hi[:n])


execute_quantile.torch_routes = 0


def execute_extremum(plan: IndexPlan, lq, uq, *,
                     backend: Optional[str] = None,
                     eps_rel: Optional[float] = None,
                     min_bucket: int = 64) -> QueryResult:
    """1-D MAX/MIN over [lq, uq] (MIN plans run on negated measures).

    Plans of degree > 3 take the ``'torch'`` path whatever the backend, as
    the reference routes them to XLA: the kernel's closed-form extrema stop
    at deg 3.  ``execute_extremum.torch_routes`` counts those reroutes.
    """
    if plan.agg not in ("max", "min"):
        raise ValueError(f"execute_extremum needs a max/min plan, got "
                         f"{plan.agg}")
    backend = resolve_backend(backend, plan.device)
    if eps_rel is not None:
        _require_exact(plan.ref_st is not None)
    if backend in ("cuda", "cuda_scan", "ref") and plan.deg > 3:
        backend = "torch"
        execute_extremum.torch_routes += 1
    (lq, uq), n = _prepare(lq, uq, min_bucket=min_bucket, plan=plan)
    ans, approx, refined = _exec_extremum(plan, lq, uq, backend=backend,
                                          eps_rel=eps_rel)
    return QueryResult(ans[:n], approx[:n], refined[:n])


execute_extremum.torch_routes = 0


def _execute_rect2d(plan: IndexPlan2D, lx, ux, ly, uy, *, backend,
                    eps_rel, min_bucket) -> QueryResult:
    backend = resolve_backend(backend, plan.device)
    if eps_rel is not None:
        _require_exact(plan.ref_xs is not None)
    (lx, ux, ly, uy), n = _prepare(lx, ux, ly, uy, min_bucket=min_bucket,
                                   plan=plan)
    ans, approx, refined = _exec_rect2d(plan, lx, ux, ly, uy,
                                        backend=backend, eps_rel=eps_rel)
    return QueryResult(ans[:n], approx[:n], refined[:n])


def execute_count2d(plan: IndexPlan2D, lx, ux, ly, uy, *,
                    backend: Optional[str] = None,
                    eps_rel: Optional[float] = None,
                    min_bucket: int = 64) -> QueryResult:
    """2-key COUNT over (lx, ux] x (ly, uy] via 4-corner inclusion-exclusion."""
    if plan.agg != "count2d":
        raise ValueError(f"execute_count2d needs a count2d plan, got "
                         f"{plan.agg}")
    return _execute_rect2d(plan, lx, ux, ly, uy, backend=backend,
                           eps_rel=eps_rel, min_bucket=min_bucket)


def execute_sum2d(plan: IndexPlan2D, lx, ux, ly, uy, *,
                  backend: Optional[str] = None,
                  eps_rel: Optional[float] = None,
                  min_bucket: int = 64) -> QueryResult:
    """2-key SUM over (lx, ux] x (ly, uy]: the same 4-corner path over a
    CF_sum-fitted plan, |A - R| <= 4*delta."""
    if plan.agg != "sum2d":
        raise ValueError(f"execute_sum2d needs a sum2d plan, got {plan.agg}")
    return _execute_rect2d(plan, lx, ux, ly, uy, backend=backend,
                           eps_rel=eps_rel, min_bucket=min_bucket)


def execute_extremum2d(plan: IndexPlan2D, u, v, *,
                       backend: Optional[str] = None,
                       eps_rel: Optional[float] = None,
                       min_bucket: int = 64) -> QueryResult:
    """Dominance MAX/MIN at (u, v): the extremal measure over
    {x <= u, y <= v}, |A - R| <= delta (min2d plans run on negated
    measures end to end)."""
    if plan.agg not in ("max2d", "min2d"):
        raise ValueError(f"execute_extremum2d needs a max2d/min2d plan, got "
                         f"{plan.agg}")
    backend = resolve_backend(backend, plan.device)
    if eps_rel is not None:
        _require_exact(plan.ref_wpmax is not None)
    (u, v), n = _prepare(u, v, min_bucket=min_bucket, plan=plan)
    ans, approx, refined = _exec_extremum2d(plan, u, v, backend=backend,
                                            eps_rel=eps_rel)
    return QueryResult(ans[:n], approx[:n], refined[:n])


def execute(plan: Union[IndexPlan, IndexPlan2D], ranges, *,
            backend: Optional[str] = None, eps_rel: Optional[float] = None,
            min_bucket: int = 64) -> QueryResult:
    """Dispatch on the plan: (lq, uq) for 1-D SUM/COUNT/MAX/MIN, (lx, ux,
    ly, uy) for 2-D rectangles, (u, v) for 2-D dominance MAX/MIN; a level
    ladder (``LsmPlan``/``LsmPlan2D``) takes its aggregate's ranges."""
    kw = dict(backend=backend, eps_rel=eps_rel, min_bucket=min_bucket)
    if hasattr(plan, "levels"):   # LsmPlan level ladder
        from .lsm import execute_lsm
        return execute_lsm(plan, None, ranges, **kw)
    if isinstance(plan, IndexPlan2D):
        if plan.agg == "count2d":
            return execute_count2d(plan, *ranges, **kw)
        if plan.agg == "sum2d":
            return execute_sum2d(plan, *ranges, **kw)
        return execute_extremum2d(plan, *ranges, **kw)
    if plan.agg in ("sum", "count"):
        return execute_sum(plan, *ranges, **kw)
    return execute_extremum(plan, *ranges, **kw)


class Engine:
    """Backend-dispatched range-aggregate query engine: a thin shim binding
    (backend, min_bucket) onto the module-level ``execute_*`` functions —
    the same path the ``repro_torch.api`` session facade uses."""

    def __init__(self, backend: Optional[str] = None, min_bucket: int = 64):
        if backend is not None:
            _check_backend(backend)
        check_pow2("min_bucket", min_bucket)
        self.backend = backend
        self.min_bucket = min_bucket

    def _kw(self, eps_rel):
        return dict(backend=self.backend, eps_rel=eps_rel,
                    min_bucket=self.min_bucket)

    def sum(self, plan: IndexPlan, lq, uq,
            eps_rel: Optional[float] = None) -> QueryResult:
        return execute_sum(plan, lq, uq, **self._kw(eps_rel))

    count = sum   # COUNT is SUM over unit measures

    def quantile(self, plan: IndexPlan, q) -> QuantileResult:
        return execute_quantile(plan, q, backend=self.backend,
                                min_bucket=self.min_bucket)

    def extremum(self, plan: IndexPlan, lq, uq,
                 eps_rel: Optional[float] = None) -> QueryResult:
        return execute_extremum(plan, lq, uq, **self._kw(eps_rel))

    def count2d(self, plan: IndexPlan2D, lx, ux, ly, uy,
                eps_rel: Optional[float] = None) -> QueryResult:
        return execute_count2d(plan, lx, ux, ly, uy, **self._kw(eps_rel))

    def sum2d(self, plan: IndexPlan2D, lx, ux, ly, uy,
              eps_rel: Optional[float] = None) -> QueryResult:
        return execute_sum2d(plan, lx, ux, ly, uy, **self._kw(eps_rel))

    def extremum2d(self, plan: IndexPlan2D, u, v,
                   eps_rel: Optional[float] = None) -> QueryResult:
        return execute_extremum2d(plan, u, v, **self._kw(eps_rel))

    def query(self, plan: Union[IndexPlan, IndexPlan2D], *ranges,
              eps_rel: Optional[float] = None) -> QueryResult:
        return execute(plan, ranges, **self._kw(eps_rel))
