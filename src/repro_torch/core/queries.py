"""Approximate range-aggregate query evaluation (paper §5), batched in torch.

The twin of ``repro.core.queries``:

SUM/COUNT (Alg. 2):   A = P_Iu(uq) - P_Il(lq)                       (Eq. 14)
MAX/MIN   (Alg. 3):   A = max(boundary polynomial extrema,
                              interior per-segment exact aggregates)  (Eq. 17)

Guarantees:
* Q_abs — build with delta = eps_abs/2 (SUM, Lemma 5.1) or delta = eps_abs
  (MAX, Lemma 5.3); the raw approximate answer already satisfies the bound.
* Q_rel — test Lemma 5.2 (SUM: 2*delta/(A-2*delta) <= eps_rel) or Lemma 5.4
  (MAX: A >= delta*(1+1/eps_rel)); failing queries are refined against the
  exact structures and merged with ``torch.where``.

Boundary extrema use closed-form zero-derivative points (Table 2 of the
paper) for deg <= 4, and a Chebyshev-grid + Newton fallback for deg >= 5.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import DTYPE
from .exact import sparse_table_range_max
from .index import PolyFitIndex1D
from .poly import horner as _horner, locate, scale_unit

__all__ = [
    "query_sum", "query_max", "QueryResult",
    "poly_max_on_interval", "solve_derivative_roots", "max_eval_segments",
]

_NAN = math.nan


class QueryResult(NamedTuple):
    answer: torch.Tensor     # final (possibly refined) answers
    approx: torch.Tensor     # raw index-only answers
    refined: torch.Tensor    # bool: True where refinement was triggered


# ---------------------------------------------------------------------------
# closed-form real roots of low-degree polynomials (branch-free, nan-padded)
# ---------------------------------------------------------------------------

def _roots_linear(b, a):
    """a*u + b = 0 -> 1 root (nan if degenerate)."""
    return torch.where(torch.abs(a) > 0, -b / torch.where(a == 0, 1.0, a), _NAN)


def _roots_quadratic(c, b, a):
    """a u^2 + b u + c = 0 -> 2 roots (nan-padded)."""
    lin = _roots_linear(c, b)
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    denom = torch.where(a == 0, 1.0, 2 * a)
    r1 = (-b - sq) / denom
    r2 = (-b + sq) / denom
    quad_ok = (torch.abs(a) > 0) & (disc >= 0)
    r1 = torch.where(quad_ok, r1, torch.where(torch.abs(a) > 0, _NAN, lin))
    r2 = torch.where(quad_ok, r2, _NAN)
    return r1, r2


def _roots_cubic(d, c, b, a):
    """a u^3 + b u^2 + c u + d = 0 -> 3 real roots (nan-padded).

    Trigonometric/Cardano method, branch-free.  Falls back to the quadratic
    solver when a == 0.
    """
    q1, q2 = _roots_quadratic(d, c, b)
    safe_a = torch.where(torch.abs(a) > 0, a, 1.0)
    # depressed cubic t^3 + p t + q, u = t - b/(3a)
    shift = b / (3 * safe_a)
    p = (3 * safe_a * c - b * b) / (3 * safe_a * safe_a)
    # cubes as explicit products, so a CUDA twin needs no pow; divisions by
    # a constant as multiplies by its reciprocal, which is how torch divides
    # by a Python scalar on the card: written out, the CPU, the card and a
    # CUDA twin round alike
    q = ((2 * (b * b * b) - 9 * safe_a * b * c + 27 * safe_a * safe_a * d)
         / (27 * (safe_a * safe_a * safe_a)))
    disc = (q * q) * 0.25 + (p * p * p) * (1.0 / 27)
    # three-real-root branch (disc <= 0): trigonometric
    pm = torch.clamp(p, max=-1e-300)
    m = 2 * torch.sqrt(-pm * (1.0 / 3))
    arg = torch.clamp(3 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(arg) * (1.0 / 3)
    t0 = m * torch.cos(theta)
    t1 = m * torch.cos(theta - 2 * math.pi / 3)
    t2 = m * torch.cos(theta - 4 * math.pi / 3)
    # one-real-root branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    cbrt = lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)
    t_single = cbrt(-q / 2 + sq) + cbrt(-q / 2 - sq)
    three = disc <= 0
    r0 = torch.where(three, t0, t_single) - shift
    r1_ = torch.where(three, t1, _NAN) - shift
    r2_ = torch.where(three, t2, _NAN) - shift
    is_cubic = torch.abs(a) > 0
    return (torch.where(is_cubic, r0, q1),
            torch.where(is_cubic, r1_, q2),
            torch.where(is_cubic, r2_, _NAN))


def solve_derivative_roots(coeffs: torch.Tensor) -> torch.Tensor:
    """Real roots of P'(u) for batched coeffs (..., deg+1) -> (..., R).

    deg<=4 is closed-form (paper Table 2); deg>=5 raises (use the grid path).
    """
    deg = coeffs.shape[-1] - 1
    c = [coeffs[..., j] for j in range(deg + 1)]
    if deg <= 1:
        return torch.full(coeffs.shape[:-1] + (1,), _NAN, dtype=coeffs.dtype,
                          device=coeffs.device)
    if deg == 2:
        return _roots_linear(c[1], 2 * c[2])[..., None]
    if deg == 3:
        r1, r2 = _roots_quadratic(c[1], 2 * c[2], 3 * c[3])
        return torch.stack([r1, r2], dim=-1)
    if deg == 4:
        r0, r1, r2 = _roots_cubic(c[1], 2 * c[2], 3 * c[3], 4 * c[4])
        return torch.stack([r0, r1, r2], dim=-1)
    raise NotImplementedError("closed-form extrema only for deg<=4; "
                              "use grid_extrema for higher degrees")


def poly_max_on_interval(coeffs, ua, ub, grid_pts: int = 0):
    """max_{u in [ua, ub]} P(u), batched; empty intervals (ua>ub) -> -inf.

    Candidates: both endpoints + real zero-derivative points inside the
    interval (closed form for deg<=4) [+ Chebyshev grid for deg>=5].
    """
    deg = coeffs.shape[-1] - 1
    vals = [_horner(coeffs, ua), _horner(coeffs, ub)]
    if deg >= 2:
        if deg <= 4:
            roots = solve_derivative_roots(coeffs)
        else:
            # Chebyshev grid + one Newton step toward P'=0
            g = grid_pts or 32
            ar = lambda k: torch.arange(k, dtype=coeffs.dtype,
                                        device=coeffs.device)
            t = torch.cos(math.pi * (ar(g) + 0.5) / g)
            grid = ua[..., None] + (ub - ua)[..., None] * (t + 1) / 2
            dcoef = coeffs[..., 1:] * ar(deg + 1)[1:]
            d2coef = dcoef[..., 1:] * ar(deg)[1:]
            d1 = _horner(dcoef[..., None, :], grid)
            d2 = _horner(d2coef[..., None, :], grid)
            roots = grid - d1 / torch.where(torch.abs(d2) > 1e-12, d2, 1.0)
        roots = torch.clamp(roots, ua[..., None], ub[..., None])
        roots = torch.where(torch.isnan(roots), ua[..., None], roots)
        vals.append(_horner(coeffs[..., None, :], roots).amax(dim=-1))
    out = torch.stack(vals, dim=-1).amax(dim=-1)
    return torch.where(ua <= ub, out, -torch.inf)


# ---------------------------------------------------------------------------
# SUM / COUNT (Alg. 2)
# ---------------------------------------------------------------------------

def _as_query(q, index: PolyFitIndex1D) -> torch.Tensor:
    return torch.as_tensor(q, dtype=DTYPE, device=index.seg_lo.device)


def query_sum(index: PolyFitIndex1D, lq, uq,
              eps_rel: float | None = None) -> QueryResult:
    """Approximate R_sum(D, (lq, uq]) (Eq. 14) with optional Q_rel refinement.

    With eps_rel=None this is the Q_abs path: |A - R| <= 2*delta.
    """
    if index.agg not in ("sum", "count"):
        raise ValueError(f"query_sum needs a sum/count index, got {index.agg}")
    lq, uq = _as_query(lq, index), _as_query(uq, index)
    approx = index.eval_at(uq) - index.eval_at(lq)
    if eps_rel is None:
        return QueryResult(approx, approx, torch.zeros_like(approx, dtype=torch.bool))
    # Lemma 5.2 test: 2d / (A - 2d) <= eps_rel  (requires A > 2d)
    two_d = 2.0 * index.delta
    ok = ((approx - two_d > 0)
          & (two_d / torch.clamp(approx - two_d, min=1e-300) <= eps_rel))
    exact = index.exact_sum
    if exact is None:
        raise ValueError("Q_rel refinement requires keep_exact=True")
    truth = exact.cf_at(uq) - exact.cf_at(lq)
    return QueryResult(torch.where(ok, approx, truth), approx, ~ok)


# ---------------------------------------------------------------------------
# MAX / MIN (Alg. 3)
# ---------------------------------------------------------------------------

def max_eval_segments(seg_lo, seg_hi, coeffs, st, lq, uq):
    """Raw approximate MAX (Eq. 17) over flat segment arrays.

    Shared by ``query_max`` (index objects) and the engine's ``torch``
    backend (tile-padded plan arrays): padded segments carry a huge seg_lo
    sentinel, which in-domain queries never locate, and ``st`` stays
    unpadded at the true segment count.
    """
    il = locate(lq, seg_lo)
    iu = locate(uq, seg_lo)
    lo_l, hi_l = seg_lo[il], seg_hi[il]
    lo_u, hi_u = seg_lo[iu], seg_hi[iu]

    same = il == iu
    # left boundary segment: [lq, min(hi_l, uq)]
    ua_l = scale_unit(lq, lo_l, hi_l)
    ub_l = scale_unit(torch.minimum(hi_l, uq), lo_l, hi_l)
    m_left = poly_max_on_interval(coeffs[il], ua_l, ub_l)
    # lq may fall in the key-free gap past the segment's last key: no data of
    # segment il is inside the query range then — suppress its contribution
    m_left = torch.where(lq <= hi_l, m_left, -torch.inf)
    # right boundary segment: [max(lo_u, lq), uq] — suppressed when same seg
    ua_u = scale_unit(torch.maximum(lo_u, lq), lo_u, hi_u)
    ub_u = scale_unit(uq, lo_u, hi_u)
    m_right = torch.where(same, -torch.inf,
                          poly_max_on_interval(coeffs[iu], ua_u, ub_u))
    # interior fully-covered segments: exact per-segment aggregates via the
    # sparse table
    m_mid = sparse_table_range_max(st, il + 1, iu)
    return torch.maximum(torch.maximum(m_left, m_right), m_mid)


def query_max(index: PolyFitIndex1D, lq, uq,
              eps_rel: float | None = None) -> QueryResult:
    """Approximate R_max(D, [lq, uq]) (Eq. 17) with optional Q_rel refinement.

    Q_abs: build with delta = eps_abs (Lemma 5.3).  MIN queries reuse the MAX
    machinery on negated measures; answers are negated back here.
    """
    if index.agg not in ("max", "min"):
        raise ValueError(f"query_max needs a max/min index, got {index.agg}")
    neg = index.agg == "min"
    lq, uq = _as_query(lq, index), _as_query(uq, index)
    approx = max_eval_segments(index.seg_lo, index.seg_hi, index.coeffs,
                               index.st, lq, uq)
    if eps_rel is None:
        out = -approx if neg else approx
        return QueryResult(out, out, torch.zeros_like(out, dtype=torch.bool))
    # Lemma 5.4 test: A >= delta * (1 + 1/eps_rel)
    ok = approx >= index.delta * (1.0 + 1.0 / eps_rel)
    exact = index.exact_max
    if exact is None:
        raise ValueError("Q_rel refinement requires keep_exact=True")
    ans = torch.where(ok, approx, exact.query(lq, uq))
    if neg:
        ans = -ans
    return QueryResult(ans, -approx if neg else approx, ~ok)
