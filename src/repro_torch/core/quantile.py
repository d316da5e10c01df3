"""Certified quantile inversion of the fitted cumulative function.

The twin of ``repro.core.quantile``.  PolyFit's CF index stores, per
segment I, a polynomial P_I whose minimax residual
``err(I) = max_{k in I} |P_I(k) - F(k)|`` is certified **at the data keys**.
F is monotone non-decreasing (COUNT, or SUM of non-negative measures), so a
rank target t inverts to a key interval using only key-certified facts —
the fitted polynomial is *not* assumed monotone:

* **upper end** — the first segment s whose running-max endpoint value
  satisfies ``P_s(+1) >= t + slack + delta`` has ``F(seg_hi[s]) >= t +
  slack``; within s the suffix ``[u*, 1]`` on which P stays >= ``t + slack
  + err(s)`` (u* = the largest root of P = target) certifies every key it
  holds, so the upper end tightens to the first data key >= u* (a snap
  through the plan's exact key array when present, the segment endpoint
  otherwise).
* **lower end** — segments with running-max endpoint value <= ``t - slack -
  delta`` are cleared wholesale; within the located segment the prefix
  ``[-1, u*)`` on which P stays <= ``t - slack - err(s)`` (u* = the
  smallest root) clears every key it holds.

Location binary-searches the running max of the per-segment endpoint values
P_i(+1) (``boundary_array``), which is sorted.  Roots are closed form for
deg <= 3 (the solvers of ``core.queries``, which kernel K3 also follows)
and a fixed-iteration safeguarded Newton/bisection otherwise.

Everything here is plain torch on tensors.  It is the plain version of
kernel K4 (``kernels/quantile_invert.py``; ``csrc/quantile.cu`` follows its
order of operations) and the whole of the ``torch`` and ``ref`` backends
and of the dynamic quantile path.
"""
from __future__ import annotations

from typing import Optional

import torch

from .poly import horner, horner_fma
from .queries import _roots_cubic, _roots_linear, _roots_quadratic

__all__ = [
    "COUNT_RANK_SLACK", "boundary_array", "certified_quantile",
    "certified_quantile_shifted", "invert_cf", "rank_slack",
]

#: rank-unit slack for COUNT tables: absorbs every numpy.quantile
#: interpolation convention (linear/lower/higher all live within one rank
#: unit of q*N; the extra unit covers the inclusive-CF off-by-one).
COUNT_RANK_SLACK = 2.0

_NEWTON_ITERS = 40


def rank_slack(agg: str, total: torch.Tensor) -> torch.Tensor:
    """Soundness margin added to rank targets before certification.

    COUNT ranks are integers — 2 rank units dominate every interpolation
    convention.  SUM ranks are continuous — a relative margin well above
    the float64 validity tolerance (1e-9 per lane) suffices.
    """
    total = torch.as_tensor(total)
    if agg == "count":
        return torch.full((), COUNT_RANK_SLACK, dtype=total.dtype,
                          device=total.device)
    return 1e-7 * (torch.abs(total) + 1.0)


def boundary_array(coeffs: torch.Tensor) -> torch.Tensor:
    """``B[i] = max_{j<=i} P_j(+1)`` — running max of segment endpoint CF
    values.  Sorted by construction; zero-coefficient padding rows evaluate
    to 0 and sit at the tail, where the running max has already saturated.
    """
    ones = torch.ones(coeffs.shape[0], dtype=coeffs.dtype,
                      device=coeffs.device)
    return torch.cummax(horner(coeffs, ones), dim=0).values


def _newton_root(c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """One root of P(u) = t on [-1, 1], safeguarded Newton + bisection.

    Fixed iteration count; when no sign change exists on the interval the
    result is rejected downstream by the root validity mask.  P and P' are
    evaluated with ``horner_fma``: the reference's Horner runs with fused
    multiply-adds (XLA on the CPU contracts them), and the 40 steps
    amplify a one-ulp difference into a different root.
    """
    dc = torch.stack([c[..., j] * float(j) for j in range(1, c.shape[-1])],
                     dim=-1)
    a = torch.full_like(t, -1.0)
    b = torch.ones_like(t)
    fa = horner_fma(c, a) - t
    u = 0.5 * (a + b)
    for _ in range(_NEWTON_ITERS):
        fu = horner_fma(c, u) - t
        same = (fu > 0) == (fa > 0)
        a = torch.where(same, u, a)
        fa = torch.where(same, fu, fa)
        b = torch.where(same, b, u)
        du = horner_fma(dc, u)
        step = u - fu / torch.where(du == 0, 1.0, du)
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        bad = (du == 0) | ~torch.isfinite(step) | (step <= lo) | (step >= hi)
        u = torch.where(bad, 0.5 * (a + b), step)
    return u


def _unit_roots(c: torch.Tensor, t: torch.Tensor):
    """Real roots of P(u) = t, nan-padded; closed form through deg 3."""
    deg = c.shape[-1] - 1
    if deg <= 1:
        return (_roots_linear(c[..., 0] - t, c[..., 1]),)
    if deg == 2:
        return _roots_quadratic(c[..., 0] - t, c[..., 1], c[..., 2])
    if deg == 3:
        return _roots_cubic(c[..., 0] - t, c[..., 1], c[..., 2], c[..., 3])
    return (_newton_root(c, t),)


def _extreme_root(c: torch.Tensor, T: torch.Tensor, which: str):
    """(root, found): largest/smallest real root of P(u) = T inside [-1, 1].

    No root inside the interval means P - T holds one sign throughout —
    the caller resolves which via an endpoint evaluation.
    """
    sign = 1.0 if which == "max" else -1.0
    best = torch.full_like(T, -torch.inf)
    for r in _unit_roots(c, T):
        valid = torch.isfinite(r) & (torch.abs(r) <= 1.0 + 1e-9)
        best = torch.where(
            valid, torch.maximum(best, sign * torch.clamp(r, -1.0, 1.0)),
            best)
    found = torch.isfinite(best)
    return torch.where(found, sign * best, 0.0), found


def _unscale(u: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Inverse of ``core.poly.scale_unit`` (degenerate span -> lo)."""
    return torch.where(hi > lo, 0.5 * (u * (hi - lo) + lo + hi), lo)


def _count(keys: torch.Tensor, q: torch.Tensor, side: str,
           scan: bool) -> torch.Tensor:
    """searchsorted(keys, q, side): the branch-free binary search, or the
    O(Q*n) one-hot comparison sum (the ``scan`` twin — the summed predicate
    is exactly the bsearch predicate, so indices match), its (Q, n)
    comparison formed a chunk of queries at a time."""
    if scan:
        from ..kernels.ref import _chunked  # lazy: kernels import core

        def part(q):
            cmp = (keys[None, :] <= q[:, None]) if side == "right" else (
                keys[None, :] < q[:, None])
            return torch.sum(cmp, dim=1, dtype=torch.int32)
        return _chunked(part, keys.shape[0], q)
    from ..kernels.locate import bsearch_count  # lazy: kernels import core
    return bsearch_count(keys, q, side=side)


def invert_cf(t: torch.Tensor, side: str, *, B: torch.Tensor,
              seg_lo: torch.Tensor, seg_hi: torch.Tensor,
              coeffs: torch.Tensor, seg_err: torch.Tensor, h: int,
              delta: float, slack, ref_keys: Optional[torch.Tensor] = None,
              n: int = 0, raw: bool = False, scan: bool = False):
    """Certified one-sided inverse of the fitted CF at rank targets ``t``.

    Locates with the *global* delta, then resolves the crossing inside the
    segment against the gathered ``seg_err``.  Returns (x, ok).  side='hi'
    lanes with ok=False have targets above the fitted range and must fall
    back to the domain top.  side='lo' is unconditionally sound against the
    static data; there, ok reports whether the stronger contract "every
    data key <= x has F(key) <= t" holds (ok=False only on the vacuous
    domain-floor fallback), which the dynamic executor needs.
    """
    pad = slack + delta
    # complete real root sets exist closed-form through deg 3; without them
    # the prefix/suffix sign conditions cannot be certified, so deg > 3
    # keeps segment-endpoint granularity
    tight = coeffs.shape[-1] - 1 <= 3
    if side == "hi":
        s = torch.clamp(_count(B, t + pad, "left", scan), max=h - 1)
    else:
        s = torch.clamp(_count(B, t - pad, "right", scan), 0, h - 1)
    lo = seg_lo[s]
    hi = seg_hi[s]
    c = coeffs[s]
    e = seg_err[s]

    if side == "hi":
        # suffix [u*, 1] on which P >= T: every data key it holds has
        # F >= t + slack, so the first key >= u* caps the rank-t crossing;
        # u* = largest root, or -1 when P >= T on all of [-1, 1]
        T = t + (slack + e)
        ok = t + pad <= B[h - 1]
        if raw:                 # uncertified point estimate, no snap
            root, found = _extreme_root(c, T, "max")
            return _unscale(torch.where(found, root, -1.0), lo, hi), ok
        if tight:
            root, found = _extreme_root(c, T, "max")
            x = _unscale(torch.where(found, root, -1.0), lo, hi)
        else:
            x = hi
        if ref_keys is not None:
            k = torch.clamp(_count(ref_keys, x, "left", scan), max=n - 1)
            x = ref_keys[k]
        else:
            x = hi   # segment endpoint key: coarser, still certified
        return x, ok

    # side == 'lo': prefix [-1, u*) on which P <= T clears every key it
    # holds; segments below s were cleared wholesale by the locate.  When
    # the segment-start value already exceeds T nothing inside s clears,
    # and the certified floor is the previous segment's endpoint key.
    prev = seg_hi[torch.clamp(s - 1, min=0)]
    below = torch.where(s > 0, prev, seg_lo[0])
    if not tight:
        return below, s > 0
    T = t - (slack + e)
    tiny = 1e-9 * (torch.abs(T) + 1.0)
    root, found = _extreme_root(c, T, "min")
    start_ok = horner(c, torch.full_like(t, -1.0)) <= T + tiny
    u = torch.where(found, root, 1.0)
    x = torch.where(start_ok, _unscale(u, lo, hi), below)
    return x, start_ok | (s > 0)


def certified_quantile_shifted(t_mid: torch.Tensor, t_lo: torch.Tensor,
                               t_hi: torch.Tensor, *, seg_lo: torch.Tensor,
                               seg_hi: torch.Tensor, coeffs: torch.Tensor,
                               seg_err: torch.Tensor, h: int, delta: float,
                               B: torch.Tensor,
                               ref_keys: Optional[torch.Tensor] = None,
                               n: int = 0, scan: bool = False):
    """(answer, lower, upper) for slack-pre-shifted rank targets.

    ``t_lo``/``t_hi`` already carry the soundness slack (``rank_slack``) —
    the form kernel K4 consumes.
    """
    args = dict(seg_lo=seg_lo, seg_hi=seg_hi, coeffs=coeffs, h=h, scan=scan)
    x_hi, ok_hi = invert_cf(t_hi, "hi", B=B, seg_err=seg_err, delta=delta,
                            slack=0.0, ref_keys=ref_keys, n=n, **args)
    x_lo, _ = invert_cf(t_lo, "lo", B=B, seg_err=seg_err, delta=delta,
                        slack=0.0, **args)
    dom_hi = seg_hi[h - 1]
    x_hi = torch.where(ok_hi, x_hi, dom_hi)
    zeros = torch.zeros_like(seg_err)
    x_mid, ok_mid = invert_cf(t_mid, "hi", B=B, seg_err=zeros, delta=0.0,
                              slack=0.0, raw=True, **args)
    x_mid = torch.clamp(torch.where(ok_mid, x_mid, dom_hi), x_lo, x_hi)
    return x_mid, x_lo, x_hi


def certified_quantile(t: torch.Tensor, *, slack, **kw):
    """(answer, lower, upper) for rank targets ``t`` (already in CF units).

    [lower, upper] brackets every rank-t crossing of the monotone CF; the
    answer is the raw fitted crossing clipped into the certificate.
    Targets above the fitted range fall back to the fitted domain top.
    """
    return certified_quantile_shifted(t, t - slack, t + slack, **kw)
