"""Shared polynomial/segment primitives for every execution layer.

The twin of ``repro.core.poly``: Horner evaluation, segment location,
Chebyshev scaling and the closed-form clipped polynomial maximum, as plain
torch ops on tensors.  The CUDA kernels (``csrc/polyfit_kernels.cu``) and
the plain paths (``kernels/*.py``, ``kernels/ref.py``, ``core/queries.py``)
all follow the exact order of operations written here — the same ``clip``
order (``min(max(x, lo), hi)``), the same ``where`` guards — so answers
agree bit for bit wherever neither side contracts a multiply-add.

Conventions: coefficients are ascending-power along the last axis; keys are
mapped to u in [-1, 1] over the segment's key span with a clamp (the fit is
certified on the span; F is constant on inter-segment gaps, so clamping is
exact for CF-type functions and prevents extrapolation).
"""
from __future__ import annotations

import torch

__all__ = [
    "horner", "fma", "horner_fma", "locate", "scale_unit", "eval_segments",
    "clipped_poly_max",
]

# Veltkamp's splitter for float64: 2^27 + 1
_SPLIT = 134217729.0


def horner(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """P(u) by Horner's rule; c (..., deg+1) ascending powers, u (...,)."""
    acc = c[..., -1]
    for j in range(c.shape[-1] - 2, -1, -1):
        acc = acc * u + c[..., j]
    return acc


def _split(a: torch.Tensor):
    """Veltkamp split: a = hi + lo exactly, each half 26 bits wide."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded as a fused multiply-add would round it, in plain
    float64 ops (torch has no fused multiply-add).

    Error-free transformations: p = a*b with its exact rounding error e
    (Dekker's product over a Veltkamp split of a and b), the TwoSum
    s + t = p + c, and the result s + (t + e).  XLA on the CPU contracts
    ``a * b + c`` into an FMA, so this is how the port reproduces the
    reference's rounding where it matters (``core.quantile._newton_root``).
    Finite inputs whose product stays below about 1e300 only.
    """
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def horner_fma(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """P(u) by Horner's rule with each step ``fma(acc, u, c_j)``: the
    rounding of the reference's Horner under XLA's multiply-add
    contraction."""
    acc = c[..., -1]
    for j in range(c.shape[-1] - 2, -1, -1):
        acc = fma(acc, u, c[..., j])
    return acc


def locate(q: torch.Tensor, seg_lo: torch.Tensor) -> torch.Tensor:
    """Segment id containing each query key (clamped to the table).

    ``seg_lo`` may be tile-padded with a huge sentinel: in-domain queries
    never resolve to padding because the sentinel exceeds every key.
    """
    idx = torch.searchsorted(seg_lo, q, right=True) - 1
    return torch.clamp(idx, 0, seg_lo.shape[0] - 1)


def scale_unit(q: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Map keys to u in [-1, 1] over [lo, hi], clamped (degenerate span -> lo)."""
    span = torch.where(hi > lo, hi - lo, 1.0)
    return torch.clamp((2.0 * q - lo - hi) / span, -1.0, 1.0)


def eval_segments(q: torch.Tensor, seg_lo: torch.Tensor, seg_hi: torch.Tensor,
                  coeffs: torch.Tensor) -> torch.Tensor:
    """P_{I(q)}(q): locate each key's segment and evaluate its polynomial."""
    idx = locate(q, seg_lo)
    u = scale_unit(q, seg_lo[idx], seg_hi[idx])
    return horner(coeffs[idx], u)


def clipped_poly_max(c: torch.Tensor, slo: torch.Tensor, shi: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max_{k in [a, b]} P(u(k)) per row, closed form for deg <= 3.

    Candidates are both (clamped) endpoints plus the real zero-derivative
    points inside the interval (paper Table 2: P' is linear/quadratic for
    deg 2/3, the recommended MAX degrees).  Empty intervals (a > b) give
    -inf.  c is (..., deg+1); slo/shi the segment's scaling span.

    deg >= 4 needs the cubic-root solver in ``core.queries`` — this helper
    is shared with the range-MAX kernel, whose closed forms stop at deg 3.
    """
    deg = c.shape[-1] - 1
    ua = scale_unit(a, slo, shi)
    ub = scale_unit(b, slo, shi)
    best = torch.maximum(horner(c, ua), horner(c, ub))
    if deg >= 2:
        c1 = c[..., 1]
        c2 = 2.0 * c[..., 2]
        lin = torch.where(torch.abs(c2) > 0,
                          -c1 / torch.where(c2 == 0, 1.0, c2), ua)
        if deg == 2:
            roots = [lin]
        else:  # deg == 3: P' = c1 + 2 c2 u + 3 c3 u^2
            c3 = 3.0 * c[..., 3]
            disc = c2 * c2 - 4.0 * c3 * c1
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            den = torch.where(torch.abs(c3) > 0, 2.0 * c3, 1.0)
            quad_ok = (torch.abs(c3) > 0) & (disc >= 0)
            roots = [torch.where(quad_ok, (-c2 - sq) / den, lin),
                     torch.where(quad_ok, (-c2 + sq) / den, lin)]
        for r in roots:
            best = torch.maximum(best, horner(c, torch.clamp(r, ua, ub)))
    return torch.where(a <= b, best, -torch.inf)
