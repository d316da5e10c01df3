"""Range MAX query evaluation (paper Eq. 17), and kernel K3.

The twin of ``repro.kernels.range_max`` (locate->gather part): both
boundary segments are located with the branch-free binary search, their
coefficient rows gathered, their clipped maxima taken in closed form
(``core.poly.clipped_poly_max``, deg <= 3 — the paper's recommended MAX
range), and the strictly-interior span (il, iu) is answered in O(1) with
two gathers against the plan's per-segment sparse table.  MIN is served on
negated aggregates by the caller.

``range_max_gather_plain`` is the plain torch version; ``range_max_gather``
is the wrapper over K3 (``csrc/polyfit_kernels.cu``,
``range_max_gather_kernel``), the twin of ``range_max_gather_pallas``.
The one-hot scan twin (``range_max_pallas``) comes with the ``cuda_scan``
backend (ROADMAP Queue 2, K15).
"""
from __future__ import annotations

import torch

from ..core.poly import clipped_poly_max
from . import _build
from .locate import locate_segments, rmq_gather

__all__ = ["range_max_gather_plain", "range_max_gather"]


def range_max_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, st):
    """Plain torch version of K3, in the kernel's order of operations."""
    il = locate_segments(seg_lo, lq)
    iu = locate_segments(seg_lo, uq)
    lo_l, hi_l = seg_lo[il], seg_hi[il]
    lo_u, hi_u = seg_lo[iu], seg_hi[iu]
    same = il == iu
    # left boundary: [lq, min(hi_l, uq)], suppressed when lq past hi_l
    m_left = clipped_poly_max(coeffs[il], lo_l, hi_l, lq,
                              torch.minimum(hi_l, uq))
    m_left = torch.where(lq <= hi_l, m_left, -torch.inf)
    # right boundary: [max(lo_u, lq), uq], suppressed when same segment
    m_right = clipped_poly_max(coeffs[iu], lo_u, hi_u,
                               torch.maximum(lo_u, lq), uq)
    m_right = torch.where(same, -torch.inf, m_right)
    # interior segments are exactly (il, iu): seg_lo[j] > lq <=> j > il and
    # seg_next[j] <= uq <=> j < iu — an O(1) sparse-table range max
    m_int = rmq_gather(st, il + 1, iu)
    return torch.maximum(torch.maximum(m_left, m_right), m_int)


def range_max_gather(lq, uq, seg_lo, seg_hi, coeffs, st):
    """(Q,) approximate MAX over [lq, uq]; ``st`` is the plan's (L, h)
    sparse table over per-segment aggregates (unpadded — in-domain queries
    never locate the sentinel tail).  K3 on CUDA tensors, the plain version
    on CPU tensors.  ``range_max_gather.launches`` counts the launches."""
    deg = coeffs.shape[1] - 1
    if deg > 3:
        raise ValueError("range_max_gather: the closed forms cover deg <= 3 "
                         f"(the paper's MAX range), got deg {deg}")
    if lq.device.type == "cpu":
        return range_max_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, st)
    _build.require_cuda("range_max_gather", lq, uq, seg_lo, seg_hi, coeffs, st)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if (uq.shape[0] != Q or seg_hi.shape[0] != H or coeffs.shape[0] != H
            or H < 1 or st.dim() != 2 or st.shape[1] < 1):
        raise ValueError("range_max_gather: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_hi.shape} {coeffs.shape} {st.shape}")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        _build.check(_build.library().polyfit_range_max_gather(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_hi.data_ptr(), coeffs.data_ptr(), st.data_ptr(),
            out.data_ptr(), Q, H, deg, st.shape[1],
            _build.stream(lq.device)), "range_max_gather")
        range_max_gather.launches += 1
    return out


range_max_gather.launches = 0
