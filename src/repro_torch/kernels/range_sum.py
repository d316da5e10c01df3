"""Range SUM/COUNT query evaluation (paper Eq. 14), and kernel K2.

The twin of ``repro.kernels.range_sum`` (locate->gather part): for each
(lq, uq] range, locate both endpoints with the branch-free binary search,
gather one (deg+1)-coefficient row plus the segment's lo and hi, and
evaluate A = P_{I(u)}(u) - P_{I(l)}(l) by Horner at the scaled coordinate.
Per-query work is independent of the table size.

``range_sum_gather_plain`` is the plain torch version; ``range_sum_gather``
is the wrapper over K2 (``csrc/polyfit_kernels.cu``,
``range_sum_gather_kernel``), the twin of ``range_sum_gather_pallas``.
The one-hot scan twin (``range_sum_pallas``) comes with the ``cuda_scan``
backend (ROADMAP Queue 2, K14).
"""
from __future__ import annotations

import torch

from ..core.poly import horner, scale_unit
from . import _build
from .locate import locate_segments

__all__ = ["range_sum_gather_plain", "range_sum_gather"]


def range_sum_gather_plain(lq, uq, seg_lo, seg_hi, coeffs):
    """Plain torch version of K2, in the kernel's order of operations."""
    vals = []
    for q in (lq, uq):
        idx = locate_segments(seg_lo, q)                   # O(log H)
        u = scale_unit(q, seg_lo[idx], seg_hi[idx])
        vals.append(horner(coeffs[idx], u))
    return vals[1] - vals[0]


def range_sum_gather(lq, uq, seg_lo, seg_hi, coeffs):
    """(Q,) approximate SUM over (lq, uq] against a (sentinel-padded)
    segment table: K2 on CUDA tensors, the plain version on CPU tensors.
    ``range_sum_gather.launches`` counts the kernel launches."""
    if lq.device.type == "cpu":
        return range_sum_gather_plain(lq, uq, seg_lo, seg_hi, coeffs)
    _build.require_cuda("range_sum_gather", lq, uq, seg_lo, seg_hi, coeffs)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if uq.shape[0] != Q or seg_hi.shape[0] != H or coeffs.shape[0] != H or H < 1:
        raise ValueError("range_sum_gather: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_hi.shape} {coeffs.shape}")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        _build.check(_build.library().polyfit_range_sum_gather(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_hi.data_ptr(), coeffs.data_ptr(), out.data_ptr(), Q, H,
            coeffs.shape[1] - 1, _build.stream(lq.device)),
            "range_sum_gather")
        range_sum_gather.launches += 1
    return out


range_sum_gather.launches = 0
