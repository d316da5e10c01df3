"""Plain torch oracles with the kernels' array-level semantics (1-D part).

The twin of ``repro.kernels.ref``: the query clamp and the one-hot
membership rule one_hot[q, j] = (seg_lo[j] <= q) & (q < seg_next[j]) of the
scan kernels, with a dense interior reduction for MAX, and the dense
membership oracles of the 1-D delta-buffer corrections.  The engine's
``ref`` backend runs these.  The 2-D oracles come with their slice
(ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import torch

from ..core.poly import clipped_poly_max, eval_segments, locate

__all__ = ["poly_eval_ref", "range_sum_ref", "range_max_ref",
           "delta_sum_ref", "delta_max_ref"]


def poly_eval_ref(q, seg_lo, seg_next, seg_hi, coeffs):
    q = torch.maximum(q, seg_lo[0])
    return eval_segments(q, seg_lo, seg_hi, coeffs)


def range_sum_ref(lq, uq, seg_lo, seg_next, seg_hi, coeffs):
    lq = torch.maximum(lq, seg_lo[0])
    uq = torch.maximum(uq, seg_lo[0])
    return (eval_segments(uq, seg_lo, seg_hi, coeffs)
            - eval_segments(lq, seg_lo, seg_hi, coeffs))


def range_max_ref(lq, uq, seg_lo, seg_next, seg_hi, coeffs, seg_agg):
    lq = torch.maximum(lq, seg_lo[0])
    uq = torch.maximum(uq, seg_lo[0])
    il = locate(lq, seg_lo)
    iu = locate(uq, seg_lo)
    same = il == iu
    m_left = clipped_poly_max(coeffs[il], seg_lo[il], seg_hi[il],
                              lq, torch.minimum(seg_hi[il], uq))
    m_left = torch.where(lq <= seg_hi[il], m_left, -torch.inf)
    m_right = clipped_poly_max(coeffs[iu], seg_lo[iu], seg_hi[iu],
                               torch.maximum(seg_lo[iu], lq), uq)
    m_right = torch.where(same, -torch.inf, m_right)
    interior = ((seg_lo[None, :] > lq[:, None]) &
                (seg_next[None, :] <= uq[:, None]))
    m_mid = torch.where(interior, seg_agg[None, :], -torch.inf).amax(dim=1)
    return torch.maximum(torch.maximum(m_left, m_right), m_mid)


def delta_sum_ref(lq, uq, keys, vals):
    """Exact sum of buffered measures with key in (lq, uq] (delta_scan
    oracle); sentinel-padded slots never satisfy membership."""
    member = ((lq[:, None] < keys[None, :]) &
              (keys[None, :] <= uq[:, None])).to(vals.dtype)
    return member @ vals


def delta_max_ref(lq, uq, keys, vals):
    """Exact max of buffered measures with key in [lq, uq]; -inf if none."""
    member = (lq[:, None] <= keys[None, :]) & (keys[None, :] <= uq[:, None])
    return torch.where(member, vals[None, :], -torch.inf).amax(dim=1)
