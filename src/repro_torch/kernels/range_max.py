"""Range MAX query evaluation (paper Eq. 17): kernels K3 and K15.

The twin of ``repro.kernels.range_max``.  Both kernels take the clipped
maxima of the two boundary segments in closed form
(``core.poly.clipped_poly_max``, deg <= 3 — the paper's recommended MAX
range) and the max of the per-segment aggregates strictly between them;
MIN is served on negated aggregates by the caller.

* **gather** (K3, ``range_max_gather``, twin of ``range_max_gather_pallas``,
  the ``cuda`` backend): both boundary segments located with the
  branch-free binary search (the kernel: a thread each, by a descent of
  seg_lo's search tree, which counts the same), the interior span (il, iu)
  answered in O(1) with two gathers against the plan's per-segment sparse
  table;
* **scan** (K15, ``range_max``, twin of ``range_max_pallas``, the
  ``cuda_scan`` backend): both boundary rows by one-hot membership
  (``range_sum.segment_rows``; the kernel counts #(seg_lo <= q) against
  every segment instead, whose last is the row on a plan's table), the
  same-segment test on their gathered lo and hi, and a dense masked max of
  ``seg_agg`` over the segments with lo > lq and next <= uq — O(H) a
  query.

The max is exact, so the two agree bit for bit.  ``*_plain`` are the plain
torch versions; the wrappers launch their kernels
(``csrc/polyfit_kernels.cu`` for K3, ``csrc/scan1d.cu`` for K15) on CUDA
tensors and run the plain versions on CPU tensors.  Both kernels take
float64 tables and float32 ones (``kernels/ops.py``'s default), picked by
``coeffs.dtype``; K3 casts the plan's sparse table (kept at the index's
float64) to that type first, as the reference does: the cast rounds each
entry monotonically, so it commutes with the max.
"""
from __future__ import annotations

import torch

from ..core.poly import clipped_poly_max
from . import _build
from .locate import (check_tree_shape, locate_segments, rmq_gather,
                     search_tree)
from .range_sum import gather_rows, segment_rows
from .ref import _chunked

__all__ = ["range_max_gather_plain", "range_max_gather", "range_max_plain",
           "range_max"]


def range_max_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, st, tree=None):
    """Plain torch version of K3, in the kernel's order of operations (it
    takes K3's arguments; the binary search needs no ``tree``)."""
    st = st.to(coeffs.dtype)
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


def _check_deg(name, coeffs):
    deg = coeffs.shape[1] - 1
    if deg > 3:
        raise ValueError(f"{name}: the closed forms cover deg <= 3 (the "
                         f"paper's MAX range), got deg {deg}")
    return deg


def range_max_gather(lq, uq, seg_lo, seg_hi, coeffs, st, tree=None):
    """(Q,) approximate MAX over [lq, uq]; ``st`` is the plan's (L, h)
    sparse table over per-segment aggregates (unpadded — in-domain queries
    never locate the sentinel tail).  K3 on CUDA tensors, the plain version
    on CPU tensors.  ``range_max_gather.launches`` counts the launches.

    K3 runs two threads a query, one a boundary segment, at one
    instantiation a degree.  Each finds its segment by a descent of
    ``tree``, seg_lo's ``search_tree`` (a plan's ``seg_tree``; a call
    without one builds it), and reads the rows by 16-byte loads where their
    length allows: ``seg_lo``, ``coeffs`` and ``tree`` must start on 16
    bytes, as a plan's own tables do.  It raises on a tree whose shape is
    not that of the tree of H starts; a tree of other starts of the same
    count passes unseen."""
    deg = _check_deg("range_max_gather", coeffs)
    if lq.device.type == "cpu":
        return range_max_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, st)
    dtype = _build.float_dtype("range_max_gather", coeffs)
    st = st.to(dtype)
    if tree is None:
        tree = search_tree(seg_lo)
    _build.require_cuda("range_max_gather", lq, uq, seg_lo, seg_hi, coeffs, st,
                        tree, dtype=dtype)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if (uq.shape[0] != Q or seg_hi.shape[0] != H or coeffs.shape[0] != H
            or H < 1 or st.dim() != 2 or st.shape[1] < 1):
        raise ValueError("range_max_gather: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_hi.shape} {coeffs.shape} {st.shape}")
    check_tree_shape("range_max_gather", tree, H)
    if any(t.data_ptr() % 16 for t in (seg_lo, coeffs, tree)):
        raise ValueError("range_max_gather: seg_lo, coeffs and tree must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "16 bytes at a time); pass a copy (.clone()) of an "
                         "offset view")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        _build.check(_build.launcher("range_max_gather", dtype)(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_hi.data_ptr(), coeffs.data_ptr(), st.data_ptr(),
            tree.data_ptr(), out.data_ptr(), Q, H, deg, st.shape[1],
            _build.stream(lq.device)), "range_max_gather")
        range_max_gather.launches += 1
    return out


range_max_gather.launches = 0


# ---------------------------------------------------------------------------
# the one-hot scan: K15
# ---------------------------------------------------------------------------

def _interior_max(lq, uq, seg_lo, seg_next, seg_agg):
    """max of seg_agg over the segments with lo > lq and next <= uq (-inf
    where none), the (Q, H) mask formed a chunk of queries at a time."""
    def part(l, u):
        inside = ((seg_lo[None, :] > l[:, None])
                  & (seg_next[None, :] <= u[:, None]))
        return torch.where(inside, seg_agg[None, :], -torch.inf).amax(dim=1)
    return _chunked(part, seg_lo.shape[0], lq, uq)


def range_max_plain(lq, uq, seg_lo, seg_next, seg_hi, coeffs, seg_agg):
    """Plain torch version of K15, in the kernel's order of operations."""
    cl, lo_l, hi_l = gather_rows(segment_rows(lq, seg_lo, seg_next), coeffs,
                                 seg_lo, seg_hi)
    cu, lo_u, hi_u = gather_rows(segment_rows(uq, seg_lo, seg_next), coeffs,
                                 seg_lo, seg_hi)
    same = (lo_l == lo_u) & (hi_l == hi_u)
    # left boundary: [lq, min(hi_l, uq)], suppressed when lq past hi_l
    m_left = clipped_poly_max(cl, lo_l, hi_l, lq, torch.minimum(hi_l, uq))
    m_left = torch.where(lq <= hi_l, m_left, -torch.inf)
    # right boundary: [max(lo_u, lq), uq], suppressed when same segment
    m_right = clipped_poly_max(cu, lo_u, hi_u, torch.maximum(lo_u, lq), uq)
    m_right = torch.where(same, -torch.inf, m_right)
    m_int = _interior_max(lq, uq, seg_lo, seg_next, seg_agg)
    return torch.maximum(torch.maximum(m_left, m_right), m_int)


def range_max(lq, uq, seg_lo, seg_next, seg_hi, coeffs, seg_agg):
    """(Q,) approximate MAX over [lq, uq] by one-hot membership against a
    (sentinel-padded) segment table with its per-segment aggregates
    ``seg_agg`` (-inf padded): K15 on CUDA tensors, the plain version on
    CPU tensors.  ``range_max.launches`` counts the kernel launches.

    K15 takes a plan's layout as given (``engine.plan.build_plan``):
    ``seg_lo`` non-decreasing and below the sentinel but for the padded
    tail, ``seg_next[j] == seg_lo[j + 1]`` with the sentinel last, no NaN.
    It finds each boundary segment from #(seg_lo <= q) and stops at the
    first tile of the table that starts on the sentinel.  The plain
    version tests membership against every entry of any table."""
    deg = _check_deg("range_max", coeffs)
    if lq.device.type == "cpu":
        return range_max_plain(lq, uq, seg_lo, seg_next, seg_hi, coeffs,
                               seg_agg)
    dtype = _build.float_dtype("range_max", coeffs)
    _build.require_cuda("range_max", lq, uq, seg_lo, seg_next, seg_hi, coeffs,
                        seg_agg, dtype=dtype)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if (uq.shape[0] != Q or H < 1 or coeffs.shape[0] != H
            or any(t.shape[0] != H for t in (seg_next, seg_hi, seg_agg))):
        raise ValueError("range_max: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_next.shape} {seg_hi.shape} {coeffs.shape} "
                         f"{seg_agg.shape}")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        # the kernel scans the table in S chunks; a finish kernel combines
        # their boundary counts and interior maxima
        chunks = _build.library().polyfit_range_max_chunks(H)
        cnt = torch.empty((2 * chunks, Q), dtype=torch.int32,
                          device=lq.device)
        part = torch.empty((chunks, Q), dtype=dtype, device=lq.device)
        _build.check(_build.launcher("range_max", dtype)(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_next.data_ptr(), seg_hi.data_ptr(), coeffs.data_ptr(),
            seg_agg.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            part.data_ptr(), Q, H, deg, _build.sentinel(dtype),
            _build.stream(lq.device)), "range_max")
        range_max.launches += 1
    return out


range_max.launches = 0
