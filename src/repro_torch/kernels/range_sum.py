"""Range SUM/COUNT query evaluation (paper Eq. 14): kernels K2 and K14.

The twin of ``repro.kernels.range_sum``.  Both kernels evaluate
A = P_{I(u)}(u) - P_{I(l)}(l) per (lq, uq] range from one gathered
(deg+1)-coefficient row plus the segment's lo and hi, by Horner at the
scaled coordinate; they differ in how they find the segment:

* **gather** (K2, ``range_sum_gather``, twin of ``range_sum_gather_pallas``,
  the ``cuda`` backend): the branch-free binary search, O(log H) a query
  (the kernel: a thread an endpoint, by a descent of seg_lo's search tree,
  which counts the same);
* **scan** (K14, ``range_sum``, twin of ``range_sum_pallas``, the
  ``cuda_scan`` backend): one-hot membership seg_lo <= q < seg_next
  against every segment, O(H) a query.  At most one segment holds a
  clamped query, so the reference's one-hot matmul reads one row: the
  scan keeps the first segment that holds the query, and a zero row where
  none does (``segment_rows``; the kernel counts #(seg_lo <= q) against
  every live segment instead, whose last is the row on a plan's table).

Both read the same rows, so on in-domain queries they agree bit for bit.
``*_plain`` are the plain torch versions, in the kernels' order of
operations; the wrappers launch their kernels (``csrc/polyfit_kernels.cu``
for K2, ``csrc/scan1d.cu`` for K14) on CUDA tensors and run the plain
versions on CPU tensors.  Both kernels take float64 tables (the engine's)
and float32 ones (``kernels/ops.py``'s default): the wrapper picks the
instantiation by ``coeffs.dtype`` and every argument must share it.
"""
from __future__ import annotations

import torch

from ..core.poly import horner, scale_unit
from . import _build
from .locate import check_tree_shape, locate_segments, search_tree
from .ref import _chunked

__all__ = ["range_sum_gather_plain", "range_sum_gather", "segment_rows",
           "gather_rows", "range_sum_plain", "range_sum"]


def range_sum_gather_plain(lq, uq, seg_lo, seg_hi, coeffs, tree=None):
    """Plain torch version of K2, in the kernel's order of operations (it
    takes K2's arguments; the binary search needs no ``tree``)."""
    vals = []
    for q in (lq, uq):
        idx = locate_segments(seg_lo, q)                   # O(log H)
        u = scale_unit(q, seg_lo[idx], seg_hi[idx])
        vals.append(horner(coeffs[idx], u))
    return vals[1] - vals[0]


def range_sum_gather(lq, uq, seg_lo, seg_hi, coeffs, tree=None):
    """(Q,) approximate SUM over (lq, uq] against a (sentinel-padded)
    segment table: K2 on CUDA tensors, the plain version on CPU tensors.
    ``range_sum_gather.launches`` counts the kernel launches.

    K2 runs two threads a query, one an endpoint, at one instantiation a
    degree 0-8 (one runtime-degree form above them).  Each finds its
    segment by a descent of ``tree``, seg_lo's ``search_tree`` (a plan's
    ``seg_tree``; a call without one builds it), and reads its row by
    16-byte loads where its length allows: ``seg_lo``, ``coeffs`` and
    ``tree`` must start on 16 bytes, as a plan's own tables do.  It raises
    on a tree whose shape is not that of the tree of H starts; a tree of
    other starts of the same count passes unseen."""
    if lq.device.type == "cpu":
        return range_sum_gather_plain(lq, uq, seg_lo, seg_hi, coeffs)
    dtype = _build.float_dtype("range_sum_gather", coeffs)
    if tree is None:
        tree = search_tree(seg_lo)
    _build.require_cuda("range_sum_gather", lq, uq, seg_lo, seg_hi, coeffs,
                        tree, dtype=dtype)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if uq.shape[0] != Q or seg_hi.shape[0] != H or coeffs.shape[0] != H or H < 1:
        raise ValueError("range_sum_gather: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_hi.shape} {coeffs.shape}")
    check_tree_shape("range_sum_gather", tree, H)
    if any(t.data_ptr() % 16 for t in (seg_lo, coeffs, tree)):
        raise ValueError("range_sum_gather: seg_lo, coeffs and tree must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "16 bytes at a time); pass a copy (.clone()) of an "
                         "offset view")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        _build.check(_build.launcher("range_sum_gather", dtype)(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_hi.data_ptr(), coeffs.data_ptr(), tree.data_ptr(),
            out.data_ptr(), Q, H, coeffs.shape[1] - 1,
            _build.stream(lq.device)), "range_sum_gather")
        range_sum_gather.launches += 1
    return out


range_sum_gather.launches = 0


# ---------------------------------------------------------------------------
# the one-hot scan: K14
# ---------------------------------------------------------------------------

def segment_rows(q, seg_lo, seg_next):
    """The first segment with seg_lo <= q < seg_next for each query, -1
    where none holds it — the (Q, H) membership compared a chunk of queries
    at a time."""
    def part(x):
        m = (seg_lo[None, :] <= x[:, None]) & (x[:, None] < seg_next[None, :])
        return torch.where(m.any(dim=1), m.to(torch.uint8).argmax(dim=1), -1)
    return _chunked(part, seg_lo.shape[0], q)


def gather_rows(row, *tables):
    """Each table's row ``row``, zeros where ``row`` is -1."""
    hit = row >= 0
    idx = torch.clamp(row, min=0)
    return [torch.where(hit.reshape(-1, *([1] * (t.dim() - 1))), t[idx], 0.0)
            for t in tables]


def range_sum_plain(lq, uq, seg_lo, seg_next, seg_hi, coeffs):
    """Plain torch version of K14, in the kernel's order of operations."""
    vals = []
    for q in (lq, uq):
        c, lo, hi = gather_rows(segment_rows(q, seg_lo, seg_next), coeffs,
                                seg_lo, seg_hi)                  # O(H)
        vals.append(horner(c, scale_unit(q, lo, hi)))
    return vals[1] - vals[0]


def range_sum(lq, uq, seg_lo, seg_next, seg_hi, coeffs):
    """(Q,) approximate SUM over (lq, uq] by one-hot membership against a
    (sentinel-padded) segment table: K14 on CUDA tensors, the plain version
    on CPU tensors.  ``range_sum.launches`` counts the kernel launches.

    K14 takes a plan's layout as given (``engine.plan.build_plan``):
    ``seg_lo`` non-decreasing and below the sentinel but for the padded
    tail, ``seg_next[j] == seg_lo[j + 1]`` with the sentinel last, no NaN.
    It counts #(seg_lo <= q) for each endpoint, stops at the first tile of
    the table that starts on the sentinel, and takes the last segment with
    seg_lo <= q where q lies below its next start: on that layout the
    one-hot first hit.  The plain version tests membership against every
    entry of any table."""
    if lq.device.type == "cpu":
        return range_sum_plain(lq, uq, seg_lo, seg_next, seg_hi, coeffs)
    dtype = _build.float_dtype("range_sum", coeffs)
    _build.require_cuda("range_sum", lq, uq, seg_lo, seg_next, seg_hi, coeffs,
                        dtype=dtype)
    Q, H = lq.shape[0], seg_lo.shape[0]
    if (uq.shape[0] != Q or seg_next.shape[0] != H or seg_hi.shape[0] != H
            or coeffs.shape[0] != H or H < 1):
        raise ValueError("range_sum: shape mismatch "
                         f"{lq.shape} {uq.shape} {seg_lo.shape} "
                         f"{seg_next.shape} {seg_hi.shape} {coeffs.shape}")
    out = torch.empty(Q, dtype=coeffs.dtype, device=lq.device)
    if Q:
        _build.check(_build.launcher("range_sum", dtype)(
            lq.data_ptr(), uq.data_ptr(), seg_lo.data_ptr(),
            seg_next.data_ptr(), seg_hi.data_ptr(), coeffs.data_ptr(),
            out.data_ptr(), Q, H, coeffs.shape[1] - 1,
            _build.sentinel(dtype), _build.stream(lq.device)), "range_sum")
        range_sum.launches += 1
    return out


range_sum.launches = 0
