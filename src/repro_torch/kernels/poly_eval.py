"""Fused segment resolve + Horner evaluation: kernel K21.

The twin of ``repro.kernels.poly_eval``: P_{I(q)}(q) for a batch of keys
against a (sentinel-padded) segment table, the one-endpoint step of the
range SUM kernels.  The reference resolves each key's segment by one-hot
membership seg_lo <= q < seg_next over tiles of segments and gathers the
row with a matmul; at most one segment holds a key clamped to seg_lo[0]
(padding is finite), so the matmul reads one row, and the kernel keeps the
first segment that holds the key and a zero row where none does, as K14
(``range_sum.range_sum``) does for each of its two endpoints.

``poly_eval_plain`` is the plain torch version, in the kernel's order of
operations (``range_sum.segment_rows`` and ``gather_rows``, then
``core.poly.horner`` at ``scale_unit``); the wrapper ``poly_eval`` launches
K21 (``csrc/scan1d.cu``, float64 or float32 by ``coeffs.dtype``) on CUDA
tensors and runs the plain version on CPU tensors.  ``kernels/ops.py`` is
its caller.
"""
from __future__ import annotations

import torch

from ..core.poly import horner, scale_unit
from . import _build
from .locate import check_tree_shape, search_tree
from .range_sum import gather_rows, segment_rows

__all__ = ["poly_eval_plain", "poly_eval"]


def poly_eval_plain(q, seg_lo, seg_next, seg_hi, coeffs, tree=None):
    """Plain torch version of K21, in the kernel's order of operations (it
    takes K21's arguments; the one-hot membership needs no ``tree``)."""
    c, lo, hi = gather_rows(segment_rows(q, seg_lo, seg_next), coeffs,
                            seg_lo, seg_hi)                      # O(H)
    return horner(c, scale_unit(q, lo, hi))


def poly_eval(q, seg_lo, seg_next, seg_hi, coeffs, tree=None):
    """(Q,) P_{I(q)}(q) against a (sentinel-padded) segment table: K21 on
    CUDA tensors, the plain version on CPU tensors.
    ``poly_eval.launches`` counts the kernel launches.

    K21 takes a plan's layout as given (``engine.plan.build_plan``):
    ``seg_lo`` non-decreasing and below the sentinel but for the padded
    tail, ``seg_next[j] == seg_lo[j + 1]`` with the sentinel last, no NaN.
    One thread a key counts #(seg_lo <= q) by a descent of ``tree``,
    seg_lo's ``search_tree`` (a plan's ``seg_tree``; a call without one
    builds it), and takes the last segment with seg_lo <= q where q lies
    below its next start: on that layout the one-hot first hit.  It runs
    at one instantiation a degree 0-8 (one runtime-degree form above them)
    and reads rows 16 bytes at a time: ``seg_lo``, ``coeffs`` and ``tree``
    must start on 16 bytes, as a plan's own tables do.  It raises on a
    tree whose shape is not that of the tree of H starts; a tree of other
    starts of the same count passes unseen.  The plain version tests
    membership against every entry of any table."""
    if q.device.type == "cpu":
        return poly_eval_plain(q, seg_lo, seg_next, seg_hi, coeffs)
    dtype = _build.float_dtype("poly_eval", coeffs)
    if tree is None:
        tree = search_tree(seg_lo)
    _build.require_cuda("poly_eval", q, seg_lo, seg_next, seg_hi, coeffs,
                        tree, dtype=dtype)
    Q, H = q.shape[0], seg_lo.shape[0]
    if (q.dim() != 1 or H < 1 or coeffs.dim() != 2 or coeffs.shape[0] != H
            or any(t.shape != (H,) for t in (seg_next, seg_hi))):
        raise ValueError("poly_eval: shape mismatch "
                         f"{q.shape} {seg_lo.shape} {seg_next.shape} "
                         f"{seg_hi.shape} {coeffs.shape}")
    check_tree_shape("poly_eval", tree, H)
    if any(t.data_ptr() % 16 for t in (seg_lo, coeffs, tree)):
        raise ValueError("poly_eval: seg_lo, coeffs and tree must start on "
                         "a 16-byte boundary (the kernel reads them 16 bytes "
                         "at a time); pass a copy (.clone()) of an offset "
                         "view")
    out = torch.empty(Q, dtype=dtype, device=q.device)
    if Q:
        _build.check(_build.launcher("poly_eval", dtype)(
            q.data_ptr(), seg_lo.data_ptr(), seg_next.data_ptr(),
            seg_hi.data_ptr(), coeffs.data_ptr(), tree.data_ptr(),
            out.data_ptr(), Q, H, coeffs.shape[1] - 1,
            _build.stream(q.device)), "poly_eval")
        poly_eval.launches += 1
    return out


poly_eval.launches = 0
