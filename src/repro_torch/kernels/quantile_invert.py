"""Certified CF inversion for QUANTILE queries: kernel K4.

The twin of ``repro.kernels.quantile_invert``.  Per slack-shifted rank
target the kernel runs the branch-free locate -> closed-form / Newton
solve -> key-grid snap pipeline of ``core.quantile`` and emits the
(answer, lower, upper) triple in one launch (``csrc/quantile.cu``: three
lanes a target, one inversion a lane; the upper end snaps to the key grid
by a descent of the grid's search tree, ``locate.search_tree``, which a
plan carries as ``ref_tree``).

* ``quantile_invert_plain`` is the plain torch version:
  ``core.quantile.certified_quantile_shifted`` with the exact key grid.
* ``quantile_invert`` is the wrapper: the CUDA kernel on CUDA tensors, the
  plain version on CPU tensors.  ``quantile_invert.launches`` counts the
  kernel launches.

``scan=True`` is the reference kernel's scan mode, which the ``cuda_scan``
backend runs (the ``pallas_scan`` twin): every searchsorted becomes the
one-hot comparison sum over the whole array, O(Q (H + n)) work, in the
plain version (``core.quantile`` with ``scan=True``) and in the kernel (its
scan launcher, ``polyfit_quantile_invert_scan``: a count kernel over
chunks of the key grid, then a finish kernel, with an int32 scratch the
wrapper allocates).  The summed
predicate is the binary search's, so both modes return the same keys bit
for bit.  ``quantile_invert.scan_launches`` counts the scan launches apart
from ``launches``.

The boundary array ``B`` (the running max of the segment endpoint values,
``core.quantile.boundary_array``) and the padded key grid ``ref_keys`` are
computed outside the kernel and passed in, as the reference passes them;
``n`` is the live key count inside the grid.
"""
from __future__ import annotations

import torch

from ..core.quantile import certified_quantile_shifted
from . import _build
from .locate import check_tree_shape, search_tree

__all__ = ["quantile_invert", "quantile_invert_plain", "MAX_DEG"]

#: the largest plan degree the kernel takes (``csrc/quantile.cu``
#: ``kMaxQuantileDeg``: one instantiation per degree)
MAX_DEG = 8


def quantile_invert_plain(t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs,
                          seg_err, ref_keys, tree=None, *, h: int, n: int,
                          delta: float, scan: bool = False):
    """Plain torch version of K4: (answer, lower, upper).  It takes K4's
    arguments; its binary search needs no ``tree``."""
    return certified_quantile_shifted(
        t_mid, t_lo, t_hi, seg_lo=seg_lo, seg_hi=seg_hi, coeffs=coeffs,
        seg_err=seg_err, h=h, delta=delta, B=B, ref_keys=ref_keys, n=n,
        scan=scan)


def quantile_invert(t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err,
                    ref_keys, tree=None, *, h: int, n: int, delta: float,
                    scan: bool = False):
    """(answer, lower, upper), each (Q,): K4 on CUDA tensors (its scan
    mode with ``scan``), the plain version on CPU tensors.

    ``t_mid``/``t_lo``/``t_hi`` are rank targets with the slack already
    folded in; ``B``/``seg_lo``/``seg_hi``/``seg_err`` (H,) and ``coeffs``
    (H, deg+1) the plan's tile-padded tables with ``h`` true segments;
    ``ref_keys`` the sorted, sentinel-padded key grid holding ``n`` keys.
    The gather mode snaps the upper end by a descent of ``tree``, the
    search tree of ``ref_keys[:n]`` (a plan's ``ref_tree``; a call without
    one builds it); the scan mode counts the whole grid and reads no tree.
    Both read rows 16 bytes at a time: ``coeffs`` (and in the gather mode
    ``ref_keys`` and ``tree``) must start on 16 bytes, as a plan's own
    tables do.  A tree whose shape is not that of the tree of n keys is
    refused; a tree of other keys of the same count passes unseen.
    """
    if t_mid.device.type == "cpu":
        return quantile_invert_plain(t_mid, t_lo, t_hi, B, seg_lo, seg_hi,
                                     coeffs, seg_err, ref_keys, h=h, n=n,
                                     delta=delta, scan=scan)
    _build.require_cuda("quantile_invert", t_mid, t_lo, t_hi, B, seg_lo,
                        seg_hi, coeffs, seg_err, ref_keys)
    Q, H, nk = t_mid.shape[0], seg_lo.shape[0], ref_keys.shape[0]
    deg = coeffs.shape[-1] - 1
    if (t_lo.shape != (Q,) or t_hi.shape != (Q,) or coeffs.shape != (H, deg + 1)
            or any(a.shape != (H,) for a in (B, seg_hi, seg_err))
            or not 1 <= h <= H or not 1 <= n <= nk):
        raise ValueError(
            f"quantile_invert: shape mismatch {t_mid.shape} {t_lo.shape} "
            f"{t_hi.shape} {B.shape} {seg_lo.shape} {seg_hi.shape} "
            f"{coeffs.shape} {seg_err.shape} {ref_keys.shape} (h={h}, n={n})")
    if not 1 <= deg <= MAX_DEG:
        raise ValueError(f"quantile_invert: plan degree {deg} outside the "
                         f"kernel's 1..{MAX_DEG}")
    aligned = [coeffs]
    if not scan:
        if tree is None:
            tree = search_tree(ref_keys[:n])
        _build.require_cuda("quantile_invert", ref_keys, tree)
        check_tree_shape("quantile_invert", tree, n)
        aligned += [ref_keys, tree]
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("quantile_invert: coeffs, ref_keys and tree must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "16 bytes at a time); pass a copy (.clone()) of an "
                         "offset view")
    out = torch.empty((3, Q), dtype=coeffs.dtype, device=t_mid.device)
    if Q:
        lib = _build.library()
        ins = (t_mid, t_lo, t_hi, B, seg_lo, seg_hi, coeffs, seg_err,
               ref_keys)
        if scan:
            # the scan mode counts the key grid in S chunks (partial counts
            # and the lower and answer counts in an int32 scratch)
            part = torch.empty((lib.polyfit_quantile_scan_chunks(nk) + 2, Q),
                               dtype=torch.int32, device=t_mid.device)
            ptrs = [t.data_ptr() for t in (*ins, *out, part)]
            code = lib.polyfit_quantile_invert_scan(
                *ptrs, Q, H, deg, h, nk, n, float(delta),
                _build.stream(t_mid.device))
        else:
            ptrs = [t.data_ptr() for t in (*ins, tree, *out)]
            code = lib.polyfit_quantile_invert(
                *ptrs, Q, H, deg, h, n, float(delta),
                _build.stream(t_mid.device))
        _build.check(code, "quantile_invert")
        if scan:
            quantile_invert.scan_launches += 1
        else:
            quantile_invert.launches += 1
    return out[0], out[1], out[2]


quantile_invert.launches = 0
quantile_invert.scan_launches = 0
