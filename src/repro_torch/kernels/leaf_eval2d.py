"""2-key leaf evaluation: kernels K7, K8, K12 and K13.

The twin of ``repro.kernels.leaf_eval2d``.  A 2-D query corner (qx, qy) is
answered by the fitted surface of the quadtree leaf that holds it,
P_leaf(u(qx), v(qy)) on the leaf's scaled coordinates (Horner in v inside
Horner in u).  Rectangle COUNT/SUM combine four corners with signs
(+, -, -, +) (paper Eq. 19); dominance MAX/MIN evaluate one corner.  Two
ways to find the leaf:

* **gather** (K7 ``corner_count2d_gather``, K8 ``corner_eval2d_gather``):
  the leaves are disjoint intervals in Morton (Z-order) space, so a corner
  resolves with three binary searches — the x cut, the y cut, the int32
  leaf code (``locate_leaf2d``) — and one gathered row.  The kernels take
  the two cuts by checked guesses (``csrc/locate.cuh`` ``cut_rank_guess``,
  equal to the search in every lane on sorted cuts).  Plans up to
  ``MAX_MORTON_DEPTH`` levels deep.
* **scan** (K12 ``corner_count2d``, K13 ``corner_eval2d``): one-hot
  membership ``mx0 <= qx < mx1 and my0 <= qy < my1`` over the whole flat
  leaf table; the matching leaf's row, zeros when none matches.  Plans
  deeper than 15 levels, whose Morton codes overflow int32.

Both reproduce the descent's tie rule (a corner on a split line belongs to
the higher-coordinate leaf), so on one plan the four agree bit for bit.
Each ``*_plain`` function is the plain torch version of its kernel, in the
kernel's order of operations (``core.index2d.bivariate_horner``, the
reference's sequence); each wrapper launches its kernel (``csrc/leaf_eval2d.cu``) on
CUDA tensors and runs the plain version on CPU tensors, and counts its
launches in ``.launches``.  Corners must be pre-clamped into the root
region (the engine's executors clamp them).
"""
from __future__ import annotations

import torch

from ..core.index2d import bivariate_horner
from . import _build
from .locate import MAX_MORTON_DEPTH, locate_leaf2d

__all__ = ["corner_count2d_gather", "corner_count2d_gather_plain",
           "corner_eval2d_gather", "corner_eval2d_gather_plain",
           "corner_count2d", "corner_count2d_plain", "corner_eval2d",
           "corner_eval2d_plain", "MAX_DEG_2D"]

# the largest degree the kernels take (one instantiation each, csrc)
MAX_DEG_2D = 5
# membership elements per chunk of the plain scan versions
_CHUNK_ELEMS = 1 << 24


def _corners(lx, ux, ly, uy):
    """The inclusion-exclusion corners, in sign order (+, -, -, +)."""
    return ((ux, uy), (lx, uy), (ux, ly), (lx, ly))


def corner_count2d_gather_plain(lx, ux, ly, uy, xcuts, ycuts, leaf_z,
                                bounds, coeffs, deg: int, depth: int):
    """Plain torch version of K7."""
    vals = []
    for qx, qy in _corners(lx, ux, ly, uy):
        leaf = locate_leaf2d(qx, qy, xcuts, ycuts, leaf_z, depth).long()
        vals.append(bivariate_horner(qx, qy, coeffs[leaf], bounds[leaf],
                                      deg))
    return vals[0] - vals[1] - vals[2] + vals[3]


def corner_eval2d_gather_plain(u, v, xcuts, ycuts, leaf_z, bounds, coeffs,
                               deg: int, depth: int):
    """Plain torch version of K8."""
    leaf = locate_leaf2d(u, v, xcuts, ycuts, leaf_z, depth).long()
    return bivariate_horner(u, v, coeffs[leaf], bounds[leaf], deg)


def _scan_rows(qx, qy, mx0, mx1, my0, my1):
    """(row, hit): the first leaf whose membership box holds each corner,
    and whether one does — the (Q, Lp) membership compared in chunks of
    queries, so it never holds more than ``_CHUNK_ELEMS`` flags."""
    step = max(1, _CHUNK_ELEMS // max(1, mx0.shape[0]))
    rows, hits = [], []
    for s in range(0, qx.shape[0], step):
        x, y = qx[s:s + step, None], qy[s:s + step, None]
        m = ((mx0[None, :] <= x) & (x < mx1[None, :]) &
             (my0[None, :] <= y) & (y < my1[None, :]))
        hits.append(m.any(dim=1))
        rows.append(m.to(torch.uint8).argmax(dim=1))
    if not rows:
        empty = qx.new_zeros(0, dtype=torch.int64)
        return empty, empty.bool()
    return torch.cat(rows), torch.cat(hits)


def _scan_eval(qx, qy, mx0, mx1, my0, my1, bounds, coeffs, deg: int):
    row, hit = _scan_rows(qx, qy, mx0, mx1, my0, my1)
    c = torch.where(hit[:, None], coeffs[row], 0.0)
    b = torch.where(hit[:, None], bounds[row], 0.0)
    return bivariate_horner(qx, qy, c, b, deg)


def corner_count2d_plain(lx, ux, ly, uy, mx0, mx1, my0, my1, bounds, coeffs,
                         deg: int):
    """Plain torch version of K12."""
    vals = [_scan_eval(qx, qy, mx0, mx1, my0, my1, bounds, coeffs, deg)
            for qx, qy in _corners(lx, ux, ly, uy)]
    return vals[0] - vals[1] - vals[2] + vals[3]


def corner_eval2d_plain(u, v, mx0, mx1, my0, my1, bounds, coeffs, deg: int):
    """Plain torch version of K13."""
    return _scan_eval(u, v, mx0, mx1, my0, my1, bounds, coeffs, deg)


def _check_table(name, bounds, coeffs, deg, L):
    k = (deg + 1) * (deg + 1)
    if not 0 <= deg <= MAX_DEG_2D:
        raise ValueError(f"{name}: deg {deg} outside the kernels' 0.."
                         f"{MAX_DEG_2D}")
    if (L < 1 or tuple(bounds.shape) != (L, 4)
            or tuple(coeffs.shape) != (L, k)):
        raise ValueError(f"{name}: leaf table shapes {tuple(bounds.shape)} "
                         f"{tuple(coeffs.shape)} do not match {L} leaves "
                         f"of degree {deg}")


def _check_queries(name, *qs):
    if len({q.shape for q in qs}) != 1 or qs[0].dim() != 1:
        raise ValueError(f"{name}: corner coordinates must be equal-length "
                         f"vectors, got {[tuple(q.shape) for q in qs]}")


def _check_aligned(name, bounds, coeffs):
    """K7, K8 and K13 read the rows by 16-byte loads; a plan's tables are
    allocations of their own, so only a view into another tensor can be
    off."""
    if bounds.data_ptr() % 16 or coeffs.data_ptr() % 16:
        raise ValueError(f"{name}: bounds and coeffs must start on a 16-byte "
                         "boundary (the kernel reads their rows 16 bytes at a "
                         "time); pass a copy (.clone()) of an offset view")


def _gather_args(name, qs, xcuts, ycuts, leaf_z, bounds, coeffs, deg, depth):
    _build.require_cuda(name, *qs, xcuts, ycuts, bounds, coeffs)
    _build.require_cuda(name, leaf_z, dtype=torch.int32)
    _check_queries(name, *qs)
    _check_table(name, bounds, coeffs, deg, leaf_z.shape[0])
    if (xcuts.shape[0] < 1 or ycuts.shape[0] < 1
            or leaf_z.device != qs[0].device):
        raise ValueError(f"{name}: empty cut grid or leaf codes on another "
                         "device")
    if not 0 <= depth <= MAX_MORTON_DEPTH:
        raise ValueError(f"{name}: depth {depth} outside the int32 Morton "
                         f"range 0..{MAX_MORTON_DEPTH}")


def corner_count2d_gather(lx, ux, ly, uy, xcuts, ycuts, leaf_z, bounds,
                          coeffs, deg: int, depth: int):
    """(Q,) 4-corner COUNT/SUM over (lx, ux] x (ly, uy] against the
    z-sorted leaf table: K7 on CUDA tensors, the plain version on CPU
    tensors.  ``leaf_z`` is int32, sentinel-padded; ``xcuts``/``ycuts`` the
    dyadic split grids of a ``depth``-level tree, sorted (K7 ranks a corner
    by a guess it checks against the cuts around it, exact on sorted cuts);
    ``bounds`` and ``coeffs`` 16-byte aligned, as a plan's are."""
    if lx.device.type == "cpu":
        return corner_count2d_gather_plain(lx, ux, ly, uy, xcuts, ycuts,
                                           leaf_z, bounds, coeffs, deg, depth)
    name = "corner_count2d_gather"
    _gather_args(name, (lx, ux, ly, uy), xcuts, ycuts, leaf_z, bounds,
                 coeffs, deg, depth)
    _check_aligned(name, bounds, coeffs)
    out = torch.empty_like(lx)
    if lx.shape[0]:
        _build.check(_build.library().polyfit_corner_count2d_gather(
            lx.data_ptr(), ux.data_ptr(), ly.data_ptr(), uy.data_ptr(),
            xcuts.data_ptr(), ycuts.data_ptr(), leaf_z.data_ptr(),
            bounds.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            lx.shape[0], xcuts.shape[0], ycuts.shape[0], leaf_z.shape[0],
            deg, depth, _build.stream(lx.device)), name)
        corner_count2d_gather.launches += 1
    return out


def corner_eval2d_gather(u, v, xcuts, ycuts, leaf_z, bounds, coeffs,
                         deg: int, depth: int):
    """(Q,) single-corner P_leaf(u, v) against the z-sorted leaf table (the
    dominance MAX/MIN path): K8 on CUDA tensors, the plain version on CPU
    tensors.  The arguments are K7's: ``xcuts``/``ycuts`` sorted (K8 ranks
    a corner by a checked guess, as K7 does), ``bounds`` and ``coeffs``
    16-byte aligned, as a plan's are."""
    if u.device.type == "cpu":
        return corner_eval2d_gather_plain(u, v, xcuts, ycuts, leaf_z, bounds,
                                          coeffs, deg, depth)
    name = "corner_eval2d_gather"
    _gather_args(name, (u, v), xcuts, ycuts, leaf_z, bounds, coeffs, deg,
                 depth)
    _check_aligned(name, bounds, coeffs)
    out = torch.empty_like(u)
    if u.shape[0]:
        _build.check(_build.library().polyfit_corner_eval2d_gather(
            u.data_ptr(), v.data_ptr(), xcuts.data_ptr(), ycuts.data_ptr(),
            leaf_z.data_ptr(), bounds.data_ptr(), coeffs.data_ptr(),
            out.data_ptr(), u.shape[0], xcuts.shape[0], ycuts.shape[0],
            leaf_z.shape[0], deg, depth, _build.stream(u.device)), name)
        corner_eval2d_gather.launches += 1
    return out


def _scan_args(name, qs, mx0, mx1, my0, my1, bounds, coeffs, deg):
    _build.require_cuda(name, *qs, mx0, mx1, my0, my1, bounds, coeffs)
    _check_queries(name, *qs)
    _check_queries(name, mx0, mx1, my0, my1)
    _check_table(name, bounds, coeffs, deg, mx0.shape[0])


def corner_count2d(lx, ux, ly, uy, mx0, mx1, my0, my1, bounds, coeffs,
                   deg: int):
    """(Q,) 4-corner COUNT/SUM by one-hot membership over the flat leaf
    table: K12 on CUDA tensors, the plain version on CPU tensors.

    K12 takes a plan's flat leaf table as given (``engine.plan.
    build_plan_2d``): the leaves' membership boxes partition the root, the
    sentinel-padded leaves sit at the tail only, and the corners are
    clamped into the root, so at most one leaf holds a corner.  It stops at
    the first tile of the table whose first ``mx0`` is the sentinel."""
    if lx.device.type == "cpu":
        return corner_count2d_plain(lx, ux, ly, uy, mx0, mx1, my0, my1,
                                    bounds, coeffs, deg)
    name = "corner_count2d"
    _scan_args(name, (lx, ux, ly, uy), mx0, mx1, my0, my1, bounds, coeffs,
               deg)
    out = torch.empty_like(lx)
    Q, L = lx.shape[0], mx0.shape[0]
    if Q:
        lib = _build.library()
        # the kernel scans the table in S chunks; a finish kernel takes
        # each corner's leaf from them and evaluates it
        hits = torch.empty((4 * lib.polyfit_corner_count2d_chunks(L), Q),
                           dtype=torch.int32, device=lx.device)
        _build.check(lib.polyfit_corner_count2d(
            lx.data_ptr(), ux.data_ptr(), ly.data_ptr(), uy.data_ptr(),
            mx0.data_ptr(), mx1.data_ptr(), my0.data_ptr(), my1.data_ptr(),
            bounds.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            hits.data_ptr(), Q, L, deg, _build.sentinel(torch.float64),
            _build.stream(lx.device)), name)
        corner_count2d.launches += 1
    return out


def corner_eval2d(u, v, mx0, mx1, my0, my1, bounds, coeffs, deg: int):
    """(Q,) single-corner evaluation by one-hot membership over the flat
    leaf table: K13 on CUDA tensors, the plain version on CPU tensors.

    K13 takes a plan's flat leaf table as K12 does: the leaves' membership
    boxes partition the root, the sentinel-padded leaves sit at the tail
    only, and the corners are clamped into the root, so at most one leaf
    holds a corner.  It stops at the first tile of the table whose first
    ``mx0`` is the sentinel, and reads the rows by 16-byte loads, so
    ``bounds`` and ``coeffs`` must start on 16 bytes, as a plan's do."""
    if u.device.type == "cpu":
        return corner_eval2d_plain(u, v, mx0, mx1, my0, my1, bounds, coeffs,
                                   deg)
    name = "corner_eval2d"
    _scan_args(name, (u, v), mx0, mx1, my0, my1, bounds, coeffs, deg)
    _check_aligned(name, bounds, coeffs)
    out = torch.empty_like(u)
    Q, L = u.shape[0], mx0.shape[0]
    if Q:
        lib = _build.library()
        # the kernel scans the table in S chunks; a finish kernel takes
        # each corner's leaf from them and evaluates it
        hits = torch.empty((lib.polyfit_corner_eval2d_chunks(L), Q),
                           dtype=torch.int32, device=u.device)
        _build.check(lib.polyfit_corner_eval2d(
            u.data_ptr(), v.data_ptr(), mx0.data_ptr(), mx1.data_ptr(),
            my0.data_ptr(), my1.data_ptr(), bounds.data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), hits.data_ptr(), Q, L, deg,
            _build.sentinel(torch.float64), _build.stream(u.device)), name)
        corner_eval2d.launches += 1
    return out


corner_count2d_gather.launches = 0
corner_eval2d_gather.launches = 0
corner_count2d.launches = 0
corner_eval2d.launches = 0
