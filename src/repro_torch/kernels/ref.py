"""Plain torch oracles with the kernels' array-level semantics (1-D part).

The twin of ``repro.kernels.ref``: the query clamp and the one-hot
membership rule one_hot[q, j] = (seg_lo[j] <= q) & (q < seg_next[j]) of the
scan kernels, with a dense interior reduction for MAX, the dense
membership oracles of the 1-D and 2-D delta-buffer corrections (over
(Q, cap) in chunks of queries; the 1-D ones are also the plain versions
of kernels K16 and K17, the 2-D COUNT and dominance ones of K18 and K20),
and the 2-D flat-leaf one-hot
oracles (``leaf_eval2d_ref``, ``corner_count2d_ref``: the reference's
one-hot matmul gather, in chunks of queries).  The engine's ``ref``
backend runs these; its ``torch`` backend runs the 2-D delta oracles too,
as the reference's ``xla`` backend does.
"""
from __future__ import annotations

import torch

from ..core.index2d import bivariate_horner
from ..core.poly import clipped_poly_max, eval_segments, locate
from .leaf_eval2d import _CHUNK_ELEMS

__all__ = ["poly_eval_ref", "range_sum_ref", "range_max_ref",
           "delta_sum_ref", "delta_max_ref", "delta_count2d_ref",
           "delta_sum2d_ref", "delta_dommax2d_ref", "leaf_eval2d_ref",
           "corner_count2d_ref"]


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
    oracle); sentinel-padded slots never satisfy membership.  The (Q, cap)
    membership is formed a chunk of queries at a time."""
    def part(lq, uq):
        member = ((lq[:, None] < keys[None, :]) &
                  (keys[None, :] <= uq[:, None])).to(vals.dtype)
        return member @ vals
    return _chunked(part, keys.shape[0], lq, uq)


def delta_max_ref(lq, uq, keys, vals):
    """Exact max of buffered measures with key in [lq, uq]; -inf if none
    (a chunk of queries at a time)."""
    def part(lq, uq):
        member = ((lq[:, None] <= keys[None, :]) &
                  (keys[None, :] <= uq[:, None]))
        return torch.where(member, vals[None, :], -torch.inf).amax(dim=1)
    return _chunked(part, keys.shape[0], lq, uq)


def _chunked(fn, cap: int, *qs):
    """``fn`` over query chunks of at most ``_CHUNK_ELEMS`` (query, slot)
    pairs, concatenated (one empty chunk for no queries, so the result
    keeps ``fn``'s dtype)."""
    step = max(1, _CHUNK_ELEMS // max(1, cap))
    return torch.cat([fn(*(q[s:s + step] for q in qs))
                      for s in range(0, max(1, qs[0].shape[0]), step)])


def _in_rect(lx, ux, ly, uy, keys_x, keys_y):
    return ((lx[:, None] < keys_x[None, :]) & (keys_x[None, :] <= ux[:, None])
            & (ly[:, None] < keys_y[None, :]) & (keys_y[None, :] <= uy[:, None]))


def delta_count2d_ref(lx, ux, ly, uy, keys_x, keys_y):
    """Exact count of buffered points in (lx, ux] x (ly, uy]."""
    return _chunked(lambda *q: _in_rect(*q, keys_x, keys_y).sum(
        dim=1, dtype=keys_x.dtype), keys_x.shape[0], lx, ux, ly, uy)


def delta_sum2d_ref(lx, ux, ly, uy, keys_x, keys_y, wv):
    """Exact sum of buffered measures over points in (lx, ux] x (ly, uy];
    sentinel-padded slots carry weight 0 and never satisfy membership."""
    return _chunked(lambda *q: _in_rect(*q, keys_x, keys_y).to(wv.dtype) @ wv,
                    keys_x.shape[0], lx, ux, ly, uy)


def delta_dommax2d_ref(u, v, keys_x, keys_y, wv):
    """Exact dominance max of buffered measures over {x <= u, y <= v};
    -inf if no buffered point is dominated."""
    def part(u, v):
        member = ((keys_x[None, :] <= u[:, None]) &
                  (keys_y[None, :] <= v[:, None]))
        return torch.where(member, wv[None, :], -torch.inf).amax(dim=1)
    return _chunked(part, keys_x.shape[0], u, v)


def leaf_eval2d_ref(qx, qy, mx0, mx1, my0, my1, bounds, coeffs, deg):
    """CF at (qx, qy) via the flat-leaf one-hot membership rule.

    one_hot[q, j] = (mx0[j] <= qx < mx1[j]) & (my0[j] <= qy < my1[j]) —
    identical to the quadtree descent's quadrant rule (ties go to the
    higher-coordinate leaf) provided queries are pre-clamped into the root
    region; right/top root-edge leaves carry a huge mx1/my1 sentinel.  The
    (Q, Lp) one-hot is formed a chunk of queries at a time.
    """
    table = torch.cat([coeffs, bounds], dim=1)
    k = coeffs.shape[1]
    step = max(1, _CHUNK_ELEMS // max(1, mx0.shape[0]))
    parts = []
    for s in range(0, qx.shape[0], step):
        x, y = qx[s:s + step, None], qy[s:s + step, None]
        one_hot = ((mx0[None, :] <= x) & (x < mx1[None, :]) &
                   (my0[None, :] <= y) & (y < my1[None, :])).to(coeffs.dtype)
        parts.append(one_hot @ table)
    gath = torch.cat(parts) if parts else table.new_zeros(0, table.shape[1])
    return bivariate_horner(qx, qy, gath[:, :k], gath[:, k:], deg)


def corner_count2d_ref(lx, ux, ly, uy, mx0, mx1, my0, my1, bounds, coeffs,
                       deg):
    """4-corner inclusion-exclusion COUNT (Eq. 19) over the flat leaf table;
    corners pre-clamped into the root region by the caller."""
    ev = lambda qx, qy: leaf_eval2d_ref(qx, qy, mx0, mx1, my0, my1, bounds,
                                        coeffs, deg)
    return ev(ux, uy) - ev(lx, uy) - ev(ux, ly) + ev(lx, ly)
