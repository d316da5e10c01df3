"""Exact delta-buffer corrections for dynamic plans: kernels K5, K6, K9,
K10, K11, K16, K17, K18, K19 and K20.

The twin of ``repro.kernels.delta_scan``.  A ``DynamicEngine`` /
``DynamicEngine2D`` (``engine/dynamic.py``) buffers inserts and deletes in
fixed-capacity, sorted, sentinel-padded logs between merges, and keeps on
append the structures the gather corrections read:

* ``delta_sum_gather`` (K5) — sum of buffered measures with key in
  (lq, uq]: two binary searches into the sorted log and the difference of
  its exclusive prefix sums ``cf`` ((cap + 1,), ``cf[i] = sum(vals[:i])``);
* ``delta_max_gather`` (K6) — max of buffered measures with key in
  [lq, uq]: the log's covered span [#(keys < lq), #(keys <= uq)) and an
  O(1) two-gather range max against the log's (L, cap) sparse table;
  an empty span gives -inf;
* ``delta_count2d_gather`` (K9) — count of buffered points in (lx, ux] x
  (ly, uy] over an x-sorted point log: per corner the x-rank #(kx <= x)
  and the merge-sort-tree prefix count over the log's (L, cap) levels
  ``ylv`` (``core.index2d.mst_count_prefix``), combined + - - +;
* ``delta_sum2d_gather`` (K10) — the same over the per-block prefix sums
  ``wcum`` of the logged measures (``mst_weighted_prefix``, mode 'sum');
* ``delta_dommax2d_gather`` (K11) — the dominance max over {x <= u,
  y <= v} from the prefix maxima ``wpmax``; -inf when nothing is dominated.

The ``cuda_scan`` backend's twins scan the whole log instead, as
``delta_sum_pallas``, ``delta_max_pallas`` and ``delta_*2d_pallas`` do:

* ``delta_sum`` (K16) — the sum of the measures whose key lies in
  (lq, uq], a membership test against every live slot (it stops at the
  log's sentinel tail);
* ``delta_max`` (K17) — the max of the measures whose key lies in
  [lq, uq], -inf when none does (it stops at the log's sentinel tail, and
  a range that holds the sentinel takes the tail's 0 back in);
* ``delta_count2d`` (K18) — the number of logged points in (lx, ux] x
  (ly, uy] (it tests only the slots of the rectangle's x range, ranked by
  two binary searches of the x-sorted log, stops at its sentinel tail and
  counts the tail's slots without a walk);
* ``delta_sum2d`` (K19) — the sum of their measures, added in slot order
  (the same x ranks, and the same stop);
* ``delta_dommax2d`` (K20) — the max measure of the logged points with
  x <= u and y <= v, -inf when none is dominated (it stops at the log's
  sentinel tail, and a corner that dominates the sentinel takes the tail's
  0 back in).

Sentinel slots hold a huge-but-finite key (both coordinates for a point
log) and measure 0, so they fail every membership test and leave the
prefix sums flat: no correction needs the fill level.

Each ``*_plain`` function is the plain torch version, in the kernel's order
of operations (K16's, K17's, K18's and K20's are the dense oracles of
``kernels/ref.py``, exact in any order but K16's, whose product may add a
SUM log's measures in another order than the kernel, which adds each
chunk of the log in slot order and the chunk sums in chunk order; K19's
adds in slot order, a loop over slots vectorised over queries); each
wrapper launches its CUDA kernel (``csrc/polyfit_kernels.cu`` for K5/K6,
``csrc/delta2d.cu`` for K9-K11, ``csrc/scan1d.cu`` for K16/K17,
``csrc/scan2d.cu`` for K18-K20) on CUDA tensors and runs the plain version
on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.index2d import mst_count_prefix, mst_weighted_prefix
from . import _build
from .locate import bsearch_count, rmq_gather
from .leaf_eval2d import _CHUNK_ELEMS
from .ref import (_in_rect, delta_count2d_ref, delta_dommax2d_ref,
                  delta_max_ref, delta_sum_ref)

__all__ = ["delta_sum_gather_plain", "delta_sum_gather",
           "delta_max_gather_plain", "delta_max_gather", "delta_sum_plain",
           "delta_sum", "delta_max_plain", "delta_max",
           "delta_count2d_gather_plain", "delta_count2d_gather",
           "delta_sum2d_gather_plain", "delta_sum2d_gather",
           "delta_dommax2d_gather_plain", "delta_dommax2d_gather",
           "delta_count2d_plain", "delta_count2d", "delta_sum2d_plain",
           "delta_sum2d", "delta_dommax2d_plain", "delta_dommax2d"]


def delta_sum_gather_plain(lq, uq, keys, cf):
    """Plain torch version of K5."""
    cu = bsearch_count(keys, uq, side="right")
    cl = bsearch_count(keys, lq, side="right")
    return cf[cu] - cf[cl]


def delta_max_gather_plain(lq, uq, keys, st):
    """Plain torch version of K6."""
    i0 = bsearch_count(keys, lq, side="left")
    i1 = bsearch_count(keys, uq, side="right")
    return rmq_gather(st, i0, i1)


def _check_shapes(name, lq, uq, keys, table, table_ok):
    Q, cap = lq.shape[0], keys.shape[0]
    if uq.shape[0] != Q or cap < 1 or not table_ok(table, cap):
        raise ValueError(f"{name}: shape mismatch {lq.shape} {uq.shape} "
                         f"{keys.shape} {table.shape}")
    return Q, cap


def delta_sum_gather(lq, uq, keys, cf):
    """(Q,) exact buffered SUM over (lq, uq]: K5 on CUDA tensors, the plain
    version on CPU tensors.  ``delta_sum_gather.launches`` counts the kernel
    launches."""
    if lq.device.type == "cpu":
        return delta_sum_gather_plain(lq, uq, keys, cf)
    _build.require_cuda("delta_sum_gather", lq, uq, keys, cf)
    Q, cap = _check_shapes("delta_sum_gather", lq, uq, keys, cf,
                           lambda t, n: t.dim() == 1 and t.shape[0] == n + 1)
    out = torch.empty(Q, dtype=cf.dtype, device=lq.device)
    if Q:
        _build.check(_build.library().polyfit_delta_sum_gather(
            lq.data_ptr(), uq.data_ptr(), keys.data_ptr(), cf.data_ptr(),
            out.data_ptr(), Q, cap, _build.stream(lq.device)),
            "delta_sum_gather")
        delta_sum_gather.launches += 1
    return out


delta_sum_gather.launches = 0


def delta_max_gather(lq, uq, keys, st):
    """(Q,) exact buffered MAX over [lq, uq] (-inf where no buffered key
    lies in the range): K6 on CUDA tensors, the plain version on CPU
    tensors.  ``delta_max_gather.launches`` counts the kernel launches.

    K6 runs two threads a query, one an endpoint, both in one search loop
    (the lq thread counts keys < lq, the uq thread keys <= uq); the uq
    thread takes the sparse-table max."""
    if lq.device.type == "cpu":
        return delta_max_gather_plain(lq, uq, keys, st)
    _build.require_cuda("delta_max_gather", lq, uq, keys, st)
    Q, cap = _check_shapes(
        "delta_max_gather", lq, uq, keys, st,
        lambda t, n: t.dim() == 2 and t.shape[1] == n
        and (1 << t.shape[0]) > n)
    out = torch.empty(Q, dtype=st.dtype, device=lq.device)
    if Q:
        _build.check(_build.library().polyfit_delta_max_gather(
            lq.data_ptr(), uq.data_ptr(), keys.data_ptr(), st.data_ptr(),
            out.data_ptr(), Q, cap, _build.stream(lq.device)),
            "delta_max_gather")
        delta_max_gather.launches += 1
    return out


delta_max_gather.launches = 0


# ---------------------------------------------------------------------------
# one-key scans over the whole log: K16, K17
# ---------------------------------------------------------------------------

#: the padding key of a float64 log (``engine.plan.big_sentinel``), where
#: K16-K20 stop
_SENTINEL = float(torch.finfo(torch.float64).max) / 4


def delta_sum_plain(lq, uq, keys, vals):
    """Plain torch version of K16: the one-hot membership product
    (``ref.delta_sum_ref``)."""
    return delta_sum_ref(lq, uq, keys, vals)


def delta_max_plain(lq, uq, keys, vals):
    """Plain torch version of K17: the masked max (``ref.delta_max_ref``)."""
    return delta_max_ref(lq, uq, keys, vals)


def _scan_args(name, lq, uq, keys, vals):
    """Validate K16's or K17's arguments: (Q, D, the output, the pointers
    the launcher takes first)."""
    _build.require_cuda(name, lq, uq, keys, vals)
    Q, D = lq.shape[0], keys.shape[0]
    if uq.shape[0] != Q or vals.shape != (D,) or D < 1:
        raise ValueError(f"{name}: shape mismatch {lq.shape} {uq.shape} "
                         f"{keys.shape} {vals.shape}")
    out = torch.empty(Q, dtype=vals.dtype, device=lq.device)
    return Q, D, out, (lq.data_ptr(), uq.data_ptr(), keys.data_ptr(),
                       vals.data_ptr(), out.data_ptr())


def delta_sum(lq, uq, keys, vals):
    """(Q,) exact buffered SUM over (lq, uq] by a membership test against
    every live slot of the log: K16 on CUDA tensors, the plain version on
    CPU tensors.  ``delta_sum.launches`` counts the kernel launches.

    K16 takes the ``DeltaBuffer`` layout as given: keys sorted, and from
    the first ``big_sentinel`` key on every slot holds that key with value
    0.  It stops at the first tile of the log that starts on the sentinel
    (no slot from there on can add anything), so a half-empty log costs
    half a full one.  The plain version scans every slot of any log."""
    if lq.device.type == "cpu":
        return delta_sum_plain(lq, uq, keys, vals)
    Q, D, out, ptrs = _scan_args("delta_sum", lq, uq, keys, vals)
    if Q:
        lib = _build.library()
        # the kernel sums the log in S chunks, then adds them in chunk order
        part = torch.empty((lib.polyfit_delta_sum_chunks(D), Q),
                           dtype=vals.dtype, device=lq.device)
        _build.check(lib.polyfit_delta_sum(
            *ptrs, part.data_ptr(), Q, D, _SENTINEL,
            _build.stream(lq.device)), "delta_sum")
        delta_sum.launches += 1
    return out


delta_sum.launches = 0


def delta_max(lq, uq, keys, vals):
    """(Q,) exact buffered MAX over [lq, uq] (-inf where no buffered key
    lies in the range, NaN where a member's measure is NaN) by a membership
    test against every live slot: K17 on CUDA tensors, the plain version on
    CPU tensors.  ``delta_max.launches`` counts the kernel launches.

    K17 takes the ``DeltaBuffer`` layout as ``delta_sum`` does: it stops at
    the first tile of the log that starts on the sentinel, and a range that
    holds the sentinel takes the skipped slots' value 0 back in.  The plain
    version scans every slot of any log."""
    if lq.device.type == "cpu":
        return delta_max_plain(lq, uq, keys, vals)
    Q, D, out, ptrs = _scan_args("delta_max", lq, uq, keys, vals)
    if Q:
        lib = _build.library()
        # the kernel takes each chunk's maxima, then their max in chunk order
        part = torch.empty((lib.polyfit_delta_max_chunks(D), Q),
                           dtype=vals.dtype, device=lq.device)
        _build.check(lib.polyfit_delta_max(
            *ptrs, part.data_ptr(), Q, D, _SENTINEL,
            _build.stream(lq.device)), "delta_max")
        delta_max.launches += 1
    return out


delta_max.launches = 0


# ---------------------------------------------------------------------------
# two-key point logs: K9, K10, K11
# ---------------------------------------------------------------------------

def delta_count2d_gather_plain(lx, ux, ly, uy, keys_x, ys_levels):
    """Plain torch version of K9."""
    def cf(x, y):
        i = bsearch_count(keys_x, x, side="right")
        return mst_count_prefix(keys_x, ys_levels, i, y).to(keys_x.dtype)
    return cf(ux, uy) - cf(lx, uy) - cf(ux, ly) + cf(lx, ly)


def delta_sum2d_gather_plain(lx, ux, ly, uy, keys_x, ys_levels, wcum_levels):
    """Plain torch version of K10."""
    def cf(x, y):
        i = bsearch_count(keys_x, x, side="right")
        return mst_weighted_prefix(keys_x, ys_levels, wcum_levels, i, y,
                                   mode="sum")
    return cf(ux, uy) - cf(lx, uy) - cf(ux, ly) + cf(lx, ly)


def delta_dommax2d_gather_plain(u, v, keys_x, ys_levels, wpmax_levels):
    """Plain torch version of K11."""
    i = bsearch_count(keys_x, u, side="right")
    return mst_weighted_prefix(keys_x, ys_levels, wpmax_levels, i, v,
                               mode="max")


def _check_log2d(name, queries, keys_x, tables):
    """Shapes K9-K11 take: equal-length query vectors, a log of cap slots
    (a power of two) and (cap.bit_length(), cap) level tables."""
    Q, cap = queries[0].shape[0], keys_x.shape[0]
    levels = cap.bit_length()
    if (any(q.shape != (Q,) for q in queries) or cap < 1 or cap & (cap - 1)
            or any(t.shape != (levels, cap) for t in tables)):
        raise ValueError(f"{name}: shape mismatch: queries "
                         f"{[tuple(q.shape) for q in queries]}, log "
                         f"{tuple(keys_x.shape)}, tables "
                         f"{[tuple(t.shape) for t in tables]}")
    return Q, cap, levels


def delta_count2d_gather(lx, ux, ly, uy, keys_x, ys_levels):
    """(Q,) f64 exact count of buffered points in (lx, ux] x (ly, uy]: K9
    on CUDA tensors, the plain version on CPU tensors.
    ``delta_count2d_gather.launches`` counts the kernel launches."""
    if lx.device.type == "cpu":
        return delta_count2d_gather_plain(lx, ux, ly, uy, keys_x, ys_levels)
    _build.require_cuda("delta_count2d_gather", lx, ux, ly, uy, keys_x,
                        ys_levels)
    Q, cap, levels = _check_log2d("delta_count2d_gather", (lx, ux, ly, uy),
                                  keys_x, (ys_levels,))
    out = torch.empty(Q, dtype=keys_x.dtype, device=lx.device)
    if Q:
        _build.check(_build.library().polyfit_delta_count2d_gather(
            lx.data_ptr(), ux.data_ptr(), ly.data_ptr(), uy.data_ptr(),
            keys_x.data_ptr(), ys_levels.data_ptr(), out.data_ptr(), Q, cap,
            levels, _build.stream(lx.device)), "delta_count2d_gather")
        delta_count2d_gather.launches += 1
    return out


delta_count2d_gather.launches = 0


def delta_sum2d_gather(lx, ux, ly, uy, keys_x, ys_levels, wcum_levels):
    """(Q,) exact sum of buffered measures over (lx, ux] x (ly, uy]: K10 on
    CUDA tensors, the plain version on CPU tensors.
    ``delta_sum2d_gather.launches`` counts the kernel launches."""
    if lx.device.type == "cpu":
        return delta_sum2d_gather_plain(lx, ux, ly, uy, keys_x, ys_levels,
                                        wcum_levels)
    _build.require_cuda("delta_sum2d_gather", lx, ux, ly, uy, keys_x,
                        ys_levels, wcum_levels)
    Q, cap, levels = _check_log2d("delta_sum2d_gather", (lx, ux, ly, uy),
                                  keys_x, (ys_levels, wcum_levels))
    out = torch.empty(Q, dtype=wcum_levels.dtype, device=lx.device)
    if Q:
        _build.check(_build.library().polyfit_delta_sum2d_gather(
            lx.data_ptr(), ux.data_ptr(), ly.data_ptr(), uy.data_ptr(),
            keys_x.data_ptr(), ys_levels.data_ptr(), wcum_levels.data_ptr(),
            out.data_ptr(), Q, cap, levels, _build.stream(lx.device)),
            "delta_sum2d_gather")
        delta_sum2d_gather.launches += 1
    return out


delta_sum2d_gather.launches = 0


def delta_dommax2d_gather(u, v, keys_x, ys_levels, wpmax_levels):
    """(Q,) exact dominance max of buffered measures over {x <= u, y <= v}
    (-inf where none is dominated): K11 on CUDA tensors, the plain version
    on CPU tensors.  ``delta_dommax2d_gather.launches`` counts the kernel
    launches."""
    if u.device.type == "cpu":
        return delta_dommax2d_gather_plain(u, v, keys_x, ys_levels,
                                           wpmax_levels)
    _build.require_cuda("delta_dommax2d_gather", u, v, keys_x, ys_levels,
                        wpmax_levels)
    Q, cap, levels = _check_log2d("delta_dommax2d_gather", (u, v), keys_x,
                                  (ys_levels, wpmax_levels))
    out = torch.empty(Q, dtype=wpmax_levels.dtype, device=u.device)
    if Q:
        _build.check(_build.library().polyfit_delta_dommax2d_gather(
            u.data_ptr(), v.data_ptr(), keys_x.data_ptr(),
            ys_levels.data_ptr(), wpmax_levels.data_ptr(), out.data_ptr(), Q,
            cap, levels, _build.stream(u.device)), "delta_dommax2d_gather")
        delta_dommax2d_gather.launches += 1
    return out


delta_dommax2d_gather.launches = 0


# ---------------------------------------------------------------------------
# two-key scans over the whole point log: K18, K19, K20
# ---------------------------------------------------------------------------

def delta_count2d_plain(lx, ux, ly, uy, keys_x, keys_y):
    """Plain torch version of K18: the dense membership count
    (``ref.delta_count2d_ref``), exact in any order."""
    return delta_count2d_ref(lx, ux, ly, uy, keys_x, keys_y)


def delta_sum2d_plain(lx, ux, ly, uy, keys_x, keys_y, wv):
    """Plain torch version of K19: each query's member measures added in
    slot order, as the kernel adds them (a loop over slots, vectorised over
    queries; the membership formed a chunk of slots at a time)."""
    acc = wv.new_zeros(lx.shape[0])
    step = max(1, _CHUNK_ELEMS // max(1, lx.shape[0]))
    for s in range(0, keys_x.shape[0], step):
        sl = slice(s, s + step)
        part = torch.where(_in_rect(lx, ux, ly, uy, keys_x[sl], keys_y[sl]),
                           wv[None, sl], 0.0)
        for k in range(part.shape[1]):
            acc = acc + part[:, k]
    return acc


def delta_dommax2d_plain(u, v, keys_x, keys_y, wv):
    """Plain torch version of K20: the dense masked max
    (``ref.delta_dommax2d_ref``), exact in any order."""
    return delta_dommax2d_ref(u, v, keys_x, keys_y, wv)


def _scan2d_args(name, queries, logs):
    """Validate K18-K20's arguments (equal-length query vectors and
    equal-length log columns) and allocate the answers: (Q, D, out, the
    data pointers of queries, log columns and out)."""
    _build.require_cuda(name, *queries, *logs)
    Q, D = queries[0].shape[0], logs[0].shape[0]
    if (any(q.shape != (Q,) for q in queries) or D < 1
            or any(t.shape != (D,) for t in logs)):
        raise ValueError(f"{name}: shape mismatch: queries "
                         f"{[tuple(q.shape) for q in queries]}, log "
                         f"{[tuple(t.shape) for t in logs]}")
    out = torch.empty(Q, dtype=logs[0].dtype, device=logs[0].device)
    return Q, D, out, [t.data_ptr() for t in (*queries, *logs, out)]


def delta_count2d(lx, ux, ly, uy, keys_x, keys_y):
    """(Q,) f64 exact count of buffered points in (lx, ux] x (ly, uy]: K18
    on CUDA tensors, the plain version on CPU tensors.
    ``delta_count2d.launches`` counts the kernel launches.

    K18 takes the ``DeltaBuffer2D`` layout as given: the log sorted by x
    (NaN last), and from the first ``big_sentinel`` x on every slot holds
    (sentinel, sentinel, 0).  It ranks each rectangle's x range by two
    binary searches, a = #(x <= lx) and b = #(x <= ux), so the slots it
    tests are [a, b) only, and it stops at the sentinel tail, whose slots
    it adds to each rectangle that holds the point (sentinel, sentinel),
    as the plain version, which tests every slot of any log, counts
    them."""
    if lx.device.type == "cpu":
        return delta_count2d_plain(lx, ux, ly, uy, keys_x, keys_y)
    Q, D, out, ptrs = _scan2d_args("delta_count2d", (lx, ux, ly, uy),
                                   (keys_x, keys_y))
    if Q:
        _build.check(_build.library().polyfit_delta_count2d(
            *ptrs, Q, D, _SENTINEL, _build.stream(out.device)),
            "delta_count2d")
        delta_count2d.launches += 1
    return out


delta_count2d.launches = 0


def delta_sum2d(lx, ux, ly, uy, keys_x, keys_y, wv):
    """(Q,) exact sum of buffered measures over (lx, ux] x (ly, uy], added
    in slot order: K19 on CUDA tensors, the plain version on CPU tensors.
    ``delta_sum2d.launches`` counts the kernel launches.

    K19 takes the ``DeltaBuffer2D`` layout as given: the log sorted by x
    (NaN last), and from the first ``big_sentinel`` x on every slot holds
    (sentinel, sentinel, 0).  It ranks each rectangle's x range by two
    binary searches, a = #(x <= lx) and b = #(x <= ux), so the slots it
    tests are [a, b) only, and it stops at the sentinel tail; a member's
    measure is added in slot order, as the plain version adds it, which
    scans every slot of any log."""
    if lx.device.type == "cpu":
        return delta_sum2d_plain(lx, ux, ly, uy, keys_x, keys_y, wv)
    Q, D, out, ptrs = _scan2d_args("delta_sum2d", (lx, ux, ly, uy),
                                   (keys_x, keys_y, wv))
    if Q:
        _build.check(_build.library().polyfit_delta_sum2d(
            *ptrs, Q, D, _SENTINEL, _build.stream(out.device)),
            "delta_sum2d")
        delta_sum2d.launches += 1
    return out


delta_sum2d.launches = 0


def delta_dommax2d(u, v, keys_x, keys_y, wv):
    """(Q,) exact dominance max of buffered measures over {x <= u, y <= v}
    (-inf where none is dominated, NaN where a dominated measure is NaN)
    by a test against every live slot of the log: K20 on CUDA tensors, the
    plain version on CPU tensors.  ``delta_dommax2d.launches`` counts the
    kernel launches.

    K20 takes the ``DeltaBuffer2D`` layout as given: the log sorted by x,
    and from the first ``big_sentinel`` x on every slot holds (sentinel,
    sentinel, 0).  It stops at the first tile of the log that starts on the
    sentinel, and a corner that dominates the sentinel takes the skipped
    slots' measure 0 back in.  The plain version scans every slot of any
    log."""
    if u.device.type == "cpu":
        return delta_dommax2d_plain(u, v, keys_x, keys_y, wv)
    Q, D, out, ptrs = _scan2d_args("delta_dommax2d", (u, v),
                                   (keys_x, keys_y, wv))
    if Q:
        lib = _build.library()
        # the kernel takes each chunk's maxima, then their max in chunk order
        part = torch.empty((lib.polyfit_delta_dommax2d_chunks(D), Q),
                           dtype=out.dtype, device=out.device)
        _build.check(lib.polyfit_delta_dommax2d(
            *ptrs, part.data_ptr(), Q, D, _SENTINEL,
            _build.stream(out.device)), "delta_dommax2d")
        delta_dommax2d.launches += 1
    return out


delta_dommax2d.launches = 0
