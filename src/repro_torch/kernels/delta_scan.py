"""Exact delta-buffer corrections for dynamic plans: kernels K5 and K6.

The twin of the 1-D locate->gather part of ``repro.kernels.delta_scan``.
A ``DynamicEngine`` (``engine/dynamic.py``) buffers inserts and deletes in
fixed-capacity, sorted, sentinel-padded logs between merges, and keeps on
append the structures these corrections read:

* ``delta_sum_gather`` (K5) — sum of buffered measures with key in
  (lq, uq]: two binary searches into the sorted log and the difference of
  its exclusive prefix sums ``cf`` ((cap + 1,), ``cf[i] = sum(vals[:i])``);
* ``delta_max_gather`` (K6) — max of buffered measures with key in
  [lq, uq]: the log's covered span [#(keys < lq), #(keys <= uq)) and an
  O(1) two-gather range max against the log's (L, cap) sparse table;
  an empty span gives -inf.

Sentinel slots hold a huge-but-finite key and measure 0, so they fail
every membership test and leave the prefix sums flat: neither correction
needs the fill level.

Each ``*_plain`` function is the plain torch version, in the kernel's order
of operations; each wrapper launches its CUDA kernel
(``csrc/polyfit_kernels.cu``) on CUDA tensors and runs the plain version on
CPU tensors.  The one-hot scan twins (``delta_sum_pallas``,
``delta_max_pallas``) come with the ``cuda_scan`` backend (ROADMAP Queue 2,
K16 and K17).
"""
from __future__ import annotations

import torch

from . import _build
from .locate import bsearch_count, rmq_gather

__all__ = ["delta_sum_gather_plain", "delta_sum_gather",
           "delta_max_gather_plain", "delta_max_gather"]


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
    tensors.  ``delta_max_gather.launches`` counts the kernel launches."""
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
