"""Branch-free segment location: the locate half of the locate->gather
kernels, and kernel K1.

The twin of the 1-D part of ``repro.kernels.locate``.  Plain torch versions
of the device functions every gather kernel inlines:

* ``bsearch_count`` — a branch-free binary search over a sorted array,
  returning per-lane ``searchsorted`` counts in ceil(log2 n) + 1 probe
  rounds; each round is one clamped gather + compare + select.
* ``locate_segments`` — clip(searchsorted(seg_lo, q, right) - 1, 0), the
  gather-path twin of ``core.poly.locate``.
* ``floor_log2`` and ``rmq_gather`` — the O(1) sparse-table range max.

``locate`` is the wrapper over K1 (``csrc/polyfit_kernels.cu``,
``locate_kernel``), the twin of ``locate_pallas``: on CUDA tensors it
launches the kernel, on CPU tensors it runs ``locate_segments``.  The CUDA
versions of the device functions live in ``csrc/locate.cuh``.

Sentinel-padded tails need no special casing: the padding value exceeds
every real key, so the counts never reach it.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["bsearch_count", "locate_segments", "floor_log2", "rmq_gather",
           "locate"]


def bsearch_count(keys: torch.Tensor, q: torch.Tensor,
                  side: str = "right") -> torch.Tensor:
    """Per-lane ``searchsorted(keys, q, side)`` in ceil(log2 n) + 1 rounds.

    Returns the number of ``keys`` entries <= q (side='right') or < q
    (side='left') as int32.  ``keys`` must be sorted ascending; each round
    probes index ``c + step - 1`` (clamped) and advances the count when the
    probe satisfies the predicate.
    """
    n = keys.shape[0]
    c = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    step = 1 << max(0, (n - 1).bit_length())   # bit_ceil(n)
    while step >= 1:
        probe = c + (step - 1)
        pv = keys[torch.clamp(probe, max=n - 1)]
        ok = (pv <= q) if side == "right" else (pv < q)
        c = torch.where((probe <= n - 1) & ok, c + step, c)
        step >>= 1
    return c


def locate_segments(seg_lo: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Segment id containing q — the gather-path twin of ``core.poly.locate``
    (clip(searchsorted(seg_lo, q, 'right') - 1, 0, H-1))."""
    return torch.clamp(bsearch_count(seg_lo, q, side="right") - 1, min=0)


def floor_log2(length: torch.Tensor, max_levels: int) -> torch.Tensor:
    """floor(log2(length)) for int tensors with 1 <= length < 2^max_levels
    (0 for length < 1) — a static sum of compares, no float log."""
    k = torch.zeros(length.shape, dtype=torch.int32, device=length.device)
    for i in range(1, max_levels):
        k = k + (length >= (1 << i)).to(torch.int32)
    return k


def rmq_gather(st: torch.Tensor, i0: torch.Tensor,
               i1: torch.Tensor) -> torch.Tensor:
    """Max over [i0, i1) against a (L, n) sparse table; empty -> -inf.

    Two flattened gathers per lane — the same two-window decomposition as
    ``core.exact.sparse_table_range_max``, so results are bit-identical.
    """
    levels, n = st.shape
    flat = st.reshape(-1)
    length = torch.clamp(i1 - i0, min=0)
    lvl = floor_log2(torch.clamp(length, min=1), levels)
    pow2 = torch.bitwise_left_shift(torch.ones_like(lvl), lvl)
    left = flat[lvl * n + torch.clamp(i0, max=n - 1)]
    right = flat[lvl * n + torch.clamp(i1 - pow2, 0, n - 1)]
    return torch.where(length > 0, torch.maximum(left, right), -torch.inf)


def locate(q: torch.Tensor, seg_lo: torch.Tensor) -> torch.Tensor:
    """Segment id per query key: (Q,) int32 against sorted (H,) ``seg_lo``.

    K1 on CUDA tensors (one thread per query, ceil(log2 H) + 1 probe
    rounds); ``locate_segments`` on CPU tensors.  ``locate.launches``
    counts the kernel launches.
    """
    if q.device.type == "cpu":
        return locate_segments(seg_lo, q)
    _build.require_cuda("locate", q, seg_lo)
    Q, H = q.shape[0], seg_lo.shape[0]
    if H < 1:
        raise ValueError("locate: seg_lo must not be empty")
    out = torch.empty(Q, dtype=torch.int32, device=q.device)
    if Q:
        _build.check(_build.library().polyfit_locate(
            q.data_ptr(), seg_lo.data_ptr(), out.data_ptr(), Q, H,
            _build.stream(q.device)), "locate")
        locate.launches += 1
    return out


locate.launches = 0
