"""Exact range-aggregate baselines (paper §3.2) — the refinement structures.

The twin of ``repro.core.exact``:

* ``ExactSum`` — the key-cumulative array of §3.2.1: sorted keys + CF_sum
  prefix array; a range SUM is two binary searches (Eq. 5).
* ``ExactMax`` — the aggregate max-tree of §3.2.2 as a **sparse table**
  (binary lifting): ``st[j, i] = max(m[i : i+2^j])``.  A range max over any
  [i, j) is the max of two overlapping power-of-two windows — O(1),
  branch-free, vectorized over query batches.

The sparse table is built on the host with numpy; the query functions are
plain torch ops on whichever device holds the tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DTYPE

__all__ = ["ExactSum", "ExactMax", "build_sparse_table", "sparse_table_range_max"]


def build_sparse_table(m: np.ndarray) -> np.ndarray:
    """st[j, i] = max(m[i : i + 2^j]) (clipped at the end).  (L, n)."""
    m = np.asarray(m)
    n = len(m)
    levels = max(1, int(np.floor(np.log2(max(n, 1)))) + 1)
    st = np.full((levels, n), -np.inf, dtype=np.float64)
    st[0] = m
    for j in range(1, levels):
        half = 1 << (j - 1)
        right = np.concatenate([st[j - 1, half:], np.full(half, -np.inf)])
        st[j] = np.maximum(st[j - 1], right)
    return st


def sparse_table_range_max(st: torch.Tensor, i: torch.Tensor,
                           j: torch.Tensor) -> torch.Tensor:
    """Vectorized max over [i, j) per query; empty ranges give -inf.

    i, j: int tensors of equal shape.  O(1) per query: two gathers + max.
    """
    n = st.shape[1]
    length = torch.clamp(j - i, min=0)
    # floor(log2(length)); length==0 handled via -inf mask
    lvl = torch.where(
        length > 0,
        torch.floor(torch.log2(torch.clamp(length, min=1).to(DTYPE))).long(),
        0)
    pow2 = torch.bitwise_left_shift(torch.ones_like(lvl), lvl)
    # empty ranges may sit past the end (i == n); their lanes are masked
    # below, so clamping keeps the gather in bounds without changing answers
    left = st[lvl, torch.clamp(i, max=n - 1)]
    right = st[lvl, torch.clamp(j - pow2, min=0)]
    out = torch.maximum(left, right)
    return torch.where(length > 0, out, -torch.inf)


@dataclasses.dataclass(frozen=True)
class ExactSum:
    """Sorted keys + cumulative measure array; exact SUM/COUNT in O(log n)."""

    keys: torch.Tensor     # (n,) sorted
    cf: torch.Tensor       # (n,) CF_sum at each key (inclusive prefix sum)

    @staticmethod
    def build(keys: np.ndarray, measures: np.ndarray,
              device=None) -> "ExactSum":
        order = np.argsort(keys, kind="stable")
        k = np.asarray(keys, np.float64)[order]
        m = np.asarray(measures, np.float64)[order]
        return ExactSum(torch.as_tensor(k, device=device),
                        torch.as_tensor(np.cumsum(m), device=device))

    def cf_at(self, q: torch.Tensor) -> torch.Tensor:
        """CF_sum(q) = sum of measures with key <= q (vectorized)."""
        idx = torch.searchsorted(self.keys, q, right=True)
        padded = torch.cat([self.cf.new_zeros(1), self.cf])
        return padded[idx]

    def query(self, lq: torch.Tensor, uq: torch.Tensor) -> torch.Tensor:
        """Exact R_sum(D, [lq, uq]) for batches of ranges (Eq. 5).

        Inclusive endpoints: sum over keys in [lq, uq].
        """
        hi = self.cf_at(uq)
        lo_idx = torch.searchsorted(self.keys, lq)
        padded = torch.cat([self.cf.new_zeros(1), self.cf])
        return hi - padded[lo_idx]


@dataclasses.dataclass(frozen=True)
class ExactMax:
    """Sorted keys + sparse table over measures; exact MAX in O(1)/query."""

    keys: torch.Tensor       # (n,) sorted
    measures: torch.Tensor   # (n,)
    st: torch.Tensor         # (L, n) sparse table

    @staticmethod
    def build(keys: np.ndarray, measures: np.ndarray,
              device=None) -> "ExactMax":
        order = np.argsort(keys, kind="stable")
        k = np.asarray(keys, np.float64)[order]
        m = np.asarray(measures, np.float64)[order]
        return ExactMax(torch.as_tensor(k, device=device),
                        torch.as_tensor(m, device=device),
                        torch.as_tensor(build_sparse_table(m), device=device))

    def query(self, lq: torch.Tensor, uq: torch.Tensor) -> torch.Tensor:
        """Exact R_max(D, [lq, uq]), inclusive; empty ranges -> -inf."""
        i = torch.searchsorted(self.keys, lq)
        j = torch.searchsorted(self.keys, uq, right=True)
        return sparse_table_range_max(self.st, i, j)
