"""Canonical device-resident query plans (1-D).

The twin of the 1-D part of ``repro.engine.plan``.  An ``IndexPlan`` is the
single layout every backend executes against.  It bundles, per index:

* the tile-padded flat segment table (``seg_lo``/``seg_next``/``seg_hi``/
  ``coeffs``/``seg_agg``), padded to a multiple of ``bh`` = 512 rows like
  the reference, so the plan's shapes equal the reference plan's (padding
  uses a huge-but-finite sentinel: +-inf would give 0*inf = NaN in the
  one-hot scan kernels);
* the unpadded sparse table ``st`` over per-segment aggregates (MAX/MIN);
* the exact-refinement arrays (sorted keys + prefix CF, or keys + measure
  sparse table), so the Lemma 5.2/5.4 Q_rel test and the refinement run
  on the device with no host round trip.

``plan_from_numpy`` carries a reference plan across (its fields as numpy),
so the query path can be held to the reference apart from construction.
The 2-D plan comes with its slice (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from .. import DTYPE
from ..core.index import PolyFitIndex1D

__all__ = ["IndexPlan", "build_plan", "plan_from_numpy", "big_sentinel",
           "pad_to_multiple", "DEFAULT_BH", "ARRAY_FIELDS", "META_FIELDS"]

DEFAULT_BH = 512

ARRAY_FIELDS = ("seg_lo", "seg_next", "seg_hi", "coeffs", "seg_agg", "st",
                "ref_keys", "ref_cf", "ref_st", "seg_err")
META_FIELDS = ("agg", "deg", "delta", "h", "n", "bh")


def big_sentinel(dtype) -> float:
    """Huge-but-finite padding value (finfo.max/4): +-inf would produce
    0*inf = NaN inside one-hot matmuls, so padding and open upper
    boundaries use a finite sentinel."""
    return float(torch.finfo(dtype).max) / 4


def pad_to_multiple(x: torch.Tensor, mult: int, fill) -> torch.Tensor:
    p = (-x.shape[0]) % mult
    if p == 0:
        return x
    return torch.cat([x, x.new_full((p,) + tuple(x.shape[1:]), fill)])


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """Device-resident 1-D query plan (all backends execute against this)."""

    # -- metadata --------------------------------------------------------
    agg: str                 # 'sum' | 'count' | 'max' | 'min'
    deg: int
    delta: float
    h: int                   # true segment count (<= padded length)
    n: int                   # dataset size
    bh: int                  # segment tile size the padding respects
    # -- tile-padded flat segment table (kernel ABI) --------------------
    seg_lo: torch.Tensor     # (Hp,) sentinel-padded
    seg_next: torch.Tensor   # (Hp,) next segment's lo; sentinel for last/pad
    seg_hi: torch.Tensor     # (Hp,)
    coeffs: torch.Tensor     # (Hp, deg+1) zero-padded
    seg_agg: torch.Tensor    # (Hp,) -inf padded (max/min; zeros for sum)
    # -- interior-MAX sparse table -----------------------------------------
    st: Optional[torch.Tensor]        # (L, h) (max/min only)
    # -- exact refinement arrays (fused Q_rel path) ----------------------
    ref_keys: Optional[torch.Tensor]  # (n,) sorted keys
    ref_cf: Optional[torch.Tensor]    # (n,) inclusive prefix CF (sum/count)
    ref_st: Optional[torch.Tensor]    # (L2, n) measure sparse table (max/min)
    # -- per-segment certified fit error E(I) -----------------------------
    seg_err: Optional[torch.Tensor] = None   # (Hp,) delta-padded

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.seg_lo.device

    @property
    def domain_lo(self) -> torch.Tensor:
        return self.seg_lo[0]

    def size_bytes(self) -> int:
        """Learned-structure size (paper's metric; excludes refinement).

        Counts the ``h`` real segments only — tile padding is an execution
        artifact, not index content.
        """
        it = self.seg_lo.element_size()
        # seg_lo + seg_next + seg_hi + seg_agg + coefficient rows
        total = self.h * (4 * it + (self.deg + 1) * self.coeffs.element_size())
        if self.st is not None:
            total += self.st.numel() * self.st.element_size()
        return int(total)

    def device_bytes(self) -> int:
        """Bytes every tensor of the plan holds on its device (padding and
        refinement arrays included)."""
        return int(sum(t.numel() * t.element_size()
                       for t in (getattr(self, f) for f in ARRAY_FIELDS)
                       if t is not None))


def build_plan(index: PolyFitIndex1D, dtype: torch.dtype = DTYPE,
               bh: int = DEFAULT_BH, with_exact: bool = True) -> IndexPlan:
    """Lower a constructed PolyFitIndex1D into the canonical device plan
    (on the index's device)."""
    big = big_sentinel(dtype)
    seg_lo = index.seg_lo.to(dtype)
    seg_hi = index.seg_hi.to(dtype)
    nxt = torch.cat([seg_lo[1:], seg_lo.new_full((1,), big)])
    coeffs = index.coeffs.to(dtype)
    agg = (index.seg_agg.to(dtype) if index.seg_agg is not None
           else torch.zeros_like(seg_lo))

    ref_keys = ref_cf = ref_st = None
    if with_exact:
        if index.exact_sum is not None:
            ref_keys = index.exact_sum.keys
            ref_cf = index.exact_sum.cf
        elif index.exact_max is not None:
            ref_keys = index.exact_max.keys
            ref_st = index.exact_max.st

    seg_err = None
    if index.seg_err is not None:
        seg_err = pad_to_multiple(
            torch.as_tensor(index.seg_err, dtype=dtype, device=seg_lo.device),
            bh, float(index.delta))
    return IndexPlan(
        agg=index.agg, deg=index.deg, delta=float(index.delta),
        h=int(seg_lo.shape[0]), n=int(index.n), bh=int(bh),
        seg_lo=pad_to_multiple(seg_lo, bh, big),
        seg_next=pad_to_multiple(nxt, bh, big),
        seg_hi=pad_to_multiple(seg_hi, bh, big),
        coeffs=pad_to_multiple(coeffs, bh, 0.0),
        seg_agg=pad_to_multiple(agg, bh, -torch.inf),
        st=index.st, ref_keys=ref_keys, ref_cf=ref_cf, ref_st=ref_st,
        seg_err=seg_err,
    )


def plan_from_numpy(fields: Mapping, device) -> IndexPlan:
    """A port ``IndexPlan`` from a reference ``IndexPlan``'s fields.

    ``fields`` maps every name in ``ARRAY_FIELDS`` to a numpy array (or
    None where the reference holds None) and every name in ``META_FIELDS``
    to its scalar.  Arrays keep their dtype and are copied to ``device``.
    """
    device = torch.device(device)
    arrays = {f: (None if fields.get(f) is None else
                  torch.as_tensor(np.array(fields[f]), device=device))
              for f in ARRAY_FIELDS}
    return IndexPlan(
        agg=str(fields["agg"]), deg=int(fields["deg"]),
        delta=float(fields["delta"]), h=int(fields["h"]), n=int(fields["n"]),
        bh=int(fields["bh"]), **arrays)
