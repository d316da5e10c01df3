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
  on the device with no host round trip;
* the sorted keys' search tree ``ref_tree`` (``kernels.locate.search_tree``),
  which K1 descends on the card backends and K4 for its snap to the key
  grid, and ``seg_tree``, the search tree of the padded ``seg_lo``, which
  K2, K3 and K21 descend: the port's own, outside ``ARRAY_FIELDS`` (those
  mirror the reference's plan).

``IndexPlan2D`` is the 2-key analogue: the quadtree descent arrays (the
``torch`` backend), the flattened tile-padded leaf table for the kernels
and the one-hot ``ref`` oracles, and the merge-sort-tree arrays for exact
refinement (with ``ref_xs_tree``, the x keys' search tree, for K1).  The
leaf table is stored in Morton (Z-order), so the
locate->gather kernels binary-search it: ``xcuts``/``ycuts`` are the exact
dyadic split grids (rebuilt with the tree's own midpoint recursion, so cell
resolution is bit-identical to the descent's tie rule) and ``leaf_z`` the
sorted per-leaf Morton interval starts.  Plans deeper than
``MAX_MORTON_DEPTH`` have no ``leaf_z`` and run the scan kernels.

``plan_from_numpy`` / ``plan2d_from_numpy`` carry a reference plan across
(its fields as numpy), so the query path can be held to the reference
apart from construction.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .. import DTYPE
from ..core.index import PolyFitIndex1D
from ..core.index2d import PolyFitIndex2D
from ..kernels.locate import (INT_SENTINEL, MAX_MORTON_DEPTH, dyadic_cuts,
                              leaf_morton_codes, search_tree)

__all__ = ["IndexPlan", "IndexPlan2D", "build_plan", "build_plan_2d",
           "plan_from_numpy", "plan2d_from_numpy", "big_sentinel",
           "pad_to_multiple", "DEFAULT_BH", "ARRAY_FIELDS", "META_FIELDS",
           "ARRAY_FIELDS_2D", "META_FIELDS_2D"]

DEFAULT_BH = 512

ARRAY_FIELDS = ("seg_lo", "seg_next", "seg_hi", "coeffs", "seg_agg", "st",
                "ref_keys", "ref_cf", "ref_st", "seg_err")
META_FIELDS = ("agg", "deg", "delta", "h", "n", "bh")
ARRAY_FIELDS_2D = ("children", "leaf_of", "bounds", "leaf_nodes",
                   "qt_coeffs", "leaf_mx0", "leaf_mx1", "leaf_my0",
                   "leaf_my1", "leaf_bounds", "leaf_coeffs", "leaf_z",
                   "xcuts", "ycuts", "ref_xs", "ref_ys_levels", "leaf_agg",
                   "ref_wcum", "ref_wpmax")
META_FIELDS_2D = ("deg", "delta", "n", "n_leaves", "max_depth", "bh", "root",
                  "agg")


def _device_bytes(plan, fields) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in (getattr(plan, f) for f in fields)
                   if t is not None))


def _tree_bytes(tree) -> int:
    return 0 if tree is None else tree.numel() * tree.element_size()


def _searchable(keys):
    """``keys`` and their search tree (None, None for no keys), the keys
    copied where they are not 16-byte aligned, as K1 reads them."""
    if keys is None:
        return None, None
    if keys.data_ptr() % 16:
        keys = keys.clone()
    return keys, search_tree(keys)


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
    # -- K1's and K4's search tree over ref_keys (not in ARRAY_FIELDS) ----
    ref_tree: Optional[torch.Tensor] = None  # (nodes, 4)
    # -- K2's, K3's and K21's search tree over seg_lo (not in ARRAY_FIELDS)
    seg_tree: Optional[torch.Tensor] = None  # (nodes, 4)

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
        """Bytes the reference plan's arrays (``ARRAY_FIELDS``) hold on the
        device, padding and refinement arrays included; the port's search
        tree is counted by ``tree_bytes``."""
        return _device_bytes(self, ARRAY_FIELDS)

    def tree_bytes(self) -> int:
        """Bytes of the port's search trees, ``ref_tree`` (K1's and K4's)
        and ``seg_tree`` (K2's, K3's and K21's); 0 without them."""
        return _tree_bytes(self.ref_tree) + _tree_bytes(self.seg_tree)


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
    ref_keys, ref_tree = _searchable(ref_keys)

    seg_err = None
    if index.seg_err is not None:
        seg_err = pad_to_multiple(
            torch.as_tensor(index.seg_err, dtype=dtype, device=seg_lo.device),
            bh, float(index.delta))
    h = int(seg_lo.shape[0])
    seg_lo = pad_to_multiple(seg_lo, bh, big)
    return IndexPlan(
        agg=index.agg, deg=index.deg, delta=float(index.delta),
        h=h, n=int(index.n), bh=int(bh), seg_lo=seg_lo,
        seg_next=pad_to_multiple(nxt, bh, big),
        seg_hi=pad_to_multiple(seg_hi, bh, big),
        coeffs=pad_to_multiple(coeffs, bh, 0.0),
        seg_agg=pad_to_multiple(agg, bh, -torch.inf),
        st=index.st, ref_keys=ref_keys, ref_cf=ref_cf, ref_st=ref_st,
        seg_err=seg_err, ref_tree=ref_tree, seg_tree=search_tree(seg_lo),
    )


def plan_from_numpy(fields: Mapping, device) -> IndexPlan:
    """A port ``IndexPlan`` from a reference ``IndexPlan``'s fields.

    ``fields`` maps every name in ``ARRAY_FIELDS`` to a numpy array (or
    None where the reference holds None) and every name in ``META_FIELDS``
    to its scalar.  Arrays keep their dtype and are copied to ``device``;
    the search trees are built from ``ref_keys`` and ``seg_lo``.
    """
    device = torch.device(device)
    arrays = {f: (None if fields.get(f) is None else
                  torch.as_tensor(np.array(fields[f]), device=device))
              for f in ARRAY_FIELDS}
    arrays["ref_keys"], arrays["ref_tree"] = _searchable(arrays["ref_keys"])
    arrays["seg_tree"] = search_tree(arrays["seg_lo"])
    return IndexPlan(
        agg=str(fields["agg"]), deg=int(fields["deg"]),
        delta=float(fields["delta"]), h=int(fields["h"]), n=int(fields["n"]),
        bh=int(fields["bh"]), **arrays)


@dataclasses.dataclass(frozen=True)
class IndexPlan2D:
    """Device-resident 2-key plan (quadtree + flat leaf table)."""

    # -- metadata --------------------------------------------------------
    deg: int
    delta: float
    n: int
    n_leaves: int
    max_depth: int
    bh: int
    root: Tuple[float, float, float, float]   # x0, x1, y0, y1
    # -- quadtree descent arrays ('torch' backend) ------------------------
    children: torch.Tensor    # (N, 4) int32
    leaf_of: torch.Tensor     # (N,) int32
    bounds: torch.Tensor      # (N, 4)
    leaf_nodes: torch.Tensor  # (n_leaves,) int32
    qt_coeffs: torch.Tensor   # (n_leaves, (deg+1)^2) — descent-path coeffs
    # -- flat tile-padded leaf table (kernels, 'ref'), Morton order --------
    leaf_mx0: torch.Tensor    # (Lp,) membership lower x (sentinel-padded)
    leaf_mx1: torch.Tensor    # (Lp,) membership upper x (sentinel on root edge)
    leaf_my0: torch.Tensor    # (Lp,)
    leaf_my1: torch.Tensor    # (Lp,)
    leaf_bounds: torch.Tensor  # (Lp, 4) actual x0,x1,y0,y1 (scaling spans)
    leaf_coeffs: torch.Tensor  # (Lp, (deg+1)^2)
    # -- locate->gather extras (None when max_depth exceeds Morton range) -
    leaf_z: Optional[torch.Tensor]  # (Lp,) int32 sorted z-interval starts
    xcuts: Optional[torch.Tensor]   # (2^max_depth - 1,) exact split grid
    ycuts: Optional[torch.Tensor]   # (2^max_depth - 1,)
    # -- exact refinement (merge-sort tree) ------------------------------
    ref_xs: Optional[torch.Tensor]         # (n,)
    ref_ys_levels: Optional[torch.Tensor]  # (L, n)
    # -- measure-carrying extension ----------------------------------------
    agg: str = "count2d"                   # 'count2d'|'sum2d'|'max2d'|'min2d'
    leaf_agg: Optional[torch.Tensor] = None   # (Lp,) exact per-leaf measure
    ref_wcum: Optional[torch.Tensor] = None   # (L, n) block prefix sums
    ref_wpmax: Optional[torch.Tensor] = None  # (L, n) block prefix maxima
    # -- K1's search tree over ref_xs (not in ARRAY_FIELDS_2D) -------------
    ref_xs_tree: Optional[torch.Tensor] = None  # (nodes, 4)

    @property
    def dtype(self) -> torch.dtype:
        return self.leaf_coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.leaf_coeffs.device

    def size_bytes(self) -> int:
        """Learned-structure size: topology + per-leaf fits (unpadded)."""
        nb = lambda t: t.numel() * t.element_size()
        total = nb(self.children) + nb(self.bounds) + nb(self.qt_coeffs)
        if self.leaf_agg is not None:
            total += self.n_leaves * self.leaf_agg.element_size()
        return int(total)

    def device_bytes(self) -> int:
        """Bytes the reference plan's arrays (``ARRAY_FIELDS_2D``) hold on
        the device, padding and refinement arrays included; the port's
        search tree is counted by ``tree_bytes``."""
        return _device_bytes(self, ARRAY_FIELDS_2D)

    def tree_bytes(self) -> int:
        """Bytes of ``ref_xs_tree``, K1's search tree (0 without one)."""
        return _tree_bytes(self.ref_xs_tree)


def build_plan_2d(index: PolyFitIndex2D, dtype: torch.dtype = DTYPE,
                  bh: int = DEFAULT_BH,
                  with_exact: bool = True) -> IndexPlan2D:
    """Lower a PolyFitIndex2D into the canonical device plan (on the
    index's device).

    The flat leaf table reproduces the quadtree descent's tie rule with pure
    interval membership: a coordinate exactly on an interior split line
    belongs to the higher-coordinate leaf (the descent tests ``>= mid``), so
    membership is [x0, x1) x [y0, y1) — except leaves touching the root's
    right/top edge, whose upper membership bound widens to the sentinel so
    the root's own boundary stays covered.
    """
    big = big_sentinel(dtype)
    dev = index.device
    x0r, x1r, y0r, y1r = (float(b) for b in index.root_bounds)
    bounds = index.bounds.cpu().numpy()
    lb = bounds[index.leaf_nodes.cpu().numpy()]   # (L, 4) f64
    coeffs = index.coeffs.cpu().numpy()
    leaf_agg = (None if index.leaf_agg is None
                else index.leaf_agg.cpu().numpy())
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # locate->gather precomputation: exact dyadic split grids + Morton
    # z-interval starts, the whole leaf table reordered by z so the scan
    # path (order-independent) and the binary-search path share one table
    leaf_z = xcuts = ycuts = None
    depth = int(index.max_depth)
    if depth <= MAX_MORTON_DEPTH:
        xc = dyadic_cuts(x0r, x1r, depth)
        yc = dyadic_cuts(y0r, y1r, depth)
        if (np.all(np.diff(xc) > 0) if len(xc) else True) and (
                np.all(np.diff(yc) > 0) if len(yc) else True):
            z = leaf_morton_codes(lb, xc, yc, depth)
            order = np.argsort(z)
            lb = lb[order]
            coeffs = coeffs[order]
            if leaf_agg is not None:
                leaf_agg = leaf_agg[order]
            leaf_z = pad_to_multiple(
                torch.as_tensor(z[order], dtype=torch.int32, device=dev), bh,
                INT_SENTINEL)
            # empty cut grids (depth 0) keep a sentinel entry so the kernel
            # always has a non-empty array to search (count stays 0)
            xcuts = to(xc if len(xc) else [big])
            ycuts = to(yc if len(yc) else [big])

    mx0 = lb[:, 0]
    mx1 = np.where(lb[:, 1] >= x1r, big, lb[:, 1])
    my0 = lb[:, 2]
    my1 = np.where(lb[:, 3] >= y1r, big, lb[:, 3])

    ref_xs = ref_ys = ref_wcum = ref_wpmax = None
    if with_exact and index.exact is not None:
        ref_xs = index.exact.xs
        ref_ys = index.exact.ys_levels
        ref_wcum = index.exact.wcum_levels
        ref_wpmax = index.exact.wpmax_levels
    ref_xs, ref_xs_tree = _searchable(ref_xs)

    return IndexPlan2D(
        deg=index.deg, delta=float(index.delta), n=int(index.n),
        n_leaves=index.n_leaves, max_depth=index.max_depth, bh=int(bh),
        root=(x0r, x1r, y0r, y1r),
        children=index.children, leaf_of=index.leaf_of,
        bounds=index.bounds.to(dtype), leaf_nodes=index.leaf_nodes,
        qt_coeffs=index.coeffs.to(dtype),
        leaf_mx0=pad_to_multiple(to(mx0), bh, big),
        leaf_mx1=pad_to_multiple(to(mx1), bh, big),
        leaf_my0=pad_to_multiple(to(my0), bh, big),
        leaf_my1=pad_to_multiple(to(my1), bh, big),
        leaf_bounds=pad_to_multiple(to(lb), bh, 0.0),
        leaf_coeffs=pad_to_multiple(to(coeffs), bh, 0.0),
        leaf_z=leaf_z, xcuts=xcuts, ycuts=ycuts,
        ref_xs=ref_xs, ref_ys_levels=ref_ys,
        agg=index.agg,
        leaf_agg=(None if leaf_agg is None
                  else pad_to_multiple(to(leaf_agg), bh, 0.0)),
        ref_wcum=ref_wcum, ref_wpmax=ref_wpmax, ref_xs_tree=ref_xs_tree,
    )


def plan2d_from_numpy(fields: Mapping, device) -> IndexPlan2D:
    """A port ``IndexPlan2D`` from a reference ``IndexPlan2D``'s fields:
    every name in ``ARRAY_FIELDS_2D`` maps to a numpy array (or None) and
    every name in ``META_FIELDS_2D`` to its value.  Arrays keep their dtype
    and are copied to ``device``; the x keys' search tree is built from
    ``ref_xs``."""
    device = torch.device(device)
    arrays = {f: (None if fields.get(f) is None else
                  torch.as_tensor(np.array(fields[f]), device=device))
              for f in ARRAY_FIELDS_2D}
    arrays["ref_xs"], arrays["ref_xs_tree"] = _searchable(arrays["ref_xs"])
    return IndexPlan2D(
        deg=int(fields["deg"]), delta=float(fields["delta"]),
        n=int(fields["n"]), n_leaves=int(fields["n_leaves"]),
        max_depth=int(fields["max_depth"]), bh=int(fields["bh"]),
        root=tuple(float(b) for b in fields["root"]),
        agg=str(fields["agg"]), **arrays)
