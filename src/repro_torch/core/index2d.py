"""PolyFit with two keys (paper §6): quadtree-segmented bivariate surfaces.

The twin of ``repro.core.index2d``.  Pipeline:

1. The fitted function per aggregate family:
   * ``count2d`` — ``CF_count(u, v)`` = #points with x<=u and y<=v (Def. 6.2);
   * ``sum2d``   — ``CF_sum(u, v)`` = sum of measures over the dominated set
     (so rectangle SUM decomposes by the same 4-corner inclusion-exclusion);
   * ``max2d``/``min2d`` — the *dominance max* staircase
     ``DMAX(u, v) = max{w_i : x_i <= u, y_i <= v}`` (MIN negates measures),
     floored at the dataset minimum so the function is total and monotone.
   Exact values come from a *weighted* merge-sort tree (numpy block sorts;
   O(n log^2 n)).
2. Quadtree segmentation (Fig. 10): a region whose best bivariate fit
   P(u,v) = sum a_ij u^i v^j (i,j <= deg) violates E(I) <= delta is split
   into 4 children at the midpoint.  Constraints are the data points inside
   the region plus a fixed evaluation grid (all with exact F values).  Each
   leaf carries its certified fit error (``leaf_err``, the source of
   ``certified_delta``) and its exact measure aggregate (``leaf_agg``).
3. Query: 4-corner inclusion-exclusion for COUNT/SUM (Eq. 19), a single
   corner evaluation for dominance MAX/MIN; leaves are found with a
   fixed-depth quadtree descent, vectorized over the batch.
4. Guarantees: delta = eps_abs/4 (Lemma 6.3) for COUNT/SUM, eps_abs for
   dominance MAX/MIN; the Q_rel tests (Lemma 6.4 / 5.4) route failing
   queries to the exact merge-sort-tree answers.

Construction runs on the host with numpy and scipy, with the reference's
own code (the same LPs, the same ``default_rng(0xF17)`` subsample draws in
the same order), so the port's tree equals the reference's node for node;
the built index lives on the query device as float64 tensors.
``selective_refit_2d`` absorbs a merged update batch by refitting only the
leaves the changed points' dominance boundaries cross (the merge pass of
``engine.DynamicEngine2D``).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import DTYPE, resolve_device
from .queries import QueryResult

__all__ = [
    "AGGS_2D", "dominance_rank", "count_dominated", "MergeSortTree",
    "PolyFitIndex2D", "build_index_2d", "index2d_from_numpy",
    "query_count_2d", "query_sum_2d", "query_dommax_2d",
    "mst_count_prefix", "mst_weighted_prefix", "mst_cf", "mst_cf_sum",
    "mst_dommax", "quadtree_locate", "quadtree_eval_cf", "bivariate_horner",
    "selective_refit_2d",
]

AGGS_2D = ("count2d", "sum2d", "max2d", "min2d")


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array (no copy for a CPU tensor)."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# offline exact CF_count evaluation
# ---------------------------------------------------------------------------

def count_dominated(px: np.ndarray, py: np.ndarray,
                    qx: np.ndarray, qy: np.ndarray) -> np.ndarray:
    """For each query point (qx_j, qy_j): #data points with x<=qx and y<=qy."""
    tree = MergeSortTree.build(px, py)
    return _host(tree.cf(torch.as_tensor(np.asarray(qx, np.float64)),
                         torch.as_tensor(np.asarray(qy, np.float64))))


def dominance_rank(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """CF_count at every data point (inclusive of the point itself)."""
    return count_dominated(px, py, px, py)


# ---------------------------------------------------------------------------
# exact online backend: merge sort tree (refinement + exact baseline)
# ---------------------------------------------------------------------------

def mst_count_prefix(xs: torch.Tensor, ys_levels: torch.Tensor,
                     i: torch.Tensor, v: torch.Tensor,
                     strict: bool = False) -> torch.Tensor:
    """#points among x-rank [0, i) with y <= v (or y < v if strict).

    Array-level, so the engine runs it over ``IndexPlan2D`` refinement
    arrays: per level one binary search over a sorted block, levels x
    (l + 1) rounds of small torch ops in all.
    """
    n = int(xs.shape[0])
    levels = int(ys_levels.shape[0])
    i = i.long()
    total = torch.zeros_like(i)
    pos = torch.zeros_like(i)
    for l in range(levels - 1, -1, -1):
        b = 1 << l
        take = pos + b <= i
        # binary search for v in ys_levels[l][pos : pos+b] (sorted run)
        lo = torch.zeros_like(i)
        hi = torch.full_like(i, b)
        for _ in range(l + 1):
            active = lo < hi
            mid = (lo + hi) // 2
            idx = torch.clamp(pos + torch.clamp(mid, max=b - 1), 0, n - 1)
            y = ys_levels[l][idx]
            go_right = active & ((y < v) if strict else (y <= v))
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(active & ~go_right, mid, hi)
        total = total + torch.where(take, lo, 0)
        pos = torch.where(take, pos + b, pos)
    return total


def mst_weighted_prefix(xs: torch.Tensor, ys_levels: torch.Tensor,
                        wacc_levels: torch.Tensor, i: torch.Tensor,
                        v: torch.Tensor, *, mode: str) -> torch.Tensor:
    """Weighted dominance reduction over x-rank [0, i) with y <= v.

    ``wacc_levels`` are per-level, per-block *inclusive* prefix arrays over
    the block-y-sorted weights: prefix sums for mode='sum', prefix maxima
    for mode='max' (identities 0 / -inf).  The same block decomposition and
    in-block binary search as ``mst_count_prefix``; one extra clamped
    gather per level turns the in-block count into the block's weighted
    contribution.
    """
    if mode not in ("sum", "max"):
        raise ValueError(f"mode must be 'sum' or 'max', got {mode!r}")
    is_sum = mode == "sum"
    n = int(xs.shape[0])
    levels = int(ys_levels.shape[0])
    ident = 0.0 if is_sum else -torch.inf
    i = i.long()
    total = torch.full(i.shape, ident, dtype=wacc_levels.dtype,
                       device=i.device)
    pos = torch.zeros_like(i)
    for l in range(levels - 1, -1, -1):
        b = 1 << l
        take = pos + b <= i
        lo = torch.zeros_like(i)
        hi = torch.full_like(i, b)
        for _ in range(l + 1):
            active = lo < hi
            mid = (lo + hi) // 2
            idx = torch.clamp(pos + torch.clamp(mid, max=b - 1), 0, n - 1)
            go_right = active & (ys_levels[l][idx] <= v)
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(active & ~go_right, mid, hi)
        val = wacc_levels[l][torch.clamp(pos + lo - 1, 0, n - 1)]
        val = torch.where(take & (lo > 0), val, ident)
        total = total + val if is_sum else torch.maximum(total, val)
        pos = torch.where(take, pos + b, pos)
    return total


def mst_cf(xs: torch.Tensor, ys_levels: torch.Tensor, u, v) -> torch.Tensor:
    """CF_count(u, v) = #points with x <= u and y <= v, vectorized."""
    i = torch.searchsorted(xs, u, right=True)
    return mst_count_prefix(xs, ys_levels, i, v)


def mst_cf_sum(xs: torch.Tensor, ys_levels: torch.Tensor,
               wcum_levels: torch.Tensor, u, v) -> torch.Tensor:
    """CF_sum(u, v) = sum of measures with x <= u and y <= v, vectorized."""
    i = torch.searchsorted(xs, u, right=True)
    return mst_weighted_prefix(xs, ys_levels, wcum_levels, i, v, mode="sum")


def mst_dommax(xs: torch.Tensor, ys_levels: torch.Tensor,
               wpmax_levels: torch.Tensor, u, v) -> torch.Tensor:
    """DMAX(u, v) = max measure with x <= u and y <= v (-inf if none)."""
    i = torch.searchsorted(xs, u, right=True)
    return mst_weighted_prefix(xs, ys_levels, wpmax_levels, i, v, mode="max")


@dataclasses.dataclass(frozen=True)
class MergeSortTree:
    """Static BIT-style decomposition for exact rectangle counts — and,
    when built with weights, exact dominance sums/maxima.

    xs           (n,)   x-sorted keys
    ys_levels    (L, n) y values sorted within blocks of size 2^l at level l
    wcum_levels  (L, n) per-block inclusive prefix sums of the weights,
                        carried through the same block sorts (weighted only)
    wpmax_levels (L, n) per-block inclusive prefix maxima (weighted only)
    ws           (n,)   weights in x-sorted order (weighted only)
    """

    xs: torch.Tensor
    ys_levels: torch.Tensor
    wcum_levels: Optional[torch.Tensor] = None
    wpmax_levels: Optional[torch.Tensor] = None
    ws: Optional[torch.Tensor] = None

    @staticmethod
    def build(px: np.ndarray, py: np.ndarray,
              ws: Optional[np.ndarray] = None, device="cpu") -> "MergeSortTree":
        """The reference's numpy build; the arrays land on ``device``."""
        to = lambda a: torch.as_tensor(a, device=device)
        order = np.argsort(px, kind="stable")
        xs = np.asarray(px, np.float64)[order]
        ys = np.asarray(py, np.float64)[order]
        n = len(xs)
        levels = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
        npad = 1 << (levels - 1)
        arrs = np.empty((levels, n), np.float64)
        arrs[0] = ys  # level 0: blocks of size 1 (already "sorted")
        padded = np.full(npad, np.inf)
        padded[:n] = ys
        if ws is None:
            for l in range(1, levels):
                b = 1 << l
                # vectorized per-block sort: reshape to (npad/b, b), sort rows
                padded = np.sort(padded.reshape(-1, b), axis=1).reshape(-1)
                arrs[l] = padded[:n]
            return MergeSortTree(to(xs), to(arrs))
        w = np.asarray(ws, np.float64)[order]
        wcum = np.empty((levels, n), np.float64)
        wpmax = np.empty((levels, n), np.float64)
        wcum[0] = w
        wpmax[0] = w
        wpad = np.zeros(npad)
        wpad[:n] = w
        for l in range(1, levels):
            b = 1 << l
            yb = padded.reshape(-1, b)
            # stable per-block argsort: same sorted y values as np.sort,
            # plus the permutation to carry the weights along
            perm = np.argsort(yb, axis=1, kind="stable")
            yb = np.take_along_axis(yb, perm, axis=1)
            wb = np.take_along_axis(wpad.reshape(-1, b), perm, axis=1)
            padded = yb.reshape(-1)
            wpad = wb.reshape(-1)
            arrs[l] = padded[:n]
            wcum[l] = np.cumsum(wb, axis=1).reshape(-1)[:n]
            wpmax[l] = np.maximum.accumulate(wb, axis=1).reshape(-1)[:n]
        return MergeSortTree(to(xs), to(arrs), to(wcum), to(wpmax), to(w))

    def to(self, device) -> "MergeSortTree":
        """The same tree with every array on ``device``."""
        return MergeSortTree(*(None if a is None else a.to(device) for a in (
            self.xs, self.ys_levels, self.wcum_levels, self.wpmax_levels,
            self.ws)))

    @property
    def n(self) -> int:
        return int(self.xs.shape[0])

    def _count_prefix(self, i: torch.Tensor, v: torch.Tensor,
                      strict: bool = False) -> torch.Tensor:
        """#points among x-rank [0, i) with y <= v (or y < v if strict)."""
        return mst_count_prefix(self.xs, self.ys_levels, i, v, strict)

    def query(self, x0, x1, y0, y1) -> torch.Tensor:
        """Exact #points in [x0,x1] x [y0,y1] (inclusive), vectorized."""
        i0 = torch.searchsorted(self.xs, x0, right=False)
        i1 = torch.searchsorted(self.xs, x1, right=True)
        hi = self._count_prefix(i1, y1) - self._count_prefix(i0, y1)
        lom = (self._count_prefix(i1, y0, strict=True)
               - self._count_prefix(i0, y0, strict=True))
        return hi - lom

    def cf(self, u, v) -> torch.Tensor:
        """CF_count(u, v), vectorized."""
        return mst_cf(self.xs, self.ys_levels, u, v)

    def cf_sum(self, u, v) -> torch.Tensor:
        """CF_sum(u, v), vectorized (weighted trees only)."""
        return mst_cf_sum(self.xs, self.ys_levels, self.wcum_levels, u, v)

    def dommax(self, u, v) -> torch.Tensor:
        """Dominance max of measures (-inf if the dominated set is empty)."""
        return mst_dommax(self.xs, self.ys_levels, self.wpmax_levels, u, v)

    def cf_np(self, u, v) -> np.ndarray:
        """CF_count on the host (numpy), the construction-time oracle."""
        xs = _host(self.xs)
        ysl = _host(self.ys_levels)
        n = len(xs)
        i = np.searchsorted(xs, np.asarray(u, np.float64), side="right")
        v = np.asarray(v, np.float64)
        total = np.zeros_like(i)
        pos = np.zeros_like(i)
        for l in range(ysl.shape[0] - 1, -1, -1):
            b = 1 << l
            take = pos + b <= i
            lo = np.zeros_like(i)
            hi = np.full_like(i, b)
            for _ in range(l + 1):
                active = lo < hi
                mid = (lo + hi) // 2
                idx = np.clip(pos + np.minimum(mid, b - 1), 0, n - 1)
                go_right = active & (ysl[l][idx] <= v)
                lo = np.where(go_right, mid + 1, lo)
                hi = np.where(active & ~go_right, mid, hi)
            total = total + np.where(take, lo, 0)
            pos = np.where(take, pos + b, pos)
        return total

    def _weighted_prefix_np(self, i: np.ndarray, v: np.ndarray,
                            mode: str) -> np.ndarray:
        """Host twin of ``mst_weighted_prefix`` (construction-time oracle)."""
        is_sum = mode == "sum"
        xs = _host(self.xs)
        ysl = _host(self.ys_levels)
        wacc = _host(self.wcum_levels if is_sum else self.wpmax_levels)
        n = len(xs)
        ident = 0.0 if is_sum else -np.inf
        total = np.full(np.shape(i), ident)
        pos = np.zeros_like(i)
        for l in range(ysl.shape[0] - 1, -1, -1):
            b = 1 << l
            take = pos + b <= i
            lo = np.zeros_like(i)
            hi = np.full_like(i, b)
            for _ in range(l + 1):
                active = lo < hi
                mid = (lo + hi) // 2
                idx = np.clip(pos + np.minimum(mid, b - 1), 0, n - 1)
                go_right = active & (ysl[l][idx] <= v)
                lo = np.where(go_right, mid + 1, lo)
                hi = np.where(active & ~go_right, mid, hi)
            val = wacc[l][np.clip(pos + lo - 1, 0, n - 1)]
            val = np.where(take & (lo > 0), val, ident)
            total = total + val if is_sum else np.maximum(total, val)
            pos = np.where(take, pos + b, pos)
        return total

    def cf_sum_np(self, u, v) -> np.ndarray:
        i = np.searchsorted(_host(self.xs), np.asarray(u, np.float64),
                            side="right")
        return self._weighted_prefix_np(i, np.asarray(v, np.float64), "sum")

    def dommax_np(self, u, v) -> np.ndarray:
        i = np.searchsorted(_host(self.xs), np.asarray(u, np.float64),
                            side="right")
        return self._weighted_prefix_np(i, np.asarray(v, np.float64), "max")


# ---------------------------------------------------------------------------
# bivariate minimax fitting
# ---------------------------------------------------------------------------

def _vander2d(u, v, deg):
    cols = []
    for i in range(deg + 1):
        for j in range(deg + 1):
            cols.append((u**i) * (v**j))
    return np.stack(cols, axis=-1)


def _fit2d_lp(u, v, F, deg):
    """Minimax bivariate fit (Eq. 10 with P(u_i, v_i)); returns (coef, err)."""
    from scipy.optimize import linprog

    A = _vander2d(u, v, deg)
    n, k = A.shape
    if n <= k:
        coef, *_ = np.linalg.lstsq(A, F, rcond=None)
        return coef, float(np.max(np.abs(F - A @ coef))) if n else 0.0
    ones = np.ones((n, 1))
    A_ub = np.block([[-A, -ones], [A, -ones]])
    b_ub = np.concatenate([-F, F])
    c = np.zeros(k + 1)
    c[-1] = 1.0
    res = linprog(c, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * k + [(0, None)], method="highs")
    if not res.success:
        coef, *_ = np.linalg.lstsq(A, F, rcond=None)
        return coef, float(np.max(np.abs(F - A @ coef)))
    coef = res.x[:k]
    return coef, float(np.max(np.abs(F - A @ coef)))


def _fit2d_lstsq(u, v, F, deg):
    A = _vander2d(u, v, deg)
    coef, *_ = np.linalg.lstsq(A, F, rcond=None)
    err = float(np.max(np.abs(F - A @ coef))) if len(F) else 0.0
    return coef, err


# ---------------------------------------------------------------------------
# quadtree index
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolyFitIndex2D:
    deg: int
    delta: float
    # tree topology: children[node, q] = child id or -1 (leaf); quadrant q =
    # (v >= ymid)*2 + (u >= xmid)
    children: torch.Tensor      # (N, 4) int32
    leaf_of: torch.Tensor       # (N,) int32: leaf slot or -1 for internal
    bounds: torch.Tensor        # (N, 4): x0, x1, y0, y1
    coeffs: torch.Tensor        # (n_leaves, (deg+1)^2)
    leaf_nodes: torch.Tensor    # (n_leaves,) int32: leaf slot -> node id
    max_depth: int
    root_bounds: Tuple[float, float, float, float]
    exact: Optional[MergeSortTree]
    n: int
    # -- measure-carrying extension ----------------------------------------
    agg: str = "count2d"
    leaf_err: Optional[np.ndarray] = None   # (n_leaves,) certified E(I), host
    leaf_agg: Optional[torch.Tensor] = None  # (n_leaves,) exact per-leaf agg
    measures_sorted: Optional[np.ndarray] = None  # host, x-sorted internal
    extremal_floor: Optional[float] = None  # frozen DMAX floor (max2d/min2d)

    @property
    def n_leaves(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def device(self) -> torch.device:
        return self.bounds.device

    @property
    def certified_delta(self) -> float:
        """The per-leaf certificate actually achieved: delta unless a leaf
        hit max_depth with residual error (then that error governs)."""
        if self.leaf_err is None:
            return float(self.delta)
        return float(max(self.delta, float(np.max(self.leaf_err))))

    def size_bytes(self) -> int:
        nb = lambda t: t.numel() * t.element_size()
        return int(nb(self.children) + nb(self.bounds) + nb(self.coeffs))

    def locate(self, u, v):
        """Leaf slot for each (u, v); fixed-depth branch-free descent."""
        return quadtree_locate(self.children, self.leaf_of, self.bounds,
                               self.max_depth, u, v)

    def eval_cf(self, u, v):
        """P_{leaf(u,v)}(u, v): approximate fitted function (vectorized)."""
        return quadtree_eval_cf(self.children, self.leaf_of, self.bounds,
                                self.coeffs, self.leaf_nodes, self.max_depth,
                                self.deg, u, v)


def quadtree_locate(children, leaf_of, bounds, max_depth: int, u, v):
    """Leaf slot for each (u, v); fixed-depth branch-free descent.

    quadrant = (v >= ymid)*2 + (u >= xmid), so midpoint ties descend toward
    the higher-coordinate child — the rule the flat-leaf one-hot membership
    of kernels/leaf_eval2d.py reproduces exactly.
    """
    node = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for _ in range(max_depth):
        b = bounds[node]
        xmid = 0.5 * (b[..., 0] + b[..., 1])
        ymid = 0.5 * (b[..., 2] + b[..., 3])
        q = (v >= ymid).long() * 2 + (u >= xmid).long()
        child = children[node, q].long()
        node = torch.where(child >= 0, child, node)
    return leaf_of[node]


def _quadtree_locate_np(children, leaf_of, bounds, max_depth: int, u, v):
    """Host twin of ``quadtree_locate`` (same descent rule in numpy), for
    construction, where shapes differ on every call."""
    node = np.zeros(np.shape(u), np.int32)
    for _ in range(max_depth):
        b = bounds[node]
        xmid = 0.5 * (b[..., 0] + b[..., 1])
        ymid = 0.5 * (b[..., 2] + b[..., 3])
        q = (v >= ymid).astype(np.int32) * 2 + (u >= xmid).astype(np.int32)
        child = children[node, q]
        node = np.where(child >= 0, child, node)
    return leaf_of[node]


def bivariate_horner(qx, qy, c, b, deg: int):
    """P(u(qx), v(qy)) of each corner's leaf, from its coefficient row c
    (..., (deg+1)^2) and its region b (..., 4) = x0, x1, y0, y1: the
    coordinates scaled to [-1, 1] over the region (clamped; a degenerate
    span scales by 1), then Horner in v inside Horner in u, both from 0 —
    the reference's order of operations, which every 2-D path (descent,
    one-hot oracle, kernels) shares."""
    span_x = torch.where(b[..., 1] > b[..., 0], b[..., 1] - b[..., 0], 1.0)
    span_y = torch.where(b[..., 3] > b[..., 2], b[..., 3] - b[..., 2], 1.0)
    us = torch.clamp((2.0 * qx - b[..., 0] - b[..., 1]) / span_x, -1.0, 1.0)
    vs = torch.clamp((2.0 * qy - b[..., 2] - b[..., 3]) / span_y, -1.0, 1.0)
    acc = torch.zeros_like(us)
    for i in range(deg, -1, -1):
        inner = torch.zeros_like(vs)
        for j in range(deg, -1, -1):
            inner = inner * vs + c[..., i * (deg + 1) + j]
        acc = acc * us + inner
    return acc


def quadtree_eval_cf(children, leaf_of, bounds, coeffs, leaf_nodes,
                     max_depth: int, deg: int, u, v):
    """P_{leaf(u,v)}(u, v): the fitted surface over flat quadtree arrays
    (leaf coefficients are stored for the leaf region's scaled
    coordinates)."""
    leaf = quadtree_locate(children, leaf_of, bounds, max_depth, u, v).long()
    return bivariate_horner(u, v, coeffs[leaf],
                            bounds[leaf_nodes[leaf].long()], deg)


class _QuadtreeBuilder:
    """Quadtree fitting machinery (the reference's, in numpy and scipy)."""

    def __init__(self, sx, sy, cf_exact, *, deg, delta, grid, max_depth,
                 max_fit_points, fast_accept):
        self.sx, self.sy = sx, sy          # x-sorted data coordinates
        self.cf_exact = cf_exact           # vectorized host oracle for F
        self.deg = deg
        self.delta = delta
        self.max_depth = max_depth
        self.max_fit_points = max_fit_points
        self.fast_accept = fast_accept
        gg = np.linspace(0.0, 1.0, grid)
        gu, gv = np.meshgrid(gg, gg)
        self.gu, self.gv = gu.ravel(), gv.ravel()
        self.rng = np.random.default_rng(0xF17)

    def region_points(self, x0, x1, y0, y1):
        i0 = np.searchsorted(self.sx, x0, side="left")
        i1 = np.searchsorted(self.sx, x1, side="right")
        xs = self.sx[i0:i1]
        ys = self.sy[i0:i1]
        m = (ys >= y0) & (ys <= y1)
        return xs[m], ys[m]

    def fit_region(self, x0, x1, y0, y1):
        rx, ry = self.region_points(x0, x1, y0, y1)
        # constraint set: data points in region + grid + corners
        cu = np.concatenate([rx, x0 + (x1 - x0) * self.gu])
        cv = np.concatenate([ry, y0 + (y1 - y0) * self.gv])
        F = np.asarray(self.cf_exact(cu, cv), np.float64)
        usc = np.clip((2 * cu - x0 - x1) / max(x1 - x0, 1e-300), -1, 1)
        vsc = np.clip((2 * cv - y0 - y1) / max(y1 - y0, 1e-300), -1, 1)
        deg, delta = self.deg, self.delta

        if self.fast_accept:
            coef, err = _fit2d_lstsq(usc, vsc, F, deg)
            if err <= delta:
                return coef, err
        # LP on a bounded constraint subsample, validated (and repaired with
        # the worst violators, Remez-style) against the full set
        m = len(F)
        if m <= self.max_fit_points:
            return _fit2d_lp(usc, vsc, F, deg)
        sub = self.rng.choice(m, self.max_fit_points, replace=False)
        for _ in range(3):
            coef, _ = _fit2d_lp(usc[sub], vsc[sub], F[sub], deg)
            resid = np.abs(F - _vander2d(usc, vsc, deg) @ coef)
            err = float(resid.max())
            if err <= delta:
                return coef, err
            worst = np.argsort(resid)[-256:]
            sub = np.unique(np.concatenate([sub, worst]))
        return coef, err

    def build(self, x0, x1, y0, y1, depth, children, bounds, depths,
              node_coef) -> int:
        """DFS-construct the (sub)tree over [x0,x1]x[y0,y1], appending to
        the host topology lists; ``node_coef[node] = (coef, err)`` marks
        leaves.  Returns the subtree's root node id."""
        node = len(children)
        children.append([-1, -1, -1, -1])
        bounds.append((x0, x1, y0, y1))
        depths.append(depth)
        coef, err = self.fit_region(x0, x1, y0, y1)
        if err <= self.delta or depth >= self.max_depth:
            node_coef[node] = (coef, err)
            return node
        xm, ym = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        args = (children, bounds, depths, node_coef)
        children[node][0] = self.build(x0, xm, y0, ym, depth + 1, *args)
        children[node][1] = self.build(xm, x1, y0, ym, depth + 1, *args)
        children[node][2] = self.build(x0, xm, ym, y1, depth + 1, *args)
        children[node][3] = self.build(xm, x1, ym, y1, depth + 1, *args)
        return node


def _internal_measures(px, measures, agg: str) -> np.ndarray:
    """Measures in internal space (MIN negated; COUNT is unit measures)."""
    if agg == "count2d":
        return np.ones_like(px)
    if measures is None:
        raise ValueError("measures required unless agg='count2d'")
    w = np.asarray(measures, np.float64)
    if w.shape != px.shape:
        raise ValueError(f"measures shape {w.shape} != points {px.shape}")
    return -w if agg == "min2d" else w


def _oracle_2d(tree: MergeSortTree, agg: str, floor: Optional[float]):
    """Host-side exact-F oracle the quadtree fits against."""
    if agg == "count2d":
        return lambda us, vs: tree.cf_np(us, vs)
    if agg == "sum2d":
        return lambda us, vs: tree.cf_sum_np(us, vs)
    return lambda us, vs: np.maximum(tree.dommax_np(us, vs), floor)


def _assemble_index_2d(children, bounds, depths, node_coef, *, agg, deg,
                       delta, max_depth, root_bounds, tree, keep_exact,
                       sx, sy, sw, floor, device) -> PolyFitIndex2D:
    """Assemble the device index from host topology + per-node leaf fits.

    Leaf slots are assigned in ascending node-id order (preorder for a
    fresh build).  ``leaf_agg`` is recomputed exactly from the data through
    the descent's own membership rule, so it is a true partition aggregate.
    """
    children = np.asarray(children, np.int32)
    bounds_a = np.asarray(bounds, np.float64)
    nnodes = len(children)
    leaf_of = np.full(nnodes, -1, np.int32)
    leaf_nodes: List[int] = []
    coeffs: List[np.ndarray] = []
    leaf_err: List[float] = []
    for node in range(nnodes):
        got = node_coef.get(node)
        if got is None:
            continue
        leaf_of[node] = len(leaf_nodes)
        leaf_nodes.append(node)
        coeffs.append(got[0])
        leaf_err.append(got[1])
    leaf_nodes_a = np.asarray(leaf_nodes, np.int32)

    # exact per-leaf measure aggregate over the descent's own partition
    leaf = _quadtree_locate_np(children, leaf_of, bounds_a, max_depth,
                               sx, sy)
    nl = len(leaf_nodes)
    if agg in ("max2d", "min2d"):
        la = np.full(nl, -np.inf)
        np.maximum.at(la, leaf, sw)
    else:
        la = np.zeros(nl)
        np.add.at(la, leaf, sw)

    to = lambda a: torch.as_tensor(a, device=device)
    return PolyFitIndex2D(
        deg=deg, delta=float(delta),
        children=to(children), leaf_of=to(leaf_of), bounds=to(bounds_a),
        coeffs=to(np.stack(coeffs)), leaf_nodes=to(leaf_nodes_a),
        max_depth=max_depth, root_bounds=root_bounds,
        exact=tree.to(device) if keep_exact else None, n=len(sx),
        agg=agg, leaf_err=np.asarray(leaf_err, np.float64),
        leaf_agg=to(la),
        measures_sorted=None if agg == "count2d" else sw,
        extremal_floor=floor,
    )


def build_index_2d(
    px: np.ndarray,
    py: np.ndarray,
    measures: Optional[np.ndarray] = None,
    agg: str = "count2d",
    deg: int = 3,
    delta: float = 100.0,
    grid: int = 8,
    max_depth: int = 12,
    max_fit_points: int = 2048,
    fast_accept: bool = True,
    keep_exact: bool = True,
    device=None,
) -> PolyFitIndex2D:
    """Quadtree segmentation of the aggregate's F (paper §6, Fig. 10), built
    on the host and held on ``device`` (the card by default).

    ``agg='count2d'`` fits CF_count (measures ignored); ``'sum2d'`` fits
    CF_sum over ``measures``; ``'max2d'``/``'min2d'`` fit the dominance-max
    staircase (MIN on negated measures end to end), floored at the dataset
    minimum so F is total — dominance answers are certified wherever the
    true dominance max reaches that frozen floor (every query that
    dominates at least one point of the build-time dataset).
    """
    if agg not in AGGS_2D:
        raise ValueError(f"agg must be one of {AGGS_2D}, got {agg!r}")
    device = resolve_device(device)
    px = np.asarray(px, np.float64)
    py = np.asarray(py, np.float64)
    w = _internal_measures(px, measures, agg)
    # the construction oracle reads the tree on the host
    tree = MergeSortTree.build(px, py, ws=None if agg == "count2d" else w)

    # order data by x for fast in-region slicing
    xo = np.argsort(px, kind="stable")
    sx, sy, sw = px[xo], py[xo], w[xo]
    floor = float(sw.min()) if agg in ("max2d", "min2d") else None
    cf_exact = _oracle_2d(tree, agg, floor)

    x0r, x1r = float(px.min()), float(px.max())
    y0r, y1r = float(py.min()), float(py.max())

    builder = _QuadtreeBuilder(sx, sy, cf_exact, deg=deg, delta=delta,
                               grid=grid, max_depth=max_depth,
                               max_fit_points=max_fit_points,
                               fast_accept=fast_accept)
    children: List[List[int]] = []
    bounds: List[Tuple[float, float, float, float]] = []
    depths: List[int] = []
    node_coef: Dict[int, Tuple[np.ndarray, float]] = {}

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        builder.build(x0r, x1r, y0r, y1r, 0, children, bounds, depths,
                      node_coef)
    finally:
        sys.setrecursionlimit(old_limit)

    return _assemble_index_2d(
        children, bounds, depths, node_coef, agg=agg, deg=deg, delta=delta,
        max_depth=max_depth, root_bounds=(x0r, x1r, y0r, y1r), tree=tree,
        keep_exact=keep_exact, sx=sx, sy=sy, sw=sw, floor=floor,
        device=device)


def _node_depths(children: np.ndarray) -> np.ndarray:
    """Per-node depth from the topology (root = node 0 at depth 0)."""
    depth = np.zeros(len(children), np.int64)
    stack = [0]
    while stack:
        node = stack.pop()
        for c in children[node]:
            if c >= 0:
                depth[c] = depth[node] + 1
                stack.append(int(c))
    return depth


def selective_refit_2d(
    index: PolyFitIndex2D,
    px: np.ndarray,
    py: np.ndarray,
    w: np.ndarray,
    changed_x: np.ndarray,
    changed_y: np.ndarray,
    changed_w: np.ndarray,
    *,
    grid: int = 8,
    max_fit_points: int = 2048,
    fast_accept: bool = True,
    keep_exact: bool = True,
) -> Tuple[PolyFitIndex2D, dict]:
    """Absorb a merged update batch by refitting *only* the dirty leaves.

    ``px, py, w`` is the merged dataset (w in *internal* space — negated
    for min2d, unit for count2d); ``changed_*`` lists every inserted or
    deleted point with its signed internal measure (+w insert, -w delete).

    A changed point (x0, y0) alters a CF-type F only on its dominance
    region {u >= x0, v >= y0}:

    * leaves wholly inside it see an exact *constant* shift (every point of
      the leaf dominates (x0, y0)), absorbed as a constant-coefficient bump
      that leaves the certified E(I) untouched;
    * leaves crossed by the region's boundary rays see a non-constant
      change and are re-fitted against the fresh exact oracle — re-split
      on the spot while the certificate fails and depth remains;
    * every other leaf keeps its coefficient row bit for bit.

    For dominance-MAX trees the change is max-composition, so every leaf
    intersecting a dominance region is re-fitted.  The extremal floor is
    re-frozen at the merged dataset's minimum; when it moves, every leaf
    whose raw dominance max dips below the higher of the two floors is
    re-fitted too.  Points outside the frozen root rectangle force a full
    rebuild.  Refits run in leaf-slot order on a fresh builder, so its
    subsample draws repeat the reference's.  The new index lands on the old
    one's device.

    Returns ``(new_index, stats)`` with stats keys ``n_leaves`` (before),
    ``refit``, ``split`` (leaves that re-split), ``shifted``, ``rebuild``,
    ``floor_refit`` (clean leaves re-fitted only because the floor moved;
    absent after a rebuild).
    """
    agg, deg, delta = index.agg, index.deg, index.delta
    max_depth = index.max_depth
    device = index.device
    px = np.asarray(px, np.float64)
    py = np.asarray(py, np.float64)
    w = np.asarray(w, np.float64)
    x0r, x1r, y0r, y1r = index.root_bounds
    if (px.min() < x0r or px.max() > x1r
            or py.min() < y0r or py.max() > y1r):
        meas = None
        if agg != "count2d":
            meas = -w if agg == "min2d" else w
        idx = build_index_2d(px, py, measures=meas, agg=agg, deg=deg,
                             delta=delta, grid=grid, max_depth=max_depth,
                             max_fit_points=max_fit_points,
                             fast_accept=fast_accept, keep_exact=keep_exact,
                             device=device)
        return idx, {"n_leaves": index.n_leaves, "refit": idx.n_leaves,
                     "split": 0, "shifted": 0, "rebuild": True}

    extremal = agg in ("max2d", "min2d")
    tree = MergeSortTree.build(px, py, ws=None if agg == "count2d" else w)
    xo = np.argsort(px, kind="stable")
    sx, sy, sw = px[xo], py[xo], w[xo]
    # re-freeze the floor at the *merged* dataset's minimum: the build-time
    # floor would leave refit leaves certified against a stale clamp
    floor = float(sw.min()) if extremal else None
    builder = _QuadtreeBuilder(sx, sy, _oracle_2d(tree, agg, floor),
                               deg=deg, delta=delta, grid=grid,
                               max_depth=max_depth,
                               max_fit_points=max_fit_points,
                               fast_accept=fast_accept)

    # host topology (mutable for splits)
    children_h = _host(index.children)
    bounds_h = _host(index.bounds)
    children = [list(r) for r in children_h]
    bounds = [tuple(float(x) for x in b) for b in bounds_h]
    depths = list(_node_depths(children_h))
    leaf_nodes = _host(index.leaf_nodes)
    old_coeffs = _host(index.coeffs)
    old_err = (np.asarray(index.leaf_err) if index.leaf_err is not None
               else np.full(len(leaf_nodes), float(delta)))
    lb = bounds_h[leaf_nodes]   # (L, 4): x0, x1, y0, y1

    cx = np.asarray(changed_x, np.float64)[None, :]
    cy = np.asarray(changed_y, np.float64)[None, :]
    cw = np.asarray(changed_w, np.float64)
    # (L, C) classification against each changed point's dominance region
    untouched = (lb[:, 1:2] < cx) | (lb[:, 3:4] < cy)
    n_floor = 0
    if extremal:
        dirty = (~untouched).any(axis=1)
        old_floor = index.extremal_floor
        if old_floor is not None and floor != old_floor:
            # the frozen clamp moved: a leaf whose raw dominance max dips
            # below the higher floor (its minimum sits at the lower-left
            # corner, F being bimonotone) answered with the old clamp
            raw = tree.dommax_np(lb[:, 0], lb[:, 2])
            floor_dirty = raw < max(old_floor, floor)
            n_floor = int((floor_dirty & ~dirty).sum())
            dirty |= floor_dirty
        shift = np.zeros(len(lb))
    else:
        dominated = (lb[:, 0:1] >= cx) & (lb[:, 2:3] >= cy)
        dirty = (~(untouched | dominated)).any(axis=1)
        shift = np.where(dirty, 0.0,
                         np.where(dominated, cw[None, :], 0.0).sum(axis=1))

    node_coef: Dict[int, Tuple[np.ndarray, float]] = {}
    n_refit = n_split = n_shift = 0
    for s, node in enumerate(leaf_nodes):
        node = int(node)
        if not dirty[s]:
            c = old_coeffs[s]
            if shift[s] != 0.0:
                c = c.copy()
                c[0] += shift[s]   # the u^0 v^0 term: an exact CF bump
                n_shift += 1
            node_coef[node] = (c, float(old_err[s]))
            continue
        x0, x1, y0, y1 = lb[s]
        coef, err = builder.fit_region(x0, x1, y0, y1)
        n_refit += 1
        if err <= delta or depths[node] >= max_depth:
            node_coef[node] = (coef, err)
            continue
        # certificate fails with depth to spare: re-split in place
        n_split += 1
        xm, ym = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        args = (children, bounds, depths, node_coef)
        d = depths[node] + 1
        children[node][0] = builder.build(x0, xm, y0, ym, d, *args)
        children[node][1] = builder.build(xm, x1, y0, ym, d, *args)
        children[node][2] = builder.build(x0, xm, ym, y1, d, *args)
        children[node][3] = builder.build(xm, x1, ym, y1, d, *args)

    new_index = _assemble_index_2d(
        children, bounds, depths, node_coef, agg=agg, deg=deg, delta=delta,
        max_depth=max_depth, root_bounds=index.root_bounds, tree=tree,
        keep_exact=keep_exact, sx=sx, sy=sy, sw=sw, floor=floor,
        device=device)
    stats = {"n_leaves": int(len(leaf_nodes)), "refit": n_refit,
             "split": n_split, "shifted": n_shift, "rebuild": False,
             "floor_refit": n_floor}
    return new_index, stats


def index2d_from_numpy(fields: Mapping, device) -> PolyFitIndex2D:
    """A port index from a reference ``PolyFitIndex2D``'s fields as numpy.

    ``fields`` holds the metadata ``deg``, ``delta``, ``max_depth``,
    ``root_bounds``, ``n``, ``agg``, ``extremal_floor``, the arrays
    ``children``, ``leaf_of``, ``bounds``, ``coeffs``, ``leaf_nodes``,
    ``leaf_agg``, ``leaf_err``, ``measures_sorted`` (None where the
    reference has None), and the merge-sort tree as ``exact = (xs,
    ys_levels, wcum_levels, wpmax_levels, ws)`` (entries None for an
    unweighted tree), or None.
    """
    device = torch.device(device)
    to = lambda a: None if a is None else torch.as_tensor(np.array(a),
                                                          device=device)
    ex = fields.get("exact")
    host = lambda a: None if a is None else np.asarray(a)
    floor = fields.get("extremal_floor")
    return PolyFitIndex2D(
        deg=int(fields["deg"]), delta=float(fields["delta"]),
        children=to(fields["children"]), leaf_of=to(fields["leaf_of"]),
        bounds=to(fields["bounds"]), coeffs=to(fields["coeffs"]),
        leaf_nodes=to(fields["leaf_nodes"]),
        max_depth=int(fields["max_depth"]),
        root_bounds=tuple(float(b) for b in fields["root_bounds"]),
        exact=None if ex is None else MergeSortTree(*map(to, ex)),
        n=int(fields["n"]), agg=str(fields.get("agg", "count2d")),
        leaf_err=host(fields.get("leaf_err")),
        leaf_agg=to(fields.get("leaf_agg")),
        measures_sorted=host(fields.get("measures_sorted")),
        extremal_floor=None if floor is None else float(floor),
    )


# ---------------------------------------------------------------------------
# core-level query helpers (the engine's executors mirror these)
# ---------------------------------------------------------------------------

def _as_query(q, index: PolyFitIndex2D) -> torch.Tensor:
    return torch.as_tensor(q, dtype=DTYPE, device=index.device)


def _rect_approx(index, lx, ux, ly, uy):
    return (index.eval_cf(ux, uy) - index.eval_cf(lx, uy)
            - index.eval_cf(ux, ly) + index.eval_cf(lx, ly))


def query_count_2d(index: PolyFitIndex2D, lx, ux, ly, uy,
                   eps_rel: float | None = None) -> QueryResult:
    """Approximate 2-key range COUNT (Eq. 19) with optional Q_rel refinement.

    Semantics follow Eq. 19 literally: A = CF(ux,uy) - CF(lx,uy) - CF(ux,ly)
    + CF(lx,ly), i.e. the half-open rectangle (lx, ux] x (ly, uy].
    """
    lx, ux, ly, uy = (_as_query(q, index) for q in (lx, ux, ly, uy))
    approx = _rect_approx(index, lx, ux, ly, uy)
    if eps_rel is None:
        return QueryResult(approx, approx, torch.zeros_like(approx,
                                                            dtype=torch.bool))
    ok = approx >= 4.0 * index.delta * (1.0 + 1.0 / eps_rel)   # Lemma 6.4
    if index.exact is None:
        raise ValueError("Q_rel refinement requires keep_exact=True")
    ex = index.exact
    truth = (ex.cf(ux, uy) - ex.cf(lx, uy) - ex.cf(ux, ly)
             + ex.cf(lx, ly)).to(approx.dtype)
    return QueryResult(torch.where(ok, approx, truth), approx, ~ok)


def query_sum_2d(index: PolyFitIndex2D, lx, ux, ly, uy,
                 eps_rel: float | None = None) -> QueryResult:
    """Approximate 2-key range SUM over (lx, ux] x (ly, uy]: the 4-corner
    inclusion-exclusion of CF_sum, |A - R| <= 4*delta (the Lemma 6.3
    argument applied to the weighted CF)."""
    if index.agg != "sum2d":
        raise ValueError(f"query_sum_2d needs a sum2d index, got {index.agg}")
    lx, ux, ly, uy = (_as_query(q, index) for q in (lx, ux, ly, uy))
    approx = _rect_approx(index, lx, ux, ly, uy)
    if eps_rel is None:
        return QueryResult(approx, approx, torch.zeros_like(approx,
                                                            dtype=torch.bool))
    ok = approx >= 4.0 * index.delta * (1.0 + 1.0 / eps_rel)   # Lemma 6.4
    if index.exact is None:
        raise ValueError("Q_rel refinement requires keep_exact=True")
    ex = index.exact
    truth = (ex.cf_sum(ux, uy) - ex.cf_sum(lx, uy) - ex.cf_sum(ux, ly)
             + ex.cf_sum(lx, ly)).to(approx.dtype)
    return QueryResult(torch.where(ok, approx, truth), approx, ~ok)


def query_dommax_2d(index: PolyFitIndex2D, u, v,
                    eps_rel: float | None = None) -> QueryResult:
    """Approximate dominance MAX/MIN: the extremal measure over
    {x <= u, y <= v}, |A - R| <= delta wherever the true dominance max
    reaches the frozen floor (every corner dominating a build-time point).
    MIN trees run on negated measures end to end."""
    if index.agg not in ("max2d", "min2d"):
        raise ValueError("query_dommax_2d needs a max2d/min2d index, got "
                         f"{index.agg}")
    u, v = _as_query(u, index), _as_query(v, index)
    approx = index.eval_cf(u, v)
    neg = index.agg == "min2d"
    if eps_rel is None:
        out = -approx if neg else approx
        return QueryResult(out, out, torch.zeros_like(out, dtype=torch.bool))
    # Lemma 5.4 shape, in MAX space
    ok = approx >= index.delta * (1.0 + 1.0 / eps_rel)
    if index.exact is None:
        raise ValueError("Q_rel refinement requires keep_exact=True")
    truth = index.exact.dommax(u, v).to(approx.dtype)
    ans = torch.where(ok, approx, truth)
    if neg:
        ans, approx = -ans, -approx
    return QueryResult(ans, approx, ~ok)
