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
* ``interleave2`` / ``locate_leaf2d`` / ``dyadic_cuts`` /
  ``leaf_morton_codes`` — the 2-D part: quadtree leaves are intervals in
  Morton (Z-order) space, so a corner resolves with three binary searches
  (cell x, cell y, leaf z).  The cut grids repeat the tree build's own
  midpoint recursion, so locating against them is bit-identical to the
  one-hot membership rule (a corner on a split line goes to the
  higher-coordinate leaf).

``locate`` is the wrapper over K1 (``csrc/polyfit_kernels.cu``,
``locate_tree_kernel``), the twin of ``locate_pallas``: on CUDA tensors it
launches the kernel, on CPU tensors it runs ``locate_segments``.  K1 walks
the keys' search tree (``search_tree``: a static 5-ary B+ tree of 32-byte
nodes over the sorted keys, built once per plan by ``engine.plan``), so
that each sector it fetches decides a level; ``tree_count`` is the same
descent in torch (``tree_count_left`` its strict twin, K4's snap), held
to ``bsearch_count`` by the CPU tests.  The CUDA
versions of the device functions live in ``csrc/locate.cuh``.

Sentinel-padded tails need no special casing: the padding value exceeds
every real key, so the counts never reach it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["bsearch_count", "locate_segments", "floor_log2", "rmq_gather",
           "locate", "search_tree", "tree_count", "tree_count_left",
           "tree_levels", "TREE_FANOUT", "check_tree_shape", "interleave2", "locate_leaf2d", "dyadic_cuts",
           "leaf_morton_codes", "MAX_MORTON_DEPTH", "INT_SENTINEL"]

# 2 bits per level must fit an int32 Morton code (sign bit reserved)
MAX_MORTON_DEPTH = 15
INT_SENTINEL = int(np.iinfo(np.int32).max)


def bsearch_count(keys: torch.Tensor, q: torch.Tensor,
                  side: str = "right") -> torch.Tensor:
    """Per-lane ``searchsorted(keys, q, side)`` in ceil(log2 n) + 1 rounds.

    Returns the number of ``keys`` entries <= q (side='right') or < q
    (side='left') as int32.  ``keys`` (float64 or int32, as ``q``) must be
    sorted ascending; each round
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


#: children of a node of K1's search tree (four separators, 32 bytes)
TREE_FANOUT = 5


def tree_levels(n: int) -> list:
    """Nodes of each internal level of the search tree over n keys, root
    first (none when n <= 4: the keys are one leaf)."""
    counts, c = [], -(-n // 4)
    while c > 1:
        c = -(-c // TREE_FANOUT)
        counts.append(c)
    return counts[::-1]


def search_tree(keys: torch.Tensor) -> torch.Tensor:
    """K1's search tree over sorted ``keys``: the internal levels of a
    static 5-ary B+ tree, root first, as a (nodes, 4) tensor of the keys'
    dtype on their device.

    Its leaf j is ``keys[4j : 4j + 4]`` itself (not copied).  Node i of a
    level has children 5i .. 5i + 4 on the level below (leaves below the
    last), and holds the first key of children 1-4, NaN where a child does
    not exist, so that ``#(separators <= q)`` is the child to descend to.
    About n / 16 nodes: n / 4 values beside the n keys."""
    n = keys.shape[0]
    levels, count, span = [], -(-n // 4), 4
    for parents in tree_levels(n)[::-1]:
        child = (TREE_FANOUT * torch.arange(parents, device=keys.device)[:, None]
                 + torch.arange(1, TREE_FANOUT, device=keys.device))
        first = keys[torch.clamp(child * span, max=n - 1)]
        levels.append(torch.where(child < count, first, torch.nan))
        count, span = parents, span * TREE_FANOUT
    if not levels:
        return keys.new_empty((0, TREE_FANOUT - 1))
    return torch.cat(levels[::-1])


def check_tree_shape(name: str, tree: torch.Tensor, n: int) -> None:
    """Raise unless ``tree`` has the shape of the search tree of n keys
    (the kernels that descend one, K1-K4 and K21, check no more: a tree of
    other keys of the same count passes unseen)."""
    if tree.shape != (sum(tree_levels(n)), TREE_FANOUT - 1):
        raise ValueError(f"{name}: tree {tuple(tree.shape)} does not have "
                         f"the shape of the search tree of {n} keys")


def tree_count(keys: torch.Tensor, tree: torch.Tensor, q: torch.Tensor,
               side: str = "right") -> torch.Tensor:
    """#(keys <= q) (side='right') or #(keys < q) (side='left') per lane
    as int32 by K1's descent of ``tree`` (``search_tree(keys)``): at each
    level the child is #(separators <= q) (or < q), at the leaf the count
    is 4 leaf + #(its keys <= q) (or < q), over the keys that exist.  Equal
    to ``bsearch_count(keys, q, side)`` on sorted keys, duplicates, +-inf
    and NaN q (count 0) included."""
    n = keys.shape[0]
    hit = (lambda a, b: a <= b) if side == "right" else (lambda a, b: a < b)
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    first = 0
    for count in tree_levels(n):
        sep = tree[first + node]
        node = TREE_FANOUT * node + hit(sep, q[..., None]).sum(-1)
        first += count
    idx = 4 * node[..., None] + torch.arange(4, device=q.device)
    leaf = (idx < n) & hit(keys[torch.clamp(idx, max=n - 1)], q[..., None])
    return (4 * node + leaf.sum(-1)).to(torch.int32)


def tree_count_left(keys: torch.Tensor, tree: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """#(keys < q) by the descent (``csrc/locate.cuh`` tree_count_left, K4's
    snap to the key grid): ``tree_count`` with side='left'."""
    return tree_count(keys, tree, q, side="left")


def locate(q: torch.Tensor, keys: torch.Tensor,
           tree: torch.Tensor = None) -> torch.Tensor:
    """Segment id per query key: max(#(keys <= q) - 1, 0) as (Q,) int32
    against sorted (n,) ``keys``.

    K1 on CUDA tensors: one thread a query descends ``tree``, the keys'
    ``search_tree`` (the plans carry it; a call without one builds it for
    that call).  ``keys`` and ``tree`` must be 16-byte aligned (K1 reads a
    node or a leaf as two 16-byte loads).  It raises on a tree whose shape
    is not that of ``n`` keys' tree; a tree of other keys of the same count
    passes unseen.  ``locate_segments`` on CPU tensors.  ``locate.launches`` counts the kernel launches.
    """
    if q.device.type == "cpu":
        return locate_segments(keys, q)
    if tree is None:
        tree = search_tree(keys)
    _build.require_cuda("locate", q, keys, tree)
    Q, n = q.shape[0], keys.shape[0]
    if n < 1:
        raise ValueError("locate: keys must not be empty")
    check_tree_shape("locate", tree, n)
    if keys.data_ptr() % 16 or tree.data_ptr() % 16:
        raise ValueError("locate: keys and tree must be 16-byte aligned")
    out = torch.empty(Q, dtype=torch.int32, device=q.device)
    if Q:
        _build.check(_build.library().polyfit_locate(
            q.data_ptr(), keys.data_ptr(), tree.data_ptr(), out.data_ptr(),
            Q, n, _build.stream(q.device)), "locate")
        locate.launches += 1
    return out


locate.launches = 0


# ---------------------------------------------------------------------------
# 2-D: quadtree leaves as a Morton-interval table
# ---------------------------------------------------------------------------

def interleave2(ix: torch.Tensor, iy: torch.Tensor, depth: int) -> torch.Tensor:
    """Morton (Z-order) code of cell (ix, iy) at ``depth`` bits per axis,
    as int32."""
    z = torch.zeros(ix.shape, dtype=torch.int32, device=ix.device)
    for b in range(depth):
        z = (z | (((ix >> b) & 1) << (2 * b))
             | (((iy >> b) & 1) << (2 * b + 1)))
    return z


def locate_leaf2d(qx, qy, xcuts, ycuts, leaf_z, depth: int) -> torch.Tensor:
    """Leaf-table row containing each (pre-clamped) query corner.

    Three binary searches: cell x = #xcuts <= qx, cell y = #ycuts <= qy
    (so a corner exactly on a split line lands in the higher cell — the
    quadtree descent's tie rule), then the Morton code's containing leaf
    interval in the z-sorted, ``INT_SENTINEL``-padded int32 table.
    """
    ix = bsearch_count(xcuts, qx, side="right")
    iy = bsearch_count(ycuts, qy, side="right")
    z = interleave2(ix, iy, depth)
    return torch.clamp(bsearch_count(leaf_z, z, side="right") - 1, min=0)


def dyadic_cuts(lo: float, hi: float, depth: int) -> np.ndarray:
    """The 2^depth - 1 interior split lines of a midpoint-recursive quadtree
    axis, computed with the *same* float recursion as the tree build
    (``mid = 0.5*(lo + hi)`` of each node's own bounds), so every leaf
    boundary equals a cut value exactly."""
    m = 1 << depth
    g = np.empty(m + 1, np.float64)
    g[0], g[m] = lo, hi
    stack = [(0, m)]
    while stack:
        i0, i1 = stack.pop()
        if i1 - i0 < 2:
            continue
        im = (i0 + i1) // 2
        g[im] = 0.5 * (g[i0] + g[i1])
        stack.append((i0, im))
        stack.append((im, i1))
    return g[1:m]


def leaf_morton_codes(leaf_bounds: np.ndarray, xcuts: np.ndarray,
                      ycuts: np.ndarray, depth: int) -> np.ndarray:
    """Morton code of each leaf's lower-left cell (its z-interval start).

    A quadtree leaf at depth d covers a contiguous Z-order run of
    4^(depth-d) cells, so the starts sort the leaves into disjoint
    intervals covering [0, 4^depth).
    """
    ix0 = np.searchsorted(xcuts, leaf_bounds[:, 0], side="right")
    iy0 = np.searchsorted(ycuts, leaf_bounds[:, 2], side="right")
    z = np.zeros(len(leaf_bounds), np.int64)
    for b in range(depth):
        z |= ((ix0 >> b) & 1) << (2 * b)
        z |= ((iy0 >> b) & 1) << (2 * b + 1)
    return z.astype(np.int32)
