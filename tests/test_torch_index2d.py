"""repro_torch.core.index2d against repro.core.index2d: twins of
tests/test_index2d.py's static cases (dominance rank, the merge-sort tree
weighted and unweighted, the count/sum/dommax certified bounds, the
leaf-aggregate partition), plus construction parity node for node.

Each reference index is built once per module at 4,000 points and
``max_depth`` <= 7; the port builds the same index from the same numpy
inputs on the CPU and must equal it: topology, bounds and leaf maps
exactly, coefficients within 1e-9.  Port answers agree with the
reference's at rtol = atol = 1e-9 with equal ``refined`` flags, and every
certified bound holds against exact truth computed with numpy."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import (MergeSortTree as RTree,  # noqa: E402
                        build_index_2d as r_build, dominance_rank as r_rank,
                        query_count_2d as r_count, query_dommax_2d as r_dom,
                        query_sum_2d as r_sum)
from repro_torch.core import (MergeSortTree, build_index_2d,  # noqa: E402
                              dominance_rank, index2d_from_numpy,
                              query_count_2d, query_dommax_2d, query_sum_2d)

TOL = dict(rtol=1e-9, atol=1e-9)
N = 4000
AGGS = ("count2d", "sum2d", "max2d", "min2d")
# (deg, delta) of each module index, max_depth 7
BUILD = {"count2d": (2, 25.0), "sum2d": (2, 400.0), "max2d": (2, 5.0),
         "min2d": (2, 5.0)}


@pytest.fixture(scope="module")
def wdata():
    rng = np.random.default_rng(0x2D)
    px, py = rng.uniform(0, 100, N), rng.uniform(0, 100, N)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15) + rng.uniform(0, 5, N)
    return px, py, w


@pytest.fixture(scope="module")
def indexes(wdata):
    """agg -> (reference index, port index built on the CPU)."""
    px, py, w = wdata
    out = {}
    for agg in AGGS:
        deg, delta = BUILD[agg]
        m = None if agg == "count2d" else w
        kw = dict(measures=m, agg=agg, deg=deg, delta=delta, max_depth=7)
        out[agg] = (r_build(px, py, **kw),
                    build_index_2d(px, py, device="cpu", **kw))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry(ridx):
    """A reference index carried into the port (its fields as numpy)."""
    arr = lambda a: None if a is None else np.asarray(a)
    ex = ridx.exact
    fields = {f: arr(getattr(ridx, f)) for f in
              ("children", "leaf_of", "bounds", "coeffs", "leaf_nodes",
               "leaf_agg", "leaf_err", "measures_sorted")}
    fields.update(deg=ridx.deg, delta=ridx.delta, max_depth=ridx.max_depth,
                  root_bounds=ridx.root_bounds, n=ridx.n, agg=ridx.agg,
                  extremal_floor=ridx.extremal_floor,
                  exact=None if ex is None else tuple(
                      arr(a) for a in (ex.xs, ex.ys_levels, ex.wcum_levels,
                                       ex.wpmax_levels, ex.ws)))
    return index2d_from_numpy(fields, "cpu")


def _rects(rng, m, lo=0.0, hi=80.0, ext=(5.0, 20.0)):
    lx = rng.uniform(lo, hi, m)
    ly = rng.uniform(lo, hi, m)
    return lx, lx + rng.uniform(*ext, m), ly, ly + rng.uniform(*ext, m)


def _rect_truth(px, py, w, lx, ux, ly, uy):
    return np.array([w[(px > a) & (px <= b) & (py > c) & (py <= d)].sum()
                     for a, b, c, d in zip(lx, ux, ly, uy)])


def _same(got, want):
    """Port QueryResult vs reference QueryResult: answers and raw answers
    at 1e-9, refined flags equal."""
    np.testing.assert_allclose(_np(got.answer), np.asarray(want.answer),
                               **TOL)
    np.testing.assert_allclose(_np(got.approx), np.asarray(want.approx),
                               **TOL)
    np.testing.assert_array_equal(_np(got.refined), np.asarray(want.refined))


# ---------------------------------------------------------------------------
# exact structures
# ---------------------------------------------------------------------------

def test_dominance_rank_brute(rng):
    n = 800
    px, py = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    got = dominance_rank(px, py)
    want = np.array([((px <= a) & (py <= b)).sum() for a, b in zip(px, py)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(r_rank(px, py)))


def test_merge_sort_tree_rect(rng):
    n = 2000
    px, py = rng.normal(0, 3, n), rng.normal(0, 3, n)
    t = MergeSortTree.build(px, py)
    rt = RTree.build(px, py)
    np.testing.assert_array_equal(t.ys_levels.numpy(),
                                  np.asarray(rt.ys_levels))
    x0 = rng.uniform(-5, 5, 100); x1 = x0 + rng.uniform(0, 4, 100)
    y0 = rng.uniform(-5, 5, 100); y1 = y0 + rng.uniform(0, 4, 100)
    got = t.query(*(torch.as_tensor(q) for q in (x0, x1, y0, y1))).numpy()
    want = np.array([((px >= a) & (px <= b) & (py >= c) & (py <= d)).sum()
                     for a, b, c, d in zip(x0, x1, y0, y1)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(rt.query(
        *(jnp.asarray(q) for q in (x0, x1, y0, y1)))))


def test_weighted_mst_exact(wdata):
    """cf_sum / dommax (tensor and host paths) against brute force and the
    reference's arrays."""
    px, py, w = wdata
    t = MergeSortTree.build(px, py, ws=w)
    rt = RTree.build(px, py, ws=w)
    for f in ("xs", "ys_levels", "wcum_levels", "wpmax_levels", "ws"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(rt, f)), err_msg=f)
    rng = np.random.default_rng(1)
    qu, qv = rng.uniform(0, 100, 150), rng.uniform(0, 100, 150)
    tu, tv = torch.as_tensor(qu), torch.as_tensor(qv)
    dom = (px[None, :] <= qu[:, None]) & (py[None, :] <= qv[:, None])
    want_sum = (dom * w[None, :]).sum(axis=1)
    np.testing.assert_allclose(t.cf_sum(tu, tv).numpy(), want_sum, rtol=1e-12)
    np.testing.assert_allclose(t.cf_sum_np(qu, qv), want_sum, rtol=1e-12)
    np.testing.assert_array_equal(t.cf_sum(tu, tv).numpy(), np.asarray(
        rt.cf_sum(jnp.asarray(qu), jnp.asarray(qv))))
    want_max = np.where(dom.any(axis=1),
                        np.where(dom, w[None, :], -np.inf).max(axis=1),
                        -np.inf)
    np.testing.assert_array_equal(t.dommax(tu, tv).numpy(), want_max)
    np.testing.assert_array_equal(t.dommax_np(qu, qv), want_max)
    np.testing.assert_array_equal(t.cf(tu, tv).numpy(), np.asarray(
        rt.cf(jnp.asarray(qu), jnp.asarray(qv))))


def test_unweighted_mst_unchanged(wdata):
    """A weight-free build keeps no weighted arrays."""
    px, py, _ = wdata
    t = MergeSortTree.build(px, py)
    assert t.wcum_levels is None and t.wpmax_levels is None and t.ws is None


# ---------------------------------------------------------------------------
# construction parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", AGGS)
def test_construction_parity_node_for_node(indexes, agg):
    """The port's quadtree is the reference's: the same nodes, bounds, leaf
    maps and certificates; coefficients within 1e-9."""
    ridx, idx = indexes[agg]
    for f in ("children", "leaf_of", "bounds", "leaf_nodes"):
        np.testing.assert_array_equal(getattr(idx, f).numpy(),
                                      np.asarray(getattr(ridx, f)), err_msg=f)
    np.testing.assert_allclose(idx.coeffs.numpy(), np.asarray(ridx.coeffs),
                               **TOL)
    np.testing.assert_allclose(idx.leaf_err, ridx.leaf_err, **TOL)
    np.testing.assert_array_equal(idx.leaf_agg.numpy(),
                                  np.asarray(ridx.leaf_agg))
    assert idx.root_bounds == ridx.root_bounds
    assert (idx.n_leaves, idx.max_depth, idx.n) == (ridx.n_leaves,
                                                    ridx.max_depth, ridx.n)
    assert idx.certified_delta == pytest.approx(ridx.certified_delta,
                                                rel=1e-12)
    assert idx.extremal_floor == ridx.extremal_floor
    assert idx.size_bytes() == ridx.size_bytes()
    for f in ("xs", "ys_levels", "wcum_levels", "wpmax_levels"):
        a, b = getattr(idx.exact, f), getattr(ridx.exact, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)


def test_carried_index_answers_as_built(indexes, wdata):
    """index2d_from_numpy carries the reference's index: its answers equal
    those of the port's own build."""
    px, py, w = wdata
    ridx, idx = indexes["sum2d"]
    carried = _carry(ridx)
    rng = np.random.default_rng(4)
    rect = _rects(rng, 100)
    for eps_rel in (None, 0.05):
        a = query_sum_2d(carried, *rect, eps_rel=eps_rel)
        b = query_sum_2d(idx, *rect, eps_rel=eps_rel)
        np.testing.assert_allclose(a.answer.numpy(), b.answer.numpy(), **TOL)


# ---------------------------------------------------------------------------
# certified bounds (Lemma 6.3 / 6.4 and the dominance shape)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps_rel", [None, 0.05])
def test_count2d_certified_bound(indexes, wdata, eps_rel):
    """|A - R| <= 4 delta under Q_abs, within eps_rel under Q_rel, and the
    same answers and refined flags as the reference."""
    px, py, _ = wdata
    ridx, idx = indexes["count2d"]
    rng = np.random.default_rng(9)
    rect = _rects(rng, 300, ext=(2.0, 40.0))
    res = query_count_2d(idx, *rect, eps_rel=eps_rel)
    _same(res, r_count(ridx, *rect, eps_rel=eps_rel))
    truth = _rect_truth(px, py, np.ones(N), *rect)
    err = np.abs(res.answer.numpy() - truth)
    if eps_rel is None:
        assert err.max() <= 4 * idx.certified_delta + 1e-6
    else:
        pos = truth > 0
        assert (err[pos] / truth[pos]).max() <= eps_rel + 1e-9


def test_quadtree_lookup_total(indexes):
    """Every point of the root box lands in exactly one leaf that holds it,
    the reference's leaf."""
    ridx, idx = indexes["count2d"]
    x0, x1, y0, y1 = idx.root_bounds
    rng = np.random.default_rng(0)
    qx, qy = rng.uniform(x0, x1, 2000), rng.uniform(y0, y1, 2000)
    leaf = idx.locate(torch.as_tensor(qx), torch.as_tensor(qy)).numpy()
    assert (leaf >= 0).all() and (leaf < idx.n_leaves).all()
    b = idx.bounds.numpy()[idx.leaf_nodes.numpy()[leaf]]
    assert ((qx >= b[:, 0]) & (qx <= b[:, 1]) & (qy >= b[:, 2])
            & (qy <= b[:, 3])).all()
    np.testing.assert_array_equal(leaf, np.asarray(ridx.locate(
        jnp.asarray(qx), jnp.asarray(qy))))


def test_sum2d_certified_bound(indexes, wdata):
    """|A - R| <= 4 certified_delta for rectangle SUM; Q_rel keeps the
    relative bound; both as the reference answers."""
    px, py, w = wdata
    ridx, idx = indexes["sum2d"]
    rect = _rects(np.random.default_rng(2), 120)
    truth = _rect_truth(px, py, w, *rect)
    res = query_sum_2d(idx, *rect)
    _same(res, r_sum(ridx, *rect))
    assert np.abs(res.answer.numpy() - truth).max() \
        <= 4 * idx.certified_delta + 1e-6
    resr = query_sum_2d(idx, *rect, eps_rel=0.05)
    _same(resr, r_sum(ridx, *rect, eps_rel=0.05))
    pos = truth > 0
    rel = np.abs(resr.answer.numpy()[pos] - truth[pos]) / truth[pos]
    assert rel.max() <= 0.05 + 1e-9


@pytest.mark.parametrize("agg", ["max2d", "min2d"])
def test_dommax2d_certified_bound(indexes, wdata, agg):
    """|A - R| <= certified_delta for dominance MAX/MIN at corners that
    dominate data, within eps_rel under Q_rel, as the reference answers."""
    px, py, w = wdata
    ridx, idx = indexes[agg]
    rng = np.random.default_rng(3)
    u = px[rng.integers(0, N, 120)] + 1e-9
    v = py[rng.integers(0, N, 120)] + 1e-9
    dom = (px[None, :] <= u[:, None]) & (py[None, :] <= v[:, None])
    red = np.max if agg == "max2d" else np.min
    truth = np.array([red(w[d]) for d in dom])
    res = query_dommax_2d(idx, u, v)
    _same(res, r_dom(ridx, u, v))
    assert np.abs(res.answer.numpy() - truth).max() \
        <= idx.certified_delta + 1e-6
    resr = query_dommax_2d(idx, u, v, eps_rel=0.05)
    _same(resr, r_dom(ridx, u, v, eps_rel=0.05))
    rel = np.abs(resr.answer.numpy() - truth) / np.abs(truth)
    assert rel.max() <= 0.05 + 1e-9


def test_leaf_agg_partition(indexes, wdata):
    """Per-leaf exact aggregates cover the dataset exactly once."""
    _, _, w = wdata
    la = indexes["sum2d"][1].leaf_agg.numpy()
    assert np.isclose(la.sum(), w.sum())
    lm = indexes["max2d"][1].leaf_agg.numpy()
    assert np.isclose(lm[np.isfinite(lm)].max(), w.max())


def test_rejects_bad_inputs(wdata):
    px, py, w = wdata
    with pytest.raises(ValueError, match="agg"):
        build_index_2d(px, py, agg="median2d", device="cpu")
    with pytest.raises(ValueError, match="measures required"):
        build_index_2d(px, py, agg="sum2d", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        build_index_2d(px, py, measures=w[:-1], agg="max2d", device="cpu")
