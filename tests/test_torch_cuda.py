"""The CUDA kernels on the card, held to their plain PyTorch versions.

K1 (locate), K2 (range SUM), K3 (range MAX), K4 (quantile inversion), K5
(buffered SUM), K6 (buffered MAX), the 2-D leaf kernels K7, K8, K12 and
K13, the buffered 2-D corrections K9, K10 and K11, and the ``cuda`` engine
backend, static, dynamic, windowed and 2-D (static and dynamic), must
agree with the plain versions on the same inputs: K1's int32 ids, K2 (at
every degree 0-8 and in its runtime-degree form, float64 and float32,
with and without seg_lo's search tree, on edge lanes and ragged counts),
K3 (at every degree 0-3, float64 and float32, on edge lanes and ragged
counts), K4's Newton branch, K5 (on the sentinel tail, NaN bounds and
ragged counts, and the window's 131,072-slot layout), K6 (on NaN
measures, the sentinel tail, NaN bounds and odd counts), K8 (NaN and
+-inf corners, ragged counts) and the 2-D kernels exactly (NaN as NaN), the
others to rtol = atol = 1e-9 (compiled with -fmad=false, they are
expected to agree bit for bit).  The one-hot scans of the ``cuda_scan`` backend, K14 (range SUM),
K15 (range MAX), K16 (buffered SUM), K17 (buffered MAX) and K4's scan
mode, equal their plain versions and their gather twins exactly (K16 on
a SUM log within 1e-12 of the lane's sum of |measure|: the plain product
may add in another order), and the ``cuda_scan`` backend equals ``cuda``
bit for bit, static, dynamic, windowed and through the session; K16 on
fills either side of its tile edges and on the window's 4,096-of-131,072
layout, K4's scan mode at ragged target counts, K15 (float64 and float32)
and K12 and K13 at ragged query counts and table lengths on tables in a
plan's layout (K15 on NaN lanes, an inverted range and every segment
boundary, K12 and K13 on corners on every split line, K13 also past the
root, on NaN corners and at every degree), K14 (float64 and float32) on
NaN, infinite, sentinel, below-the-table and inverted lanes and every
segment start at ragged range counts, and two launches of each equal bit
for bit.  K1 equals
its plain version on keys of 1 to 5,000 entries either side of its
search tree's leaf, node and level sizes, with the plans' tree and
without one.  The
two-key scans K18 (buffered COUNT) and K19 (buffered SUM, added in slot
order as its plain version adds; both also on the edge lanes of their x
ranks, logs with a NaN or an infinite x, -0.0, NaN and infinite measures
and a log of several staging rounds, K19 at ragged rectangle counts) and
K20 (buffered
dominance MAX) equal their plain versions exactly (K20 also on negative
measures, NaN measures in some tiles and the corners that reach the
sentinel tail, on logs of one to several tiles a chunk), and a
``DynamicEngine2D`` on ``cuda_scan``
runs them (no K9-K11) and equals ``cuda`` (COUNT and MIN bit for bit, SUM
to 1e-9).  K21 (``poly_eval``) and the float32 instantiations of K2, K3,
K14, K15 and K21 equal their plain versions exactly; each wrapper picks
its float32 or float64 launcher by the table's type, and every other
kernel still rejects float32; ``kernels.ops`` runs them on the card.  The
plain versions are held to the JAX reference by the CPU tests
(test_torch_locate.py, test_torch_kernels.py, test_torch_engine.py,
test_torch_quantile.py, test_torch_index2d.py, test_torch_engine2d.py,
test_torch_dynamic2d.py, test_torch_scan.py, test_torch_scan2d.py,
test_torch_ops.py), so this file imports no JAX: it runs on a machine
with a card and PyTorch alone.

    python -m pytest tests/test_torch_cuda.py -q      # skips without a card
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import torch

from repro_torch.api import ErrorBudget, PolyFit, QueryBatch, QuerySpec, TableSpec
from repro_torch.core import build_index_1d, build_index_2d
from repro_torch.core.exact import build_sparse_table
from repro_torch.data import (hki_series, make_queries_1d, make_queries_2d,
                              osm_points, tweet_latitudes)
from repro_torch.engine import (DeltaBuffer2D, DynamicEngine,
                                DynamicEngine2D, Engine, WindowEngine,
                                build_plan, build_plan_2d, execute_extremum,
                                execute_quantile, raw_sum)
from repro_torch.engine.dynamic import _append_1d, _append_2d
from repro_torch.core import boundary_array
from repro_torch.engine.engine import quantile_mass, quantile_tables
from repro_torch.engine.plan import big_sentinel
from repro_torch.kernels import delta_scan as kdelta
from repro_torch.kernels import leaf_eval2d as k2d
from repro_torch.kernels import locate as kloc
from repro_torch.kernels import ops
from repro_torch.kernels import poly_eval as kp
from repro_torch.kernels import quantile_invert as kq
from repro_torch.kernels import range_max as kmax
from repro_torch.kernels import range_sum as ksum

TOL = dict(rtol=1e-9, atol=1e-9)
N = 4000
pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def plans(cuda):
    """Port plans built on the card: SUM deg 1-3, MAX deg 1-3, MIN deg 3."""
    t, v = hki_series(N, seed=3)
    out = {}
    for deg in (1, 2, 3):
        out["sum", deg] = build_plan(build_index_1d(
            t, v / 100, "sum", deg=deg, delta=100.0, device=cuda))
        out["max", deg] = build_plan(build_index_1d(
            t, v, "max", deg=deg, delta=30.0, device=cuda))
    out["min", 3] = build_plan(build_index_1d(t, v, "min", deg=3, delta=30.0,
                                              device=cuda))
    return t, out


@pytest.fixture(scope="module")
def queries(plans, cuda):
    """Endpoints from the keys, on boundaries and outside the domain,
    clamped to the domain as the engine clamps them; a ragged count."""
    t, _ = plans
    rng = np.random.default_rng(5)
    a, b = t[rng.integers(0, N, 70_000)], t[rng.integers(0, N, 70_000)]
    lq = np.concatenate([np.minimum(a, b), t[::40], [t[0] - 5.0] * 33])
    uq = np.concatenate([np.maximum(a, b), t[::40] + 3.0, [t[-1] + 5.0] * 33])
    return tuple(torch.as_tensor(np.maximum(q, t[0]), device=cuda)
                 for q in (lq, uq))


def test_locate_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    seg = np.sort(rng.uniform(0, 100, 37))
    padded = np.concatenate([seg, np.full(512 - 37, big_sentinel(torch.float64))])
    edges = np.concatenate([seg, seg - 1e-9, seg + 1e-9,
                            [-1e9, seg[0] - 1.0, seg[-1] + 1.0, 1e9]])
    q = np.concatenate([edges, [np.nan], rng.uniform(-5, 105, 70_001)])
    qd, sd = (torch.as_tensor(x, device=cuda) for x in (q, padded))
    before = kloc.locate.launches
    got = kloc.locate(qd, sd)
    torch.cuda.synchronize()
    assert kloc.locate.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == qd.shape
    torch.testing.assert_close(got, kloc.locate_segments(sd, qd), rtol=0,
                               atol=0)
    np.testing.assert_array_equal(
        got.cpu().numpy()[:len(edges)],
        np.maximum(np.searchsorted(padded, edges, side="right") - 1, 0))


# K1's search tree: sizes either side of a full leaf (4 keys), a full node
# (5 children) and a level, and larger tables
TREE_SIZES = [1, 2, 3, 4, 5, 6, 24, 25, 26, 4097, 5000]


def _tree_case(n, seed=0):
    """n sorted keys with runs of duplicates (a sentinel-padded tail from 24
    keys on), and queries on every key, the next doubles either side of
    every key, NaN, +-inf and random values."""
    rng = np.random.default_rng(seed + n)
    keys = np.sort(np.round(rng.uniform(0, 50, n)))
    if n >= 24:
        keys[-(n // 8):] = big_sentinel(torch.float64)
    q = np.concatenate([keys, np.nextafter(keys, -np.inf),
                        np.nextafter(keys, np.inf),
                        [np.nan, -np.inf, np.inf, -0.0],
                        rng.uniform(-5, 55, 3000)])
    return keys, q


@pytest.mark.parametrize("n", TREE_SIZES)
def test_locate_tree_kernel_matches_plain(cuda, n):
    """K1 (the descent of the keys' search tree) equals the plain binary
    search in every lane, with the tree passed as the plans pass it and
    without one (the wrapper builds it); one launch a call."""
    keys, q = _tree_case(n)
    kd, qd = (torch.as_tensor(a, device=cuda) for a in (keys, q))
    tree = kloc.search_tree(kd)
    want = kloc.locate_segments(kd, qd)
    before = kloc.locate.launches
    got = kloc.locate(qd, kd, tree)
    bare = kloc.locate(qd, kd)
    torch.cuda.synchronize()
    assert kloc.locate.launches == before + 2
    assert got.dtype == torch.int32 and got.shape == qd.shape
    assert torch.equal(got, want) and torch.equal(bare, want)
    assert torch.equal(kloc.tree_count(kd, tree, qd),
                       kloc.bsearch_count(kd, qd))
    ok = ~np.isnan(q)   # numpy sorts NaN last; the search counts it 0
    np.testing.assert_array_equal(
        got.cpu().numpy()[ok],
        np.maximum(np.searchsorted(keys, q[ok], side="right") - 1, 0))
    assert not got.cpu().numpy()[~ok].any()


def test_locate_rejects_a_misaligned_or_misshapen_tree(cuda):
    keys, q = _tree_case(4097)
    kd, qd = (torch.as_tensor(a, device=cuda) for a in (keys, q))
    tree = kloc.search_tree(kd)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kloc.locate(qd, kd[1:], kloc.search_tree(kd[1:]))
    with pytest.raises(ValueError, match="search tree"):
        kloc.locate(qd, kd[:1000], tree)
    with pytest.raises(ValueError, match="CUDA device"):
        kloc.locate(qd, kd, tree.cpu())


def test_plans_carry_their_keys_search_tree(cuda, plans, plans2d):
    """Every plan built on the card carries its keys' search tree, aligned
    for K1, and every 1-D plan, whatever its aggregate, its starts' search
    tree, aligned for K2 and K3; ``tree_bytes`` counts both."""
    _, by_key = plans
    *_, by_key2d = plans2d
    for p in (*by_key.values(), *by_key2d.values()):
        keys = p.ref_keys if hasattr(p, "ref_keys") else p.ref_xs
        tree = p.ref_tree if hasattr(p, "ref_keys") else p.ref_xs_tree
        assert torch.equal(tree.nan_to_num(-1.0),
                           kloc.search_tree(keys).nan_to_num(-1.0))
        assert keys.data_ptr() % 16 == 0 and tree.data_ptr() % 16 == 0
        seg_tree = getattr(p, "seg_tree", None)
        if seg_tree is not None:
            assert torch.equal(seg_tree.nan_to_num(-1.0),
                               kloc.search_tree(p.seg_lo).nan_to_num(-1.0))
            assert p.seg_lo.data_ptr() % 16 == seg_tree.data_ptr() % 16 == 0
        assert (seg_tree is not None) == hasattr(p, "seg_lo")
        assert p.tree_bytes() == 8 * (tree.numel() + (
            0 if seg_tree is None else seg_tree.numel()))


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_range_sum_kernel_matches_plain(plans, queries, deg):
    p = plans[1]["sum", deg]
    args = (*queries, p.seg_lo, p.seg_hi, p.coeffs)
    before = ksum.range_sum_gather.launches
    got = ksum.range_sum_gather(*args)
    torch.cuda.synchronize()
    assert ksum.range_sum_gather.launches == before + 1
    torch.testing.assert_close(got, ksum.range_sum_gather_plain(*args), **TOL)


@pytest.mark.parametrize("agg,deg", [("max", 1), ("max", 2), ("max", 3),
                                     ("min", 3)])
def test_range_max_kernel_matches_plain(plans, queries, agg, deg):
    """K3 (two threads a query, one instantiation a degree) equals its plain
    version in every lane on the plans' ranges; one launch a call."""
    p = plans[1][agg, deg]
    args = (*queries, p.seg_lo, p.seg_hi, p.coeffs, p.st)
    before = kmax.range_max_gather.launches
    got = kmax.range_max_gather(*args)
    torch.cuda.synchronize()
    assert kmax.range_max_gather.launches == before + 1
    torch.testing.assert_close(got, kmax.range_max_gather_plain(*args),
                               rtol=0, atol=0, equal_nan=True)


def _k3_table(cuda, dt, deg):
    """A MAX segment table in a plan's layout (_segment_table: 300 live
    segments of 512, two equal starts) at ``deg`` (its rows' first deg + 1
    coefficients) with the sparse table over its live aggregates:
    (seg_lo, seg_hi, coeffs, st), st float64 as a plan keeps it."""
    lo, _, hi, cf, agg = _segment_table(cuda, 300, 512, dt, seed=deg)
    live = agg[torch.isfinite(agg)].double().cpu().numpy()
    st = torch.as_tensor(build_sparse_table(live), device=cuda)
    return lo, hi, cf[:, :deg + 1].contiguous(), st


def _k3_edge_lanes(lo, Q):
    """Q ranges over a _k3_table, its edge lanes first: every pairing of
    NaN, +-inf, below the table, past its last segment and the sentinel;
    lq == uq on every start, a range inside each segment (il == iu), a
    start paired with the third start on, and the same inverted; then
    ranges from [-5, 1005]."""
    big = big_sentinel(lo.dtype)
    s = lo[lo < big].cpu().numpy()
    dt = s.dtype
    special = np.array([np.nan, np.inf, -np.inf, -1.0, 1004.0, big],
                       dtype=dt)
    a, b = np.meshgrid(special, special)
    inside = s[:-1] + (s[1:] - s[:-1]) / 3
    far = np.roll(s, -3)
    rng = np.random.default_rng(Q)
    x, y = rng.uniform(-5, 1005, (2, Q)).astype(dt)
    lq = np.concatenate([a.ravel(), s, s[:-1], inside, s, far,
                         np.minimum(x, y)])[:Q]
    uq = np.concatenate([b.ravel(), s, inside, inside, far, s,
                         np.maximum(x, y)])[:Q]
    return (torch.as_tensor(lq, device=lo.device),
            torch.as_tensor(uq, device=lo.device))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_range_max_kernel_edge_lanes_and_ragged_counts(cuda, deg, Q, dt):
    """K3 equals its plain version in every lane (NaN as NaN) at every
    degree it admits, at float64 and float32, at ragged query counts (an
    odd count leaves the last query's second thread a lane past Q), on NaN,
    infinite, below-the-table, past-the-end and sentinel endpoints, ranges
    with lq == uq, inside one segment (il == iu), on every start and
    inverted; one launch a call, and two launches give the same bits."""
    lo, hi, cf, st = _k3_table(cuda, dt, deg)
    lq, uq = _k3_edge_lanes(lo, Q)
    args = (lq, uq, lo, hi, cf, st)
    before = kmax.range_max_gather.launches
    got = kmax.range_max_gather(*args)
    again = kmax.range_max_gather(*args)
    torch.cuda.synchronize()
    assert kmax.range_max_gather.launches == before + 2
    assert got.shape == (Q,) and got.dtype == dt
    torch.testing.assert_close(got, kmax.range_max_gather_plain(*args),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got.view(torch.int32 if dt == torch.float32
                                else torch.int64),
                       again.view(torch.int32 if dt == torch.float32
                                  else torch.int64))


def test_range_max_kernel_refuses_misaligned_rows(cuda):
    """K3 reads rows by 16-byte loads: coeffs that start off 16 bytes (an
    offset view) are refused, a copy of them is taken."""
    lo, hi, cf, st = _k3_table(cuda, torch.float64, 3)
    buf = torch.empty(cf.numel() + 1, dtype=cf.dtype, device=cuda)
    off = buf[1:].view(cf.shape)
    off.copy_(cf)
    lq, uq = _k3_edge_lanes(lo, 1000)
    with pytest.raises(ValueError, match="16-byte"):
        kmax.range_max_gather(lq, uq, lo, hi, off, st)
    torch.testing.assert_close(
        kmax.range_max_gather(lq, uq, lo, hi, off.clone(), st),
        kmax.range_max_gather(lq, uq, lo, hi, cf, st), rtol=0, atol=0,
        equal_nan=True)


def _k2_table(cuda, dt, deg):
    """A SUM segment table in a plan's layout (_segment_table: 300 live
    segments of 512, two equal starts) with random rows of ``deg``:
    (seg_lo, seg_hi, coeffs)."""
    lo, _, hi, _, _ = _segment_table(cuda, 300, 512, dt, seed=deg)
    rng = np.random.default_rng(deg)
    cf = torch.as_tensor(rng.normal(0, 1, (512, deg + 1)), dtype=dt)
    cf[300:] = 0.0
    return lo, hi, cf.to(cuda)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5, 6, 7, 8, 10])
def test_range_sum_kernel_every_degree_and_ragged_counts(cuda, deg, Q, dt):
    """K2 (two threads a query, seg_lo's search tree) equals its plain
    version in every lane (NaN as NaN) at every instantiated degree 0-8 and
    in the runtime-degree form (deg 10), at float64 and float32, at ragged
    query counts (an odd count leaves the last query's pair partly past Q),
    on NaN, infinite, below-the-table, past-the-end and sentinel endpoints,
    lq == uq, inside one segment, on every start and inverted; with the
    tree passed as the plans pass it and without one (the wrapper builds
    it); one launch a call, and the two give the same bits."""
    lo, hi, cf = _k2_table(cuda, dt, deg)
    lq, uq = _k3_edge_lanes(lo, Q)
    args = (lq, uq, lo, hi, cf)
    before = ksum.range_sum_gather.launches
    got = ksum.range_sum_gather(*args, kloc.search_tree(lo))
    bare = ksum.range_sum_gather(*args)
    torch.cuda.synchronize()
    assert ksum.range_sum_gather.launches == before + 2
    assert got.shape == (Q,) and got.dtype == dt
    torch.testing.assert_close(got, ksum.range_sum_gather_plain(*args),
                               rtol=0, atol=0, equal_nan=True)
    bits = torch.int32 if dt == torch.float32 else torch.int64
    assert torch.equal(got.view(bits), bare.view(bits))


def test_range_sum_kernel_refuses_a_misaligned_or_misshapen_tree(cuda):
    """K2 reads seg_lo, coeffs and the tree 16 bytes at a time: a tree, a
    seg_lo or coeffs that start off 16 bytes (offset views) are refused, a
    copy is taken; so are a tree of another shape and one off the card."""
    lo, hi, cf = _k2_table(cuda, torch.float64, 3)
    lq, uq = _k3_edge_lanes(lo, 1000)
    tree = kloc.search_tree(lo)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for args in ((lo, hi, cf, offset(tree)), (offset(lo), hi, cf, tree),
                 (lo, hi, offset(cf), tree)):
        with pytest.raises(ValueError, match="16-byte"):
            ksum.range_sum_gather(lq, uq, *args)
    with pytest.raises(ValueError, match="search tree"):
        ksum.range_sum_gather(lq, uq, lo, hi, cf, tree[:-1].clone())
    with pytest.raises(ValueError, match="search tree"):
        ksum.range_sum_gather(lq, uq, lo, hi, cf, kloc.search_tree(lo[:300]))
    with pytest.raises(ValueError, match="CUDA device"):
        ksum.range_sum_gather(lq, uq, lo, hi, cf, tree.cpu())
    assert torch.equal(
        ksum.range_sum_gather(lq, uq, lo, hi, cf, offset(tree).clone())
        .view(torch.int64),
        ksum.range_sum_gather(lq, uq, lo, hi, cf, tree).view(torch.int64))


def test_kernels_reject_cpu_tensors_mixed_in(plans, queries):
    p = plans[1]["sum", 2]
    with pytest.raises(ValueError, match="CUDA device"):
        ksum.range_sum_gather(*queries, p.seg_lo.cpu(), p.seg_hi, p.coeffs)


@pytest.mark.parametrize("agg", ["sum", "max", "min"])
@pytest.mark.parametrize("eps_rel", [None, 0.05])
def test_cuda_backend_matches_torch_backend(plans, queries, agg, eps_rel):
    """The engine's default backend on the card runs the kernels (K1 in the
    Q_rel refinement) and agrees with the plain 'torch' backend, which runs
    none of them, refined flags included."""
    p = plans[1][agg, 3 if agg != "sum" else 2]
    lq, uq = queries
    kernel = ksum.range_sum_gather if agg == "sum" else kmax.range_max_gather
    counts = lambda: (kernel.launches, kloc.locate.launches,
                      execute_extremum.torch_routes)
    before = counts()
    got = Engine().query(p, lq, uq, eps_rel=eps_rel)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1,
                        before[1] + (0 if eps_rel is None else 2), before[2])
    before = counts()
    want = Engine(backend="torch").query(p, lq, uq, eps_rel=eps_rel)
    assert counts() == before
    torch.testing.assert_close(got.answer, want.answer, **TOL)
    torch.testing.assert_close(got.refined, want.refined, rtol=0, atol=0)


def test_session_on_card_matches_cpu_session():
    """PolyFit.fit picks the card by default; the same tables fitted on the
    CPU answer the same mixed batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    lat = tweet_latitudes(20_000)
    t, v = hki_series(20_000)
    datasets = {"lat": lat, "hki": (t, v)}
    specs = {"lat": TableSpec("count", ErrorBudget(abs=100.0, rel=0.01)),
             "hki": TableSpec("max", ErrorBudget(abs=50.0, rel=0.01))}
    card = PolyFit.fit(datasets, specs)
    host = PolyFit.fit(datasets, specs, device="cpu")
    assert card.backend == "cuda" and host.backend == "torch"
    batch = QueryBatch.of(QuerySpec.range("lat", *make_queries_1d(lat, 5000)),
                          QuerySpec.range("hki", *make_queries_1d(t, 3000)))
    for g, w in zip(card.query(batch), host.query(batch)):
        torch.testing.assert_close(g.value.cpu(), w.value, **TOL)
        torch.testing.assert_close(g.refined.cpu(), w.refined, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5 / K6 and the dynamic engine
# ---------------------------------------------------------------------------

CAP = 4096


def _log(cuda, fill, with_st, cap=CAP):
    """A sorted, sentinel-padded delta log of ``fill`` entries in ``cap``
    slots (ties included) built by the engine's append on the card."""
    rng = np.random.default_rng(fill)
    big = big_sentinel(torch.float64)
    k = np.full(cap, big)
    v = np.zeros(cap)
    k[:fill] = np.round(rng.uniform(0, 1000, fill), 1)
    v[:fill] = rng.normal(0, 50, fill)
    empty = torch.full((cap,), big, dtype=torch.float64, device=cuda)
    zero = torch.zeros(cap, dtype=torch.float64, device=cuda)
    return _append_1d(empty, zero, torch.as_tensor(k, device=cuda),
                      torch.as_tensor(v, device=cuda), cap=cap,
                      with_st=with_st)


def _delta_queries(cuda, tail=False):
    """Ranges inside, across and outside the log's keys (below the first,
    above the last, an empty span on a key, an inverted range); with
    ``tail``, lanes that reach the log's sentinel tail or hold a NaN bound
    follow: uq = +inf, lq = uq = sentinel, NaN lq, NaN uq."""
    rng = np.random.default_rng(17)
    a, b = rng.uniform(-100, 1100, (2, 70_000))
    lq = np.concatenate([np.minimum(a, b), [-1e9, 2000.0, 500.0, 600.0]])
    uq = np.concatenate([np.maximum(a, b), [-5.0, 1e9, 500.0, 599.0]])
    if tail:
        big, inf, nan = big_sentinel(torch.float64), np.inf, np.nan
        lq = np.concatenate([lq, a[:999], [-inf, big, 2000.0, big, nan, 0.0,
                                           nan]])
        uq = np.concatenate([uq, np.full(999, inf), [inf, big, inf, inf,
                                                     500.0, nan, nan]])
    return tuple(torch.as_tensor(q, device=cuda) for q in (lq, uq))


@pytest.mark.parametrize("Q", [1, 255, 65_537, None],
                         ids=["1", "255", "65537", "all"])
@pytest.mark.parametrize("fill,cap", [(0, CAP), (37, CAP), (CAP, CAP),
                                      (CAP, 32 * CAP)])
def test_delta_sum_kernel_matches_plain(cuda, fill, cap, Q):
    """K5 (two threads a query) equals its plain version exactly, NaN as
    NaN, on empty, partly filled and full 4,096-slot logs and the window's
    131,072-slot layout of 4,096 keys; on ranges inside, across and outside the keys,
    inverted ones, lanes that reach the sentinel tail or hold a NaN bound,
    at ragged query counts (an odd count leaves the last pair one query);
    one launch a call."""
    keys, _, cf, _ = _log(cuda, fill, False, cap=cap)
    lq, uq = (q[-Q:] if Q else q for q in _delta_queries(cuda, tail=True))
    before = kdelta.delta_sum_gather.launches
    got = kdelta.delta_sum_gather(lq, uq, keys, cf)
    torch.cuda.synchronize()
    assert kdelta.delta_sum_gather.launches == before + 1
    assert got.shape == lq.shape
    torch.testing.assert_close(
        got, kdelta.delta_sum_gather_plain(lq, uq, keys, cf), rtol=0, atol=0,
        equal_nan=True)
    if fill == 0:
        assert not got.any()


@pytest.mark.parametrize("fill", [0, 37, CAP])
def test_delta_max_kernel_matches_plain(cuda, fill):
    keys, vals, _, st = _log(cuda, fill, True)
    lq, uq = _delta_queries(cuda)
    before = kdelta.delta_max_gather.launches
    got = kdelta.delta_max_gather(lq, uq, keys, st)
    torch.cuda.synchronize()
    assert kdelta.delta_max_gather.launches == before + 1
    torch.testing.assert_close(
        got, kdelta.delta_max_gather_plain(lq, uq, keys, st), **TOL)
    assert torch.isneginf(got[-4:-2]).all()   # no key in either range
    if fill == 0:
        assert torch.isneginf(got).all()


def test_delta_kernels_reject_bad_arguments(cuda):
    keys, _, cf, st = _log(cuda, 10, True)
    lq, uq = _delta_queries(cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_sum_gather(lq, uq, keys, cf[:-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_max_gather(lq, uq, keys, st[:2])
    with pytest.raises(ValueError, match="CUDA device"):
        kdelta.delta_sum_gather(lq, uq, keys.cpu(), cf)


@pytest.mark.parametrize("agg", ["sum", "count", "max", "min"])
def test_dynamic_cuda_backend_matches_torch_backend(cuda, agg):
    """DynamicEngine on the card: the default 'cuda' backend runs K5 (SUM/
    COUNT) or K6 (MAX/MIN) beside K2/K3, and K1 in the refinement and the
    victim path, and agrees with the plain 'torch' backend after inserts,
    deletes, a flush and more updates, refined flags included."""
    t, v = hki_series(N, seed=3)
    meas = None if agg == "count" else (v / 100 if agg == "sum" else v)
    delta = 100.0 if agg in ("sum", "count") else 30.0
    deg = 2 if agg in ("sum", "count") else 3
    idx = build_index_1d(t, meas, agg, deg=deg, delta=delta, device=cuda)
    dev = DynamicEngine(idx, capacity=256, auto_refit=False)
    host = DynamicEngine(idx, backend="torch", capacity=256, auto_refit=False)
    assert dev.backend == "cuda"
    rng = np.random.default_rng(23)
    extremal = agg in ("max", "min")
    delta_k = kdelta.delta_max_gather if extremal else kdelta.delta_sum_gather
    static_k = kmax.range_max_gather if extremal else ksum.range_sum_gather
    counts = lambda: (delta_k.launches, static_k.launches,
                      kloc.locate.launches, execute_extremum.torch_routes)
    a, b = t[rng.integers(0, N, 3000)], t[rng.integers(0, N, 3000)]
    lq = np.concatenate([np.minimum(a, b), [t[0] - 50.0, t[-1] - 1.0]])
    uq = np.concatenate([np.maximum(a, b), [t[0] - 10.0, t[-1] + 60.0]])

    def update(step):
        ins_k = np.concatenate([rng.uniform(t[0], t[-1], 40),
                                [t[0] - 20.0 - step, t[-1] + 30.0 + step]])
        ins_v = rng.uniform(25_000, 40_000, len(ins_k))
        gone = t[rng.choice(N, 12, replace=False)]
        for dyn in (dev, host):
            if agg == "count":
                dyn.insert(ins_k)
            else:
                dyn.insert(ins_k, ins_v / 100 if agg == "sum" else ins_v)
            dyn.delete(gone)

    def compare():
        victims = extremal and dev.snapshot()[1].vic_keys is not None
        for eps_rel in (None, 0.05):
            before = counts()
            got = dev.query(lq, uq, eps_rel=eps_rel)
            torch.cuda.synchronize()
            k1 = 2 if (eps_rel is not None or victims) else 0
            assert counts() == (before[0] + (1 if extremal else 2),
                                before[1] + 1, before[2] + k1, before[3])
            before = counts()
            want = host.query(lq, uq, eps_rel=eps_rel)
            assert counts() == before
            torch.testing.assert_close(got.answer, want.answer, **TOL)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)

    update(0)
    compare()
    dev.flush()
    host.flush()
    assert dev.refit_count == host.refit_count == 1
    for f in ("seg_lo", "seg_hi", "coeffs"):
        torch.testing.assert_close(getattr(dev.index, f).cpu(),
                                   getattr(host.index, f).cpu(), rtol=0,
                                   atol=0)
    compare()
    update(1)   # extremal deletes now shadow victims in a fresh buffer
    compare()


# ---------------------------------------------------------------------------
# K4, the dynamic quantile and the window tables
# ---------------------------------------------------------------------------

NQ4 = 4096


@pytest.fixture(scope="module")
def quantile_plans(cuda):
    """Port plans built on the card, n = 4,096: COUNT and SUM, deg 1-5."""
    t, v = hki_series(NQ4, seed=11)
    out = {}
    for deg in (1, 2, 3, 4, 5):
        out["count", deg] = build_plan(build_index_1d(
            t, None, "count", deg=deg, delta=24.0, device=cuda))
        out["sum", deg] = build_plan(build_index_1d(
            t, v / 100, "sum", deg=deg, delta=100.0, device=cuda))
    return out


def _fractions(cuda):
    """The rank ends, a fine grid and random fractions: a ragged count."""
    rng = np.random.default_rng(41)
    q = np.concatenate([[0.0, 1.0], np.linspace(0, 1, 4097),
                        rng.uniform(0, 1, 60_000)])
    return torch.as_tensor(q, device=cuda)


def _k4_args(plan, q):
    """The static executor's K4 arguments for fractions ``q``."""
    M, slack = quantile_mass(plan)
    err, B, keys, nk = quantile_tables(plan)
    t = torch.clamp(q, 0.0, 1.0) * M
    return ((t, t - slack, t + slack, B, plan.seg_lo, plan.seg_hi,
             plan.coeffs, err, keys),
            dict(h=plan.h, n=nk, delta=float(plan.delta)))


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_quantile_invert_kernel_matches_plain(cuda, quantile_plans, agg,
                                              deg):
    args, kw = _k4_args(quantile_plans[agg, deg], _fractions(cuda))
    before = kq.quantile_invert.launches
    got = kq.quantile_invert(*args, **kw)
    torch.cuda.synchronize()
    assert kq.quantile_invert.launches == before + 1
    want = kq.quantile_invert_plain(*args, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    lo, hi = got[1], got[2]
    assert torch.all(got[0] <= hi) and torch.all(lo <= got[0] + 1e-9)


def _k4_wide(plan, deg, Q):
    """K4's arguments on ``plan`` for Q fractions (0, 1, uniform draws; the
    last two targets past the mass and below 0 from Q = 4 on), its rows
    widened to ``deg`` above the plan's 5 by small random higher terms on
    the live rows (the boundary array recomputed from them)."""
    rng = np.random.default_rng(Q + deg)
    q = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, Q)])[:Q]
    args, kw = _k4_args(plan, torch.as_tensor(q, device=plan.device))
    args = list(args)
    if Q >= 4:
        M, slack = quantile_mass(plan)
        t = args[0].clone()
        t[-2], t[-1] = 3.0 * M, -3.0
        args[:3] = t, t - slack, t + slack
    if deg > 5:
        extra = torch.zeros((args[6].shape[0], deg - 5), dtype=torch.float64)
        extra[:plan.h] = torch.as_tensor(rng.normal(0, 1e-3,
                                                    (plan.h, deg - 5)))
        args[6] = torch.cat([args[6], extra.to(plan.device)], dim=1)
        args[3] = boundary_array(args[6])
    return tuple(args), kw


@pytest.mark.parametrize("Q", [1, 11, 81, 65_537])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5, 6, 7, 8])
def test_quantile_invert_kernel_every_degree_and_ragged_counts(
        cuda, quantile_plans, deg, Q):
    """K4's gather mode (three lanes a target, ten targets a warp, the snap
    by a descent of the key grid's tree) equals its plain version in every
    lane at every instantiated degree 1-8 (deg 6-8: the deg-5 plan's rows
    widened), at target counts that leave a warp or a block part empty,
    with targets past the mass and below 0; with the plan's ``ref_tree``
    and without a tree (the wrapper builds it): one launch a call, and the
    two give the same bits."""
    plan = quantile_plans["sum" if deg % 2 else "count", min(deg, 5)]
    args, kw = _k4_wide(plan, deg, Q)
    assert args[0].shape == (Q,) and args[6].shape[1] == deg + 1
    before = kq.quantile_invert.launches
    got = kq.quantile_invert(*args, plan.ref_tree, **kw)
    bare = kq.quantile_invert(*args, **kw)
    torch.cuda.synchronize()
    assert kq.quantile_invert.launches == before + 2
    want = kq.quantile_invert_plain(*args, **kw)
    for g, b, w in zip(got, bare, want):
        assert g.shape == (Q,)
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert torch.equal(g.view(torch.int64), b.view(torch.int64))


def test_quantile_invert_refuses_a_misaligned_or_misshapen_tree(
        cuda, quantile_plans):
    """K4 reads its rows, the key grid and the grid's tree 16 bytes at a
    time: coeffs, ref_keys or a tree that start off 16 bytes (offset
    views) are refused, and coeffs in the scan mode too; a copy is taken;
    so are a tree of another shape and one off the card."""
    plan = quantile_plans["count", 3]
    args, kw = _k4_args(plan, _fractions(cuda)[:5000])
    tree = plan.ref_tree

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    with pytest.raises(ValueError, match="16-byte"):
        kq.quantile_invert(*args, offset(tree), **kw)
    with pytest.raises(ValueError, match="16-byte"):
        kq.quantile_invert(*args[:8], offset(args[8]), tree, **kw)
    for scan in (False, True):
        with pytest.raises(ValueError, match="16-byte"):
            kq.quantile_invert(*args[:6], offset(args[6]), *args[7:], tree,
                               scan=scan, **kw)
    with pytest.raises(ValueError, match="search tree"):
        kq.quantile_invert(*args, tree[:-1].clone(), **kw)
    with pytest.raises(ValueError, match="search tree"):
        kq.quantile_invert(*args, kloc.search_tree(args[8][:kw["n"] - 300]),
                           **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        kq.quantile_invert(*args, tree.cpu(), **kw)
    for g, w in zip(kq.quantile_invert(*args, offset(tree).clone(), **kw),
                    kq.quantile_invert(*args, tree, **kw)):
        assert torch.equal(g.view(torch.int64), w.view(torch.int64))


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [4, 5])
def test_quantile_newton_branch_bit_identical(cuda, quantile_plans, agg,
                                              deg):
    """Above deg 3 K4 solves by Newton with emulated fused multiply-adds,
    step for step as the plain version: every lane equal."""
    args, kw = _k4_args(quantile_plans[agg, deg], _fractions(cuda))
    got = kq.quantile_invert(*args, **kw)
    want = kq.quantile_invert_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _ulps(a, b):
    """Per lane, the units in the last place between a and b (0 where they
    are equal, NaN included; inf where their signs or finiteness differ)."""
    ia, ib = a.view(torch.int64), b.view(torch.int64)
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    comparable = (torch.sign(a) == torch.sign(b)) & torch.isfinite(a) \
        & torch.isfinite(b)
    gap = (ia - ib).abs().double()
    return torch.where(same, 0.0, torch.where(comparable, gap, torch.inf))


def test_quantile_deg3_kernel_ulps_to_plain(cuda):
    """K4 at deg 3, gather and scan modes, against its plain version on an
    HKI SUM table of the smoke's kind (the price summed, deg 3, delta 5e4;
    20,000 keys) at 65,536 fractions (seed 57 uniform draws plus 0 and 1):
    within the 1e-9 bar, and the largest gap in units in the last place is
    printed."""
    t, v = hki_series(20_000, seed=0)
    plan = build_plan(build_index_1d(t, v, "sum", deg=3, delta=5e4,
                                     device=cuda))
    rng = np.random.default_rng(57)
    fr = np.concatenate([[0.0, 1.0], rng.uniform(0.0, 1.0, 65_534)])
    args, kw = _k4_args(plan, torch.as_tensor(fr, device=cuda))
    for scan in (False, True):
        got = kq.quantile_invert(*args, scan=scan, **kw)
        want = kq.quantile_invert_plain(*args, scan=scan, **kw)
        torch.cuda.synchronize()
        for label, g, w in zip(("answer", "lo", "hi"), got, want):
            torch.testing.assert_close(g, w, **TOL)
            gap = _ulps(g, w)
            worst = int(gap.argmax())
            print(f"K4 deg 3 {'scan' if scan else 'gather'} {label}: "
                  f"largest ulp gap {float(gap.max())!r} at lane {worst} "
                  f"(fraction {fr[worst]!r}), {int((gap > 0).sum())} lanes "
                  "differ")


def test_quantile_kernel_rejects_bad_arguments(cuda, quantile_plans):
    args, kw = _k4_args(quantile_plans["count", 2], _fractions(cuda))
    with pytest.raises(ValueError, match="shape mismatch"):
        kq.quantile_invert(*args[:3], args[3][:-1], *args[4:], **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        kq.quantile_invert(*args[:8], args[8].cpu(), **kw)
    wide = torch.zeros((args[6].shape[0], kq.MAX_DEG + 2),
                       dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="degree"):
        kq.quantile_invert(*args[:6], wide, *args[7:], **kw)


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_quantile_cuda_backend_matches_torch_backend(cuda, quantile_plans,
                                                     agg):
    """execute_quantile on the card runs K4 once a batch and agrees with
    the plain 'torch' backend, which runs no kernel."""
    plan = quantile_plans[agg, 3]
    q = _fractions(cuda)
    before = kq.quantile_invert.launches
    got = execute_quantile(plan, q)
    torch.cuda.synchronize()
    assert kq.quantile_invert.launches == before + 1
    want = execute_quantile(plan, q, backend="torch")
    assert kq.quantile_invert.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_dynamic_quantile_same_on_both_backends(cuda, agg):
    """The dynamic quantile is one plain path for every backend: the
    'cuda' and 'torch' engines give bit-identical triples after inserts,
    deletes, a flush and more updates, and launch no K4."""
    t, v = hki_series(NQ4, seed=13)
    meas = None if agg == "count" else v / 100
    idx = build_index_1d(t, meas, agg, deg=2, delta=50.0, device=cuda)
    dev = DynamicEngine(idx, capacity=256, auto_refit=False)
    host = DynamicEngine(idx, backend="torch", capacity=256,
                         auto_refit=False)
    assert dev.backend == "cuda"
    rng = np.random.default_rng(43)
    q = _fractions(cuda)

    def update(step):
        ins_k = np.concatenate([rng.uniform(t[0], t[-1], 60),
                                [t[0] - 10.0 - step, t[-1] + 10.0 + step]])
        ins_v = rng.uniform(250, 400, len(ins_k)) / 100
        gone = t[rng.choice(NQ4, 20, replace=False)]
        for dyn in (dev, host):
            if agg == "count":
                dyn.insert(ins_k)
            else:
                dyn.insert(ins_k, ins_v)
            dyn.delete(gone)

    def compare():
        before = kq.quantile_invert.launches
        got, want = dev.quantile(q), host.quantile(q)
        torch.cuda.synchronize()
        assert kq.quantile_invert.launches == before
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)

    update(0)
    compare()
    dev.flush()
    host.flush()
    compare()
    update(1)
    compare()


def test_window_queries_launch_kernels(cuda):
    """A window table on the card runs K2 once per sealed epoch in the
    window, K5 when the window reaches the open epoch, K1 in each epoch's
    Q_rel truth, and agrees with the 'torch' backend."""
    lat = tweet_latitudes(5 * 3000, seed=19)
    epochs = np.split(lat, 5)
    kw = dict(agg="count", delta=50.0, ring=8, capacity=4096, device=cuda)
    dev = WindowEngine(epochs[0], **kw)
    host = WindowEngine(epochs[0], backend="torch", **kw)
    assert dev.backend == "cuda"
    for w in (dev, host):
        for e in epochs[1:4]:
            w.ingest(e)
            w.advance()
        w.ingest(epochs[4])
    lq, uq = make_queries_1d(lat, 20_000, seed=23)
    counts = lambda: (ksum.range_sum_gather.launches,
                      kdelta.delta_sum_gather.launches, kloc.locate.launches)
    for (t0, t1), sealed, open_ in (((0, 4), 4, 1), ((1, 3), 3, 0),
                                    ((4, 4), 0, 1), ((2, 2), 1, 0)):
        for eps_rel in (None, 0.01):
            before = counts()
            got = dev.query(lq, uq, t0, t1, eps_rel=eps_rel)
            torch.cuda.synchronize()
            k1 = 2 * sealed if eps_rel is not None else 0
            assert counts() == (before[0] + sealed, before[1] + open_,
                                before[2] + k1)
            before = counts()
            want = host.query(lq, uq, t0, t1, eps_rel=eps_rel)
            assert counts() == before
            torch.testing.assert_close(got.answer, want.answer, **TOL)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)


# ---------------------------------------------------------------------------
# 2-D: K7, K8 (locate->gather), K12, K13 (one-hot scan)
# ---------------------------------------------------------------------------

N2 = 3000


@pytest.fixture(scope="module")
def plans2d(cuda):
    """Port 2-D plans built on the card: COUNT at deg 1-3, a MAX plan, and
    a depth-0 plan (the root is the only leaf, one-entry cut grids)."""
    px, py = osm_points(N2, seed=29)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    out = {}
    for deg in (1, 2, 3):
        out["count2d", deg] = build_plan_2d(build_index_2d(
            px, py, deg=deg, delta=20.0, max_depth=6, device=cuda))
    out["max2d", 2] = build_plan_2d(build_index_2d(
        px, py, measures=w, agg="max2d", deg=2, delta=4.0, max_depth=6,
        device=cuda))
    out["depth0", 2] = build_plan_2d(build_index_2d(
        px, py, deg=2, delta=20.0, max_depth=0, device=cuda))
    return px, py, w, out


def _corners2d(plan, px, py, cuda, n=50_000):
    """Rectangles from the data, corners on every split line and on the
    root's edges, clamped into the root as the engine clamps them."""
    x0, x1, y0, y1 = plan.root
    lx, ux, ly, uy = make_queries_2d(px, py, n, seed=31)
    xc = plan.xcuts.cpu().numpy()
    yc = plan.ycuts.cpu().numpy()
    m = min(len(xc), len(yc))
    lx = np.concatenate([lx, xc[:m], [x0, x0, x1]])
    ux = np.concatenate([ux, xc[:m] + 1.0, [x1, x0, x1]])
    ly = np.concatenate([ly, yc[:m], [y0, y1, y0]])
    uy = np.concatenate([uy, yc[:m] + 1.0, [y1, y1, y1]])
    lo = [np.clip(q, x0, x1) for q in (lx, ux)]
    hi = [np.clip(q, y0, y1) for q in (ly, uy)]
    return tuple(torch.as_tensor(q, device=cuda)
                 for q in (lo[0], lo[1], hi[0], hi[1]))


def _tables(plan):
    gather = (plan.xcuts, plan.ycuts, plan.leaf_z, plan.leaf_bounds,
              plan.leaf_coeffs)
    scan = (plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0, plan.leaf_my1,
            plan.leaf_bounds, plan.leaf_coeffs)
    return gather, scan


@pytest.mark.parametrize("key", [("count2d", 1), ("count2d", 2),
                                 ("count2d", 3), ("max2d", 2),
                                 ("depth0", 2)])
def test_leaf_kernels_match_plain(cuda, plans2d, key):
    """K7, K8, K12 and K13 equal their plain versions in every lane, split
    lines and root edges included, and the gather and scan kernels equal
    each other on one plan."""
    px, py, _, plans = plans2d
    plan = plans[key]
    deg, depth = plan.deg, plan.max_depth
    lx, ux, ly, uy = _corners2d(plan, px, py, cuda)
    gather, scan = _tables(plan)
    launches = lambda: (k2d.corner_count2d_gather.launches,
                        k2d.corner_eval2d_gather.launches,
                        k2d.corner_count2d.launches,
                        k2d.corner_eval2d.launches)
    before = launches()
    k7 = k2d.corner_count2d_gather(lx, ux, ly, uy, *gather, deg, depth)
    k8 = k2d.corner_eval2d_gather(ux, uy, *gather, deg, depth)
    k12 = k2d.corner_count2d(lx, ux, ly, uy, *scan, deg)
    k13 = k2d.corner_eval2d(ux, uy, *scan, deg)
    torch.cuda.synchronize()
    assert launches() == tuple(b + 1 for b in before)
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(k7, k2d.corner_count2d_gather_plain(
        lx, ux, ly, uy, *gather, deg, depth), **exact)
    torch.testing.assert_close(k8, k2d.corner_eval2d_gather_plain(
        ux, uy, *gather, deg, depth), **exact)
    torch.testing.assert_close(k12, k2d.corner_count2d_plain(
        lx, ux, ly, uy, *scan, deg), **exact)
    torch.testing.assert_close(k13, k2d.corner_eval2d_plain(
        ux, uy, *scan, deg), **exact)
    torch.testing.assert_close(k7, k12, **exact)
    torch.testing.assert_close(k8, k13, **exact)


def test_leaf_kernels_reject_bad_arguments(cuda, plans2d):
    plan = plans2d[3]["count2d", 2]
    gather, scan = _tables(plan)
    q = torch.zeros(8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        k2d.corner_eval2d_gather(q, q, *gather[:2], gather[2].long(),
                                 *gather[3:], plan.deg, plan.max_depth)
    with pytest.raises(ValueError, match="CUDA device"):
        k2d.corner_eval2d(q, q.cpu(), *scan, plan.deg)
    with pytest.raises(ValueError, match="leaf table"):
        k2d.corner_eval2d(q, q, *scan, plan.deg + 1)


def _full_quadtree(cuda, depth, deg, seed=0):
    """A full quadtree built directly, no fit: every cell of a depth-level
    grid over an awkward root a leaf, z-sorted, random rows.  (root,
    xcuts, ycuts, leaf_z, bounds, coeffs)."""
    rng = np.random.default_rng(seed + depth)
    root = (-3.25, 96.75, 10.0, 10.0 + 60.5)
    xc = kloc.dyadic_cuts(root[0], root[1], depth)
    yc = kloc.dyadic_cuts(root[2], root[3], depth)
    gx = np.concatenate([[root[0]], xc, [root[1]]])
    gy = np.concatenate([[root[2]], yc, [root[3]]])
    m = 1 << depth
    ix, iy = (a.ravel() for a in np.meshgrid(np.arange(m), np.arange(m),
                                             indexing="ij"))
    b = np.stack([gx[ix], gx[ix + 1], gy[iy], gy[iy + 1]], axis=1)
    z = kloc.leaf_morton_codes(b, xc, yc, depth)
    order = np.argsort(z)
    to = lambda a: torch.as_tensor(a, device=cuda)
    return (root, to(xc), to(yc), to(z[order].astype(np.int32)),
            to(b[order]), to(rng.normal(0, 1, (m * m, (deg + 1) ** 2))))


def _quadtree_corners(root, xc, yc, Q, special=False):
    """Q rectangles over the root: corners on every split line and on the
    root's edges first, then uniform draws past the root, clamped into it
    as the engine clamps them; with ``special``, NaN and +-inf coordinates
    in the first lanes instead (not clamped)."""
    x0, x1, y0, y1 = root
    xs = np.concatenate([[x0, x1], xc.cpu().numpy()])
    ys = np.concatenate([[y0, y1], yc.cpu().numpy()])
    rng = np.random.default_rng(Q)
    a, b = rng.uniform(x0 - 5, x1 + 5, (2, Q))
    c, d = rng.uniform(y0 - 5, y1 + 5, (2, Q))
    a = np.concatenate([xs, a])[:Q]
    b = np.concatenate([rng.permutation(xs), b])[:Q]
    c = np.concatenate([np.resize(ys, len(xs)), c])[:Q]
    d = np.concatenate([rng.permutation(np.resize(ys, len(xs))), d])[:Q]
    q = [np.clip(np.minimum(a, b), x0, x1), np.clip(np.maximum(a, b), x0, x1),
         np.clip(np.minimum(c, d), y0, y1), np.clip(np.maximum(c, d), y0, y1)]
    if special:
        odd = np.array([np.nan, np.inf, -np.inf, np.nan, x0, np.inf])
        for k in range(4):
            q[k][:len(odd)] = np.roll(odd, k)
    return tuple(torch.as_tensor(v, device=xc.device) for v in q)


@pytest.mark.parametrize("deg", [0, 3, 5])
@pytest.mark.parametrize("Q", [1, 255, 65_537])
def test_corner_count2d_gather_kernel_full_quadtree(cuda, Q, deg):
    """K7 equals its plain version bit for bit on a full depth-7 quadtree
    (16,384 leaves: 7-level cut grids, 15-round code searches) at ragged
    query counts, corners on every split line and the root's edges first,
    at degrees whose rows it reads 8 (deg 0) and 16 bytes at a time; one
    launch a call, and two launches give the same bits."""
    root, *table = _full_quadtree(cuda, 7, deg)
    args = (*_quadtree_corners(root, table[0], table[1], Q), *table, deg, 7)
    before = k2d.corner_count2d_gather.launches
    got = k2d.corner_count2d_gather(*args)
    again = k2d.corner_count2d_gather(*args)
    torch.cuda.synchronize()
    assert k2d.corner_count2d_gather.launches == before + 2
    assert got.shape == (Q,)
    torch.testing.assert_close(got, k2d.corner_count2d_gather_plain(*args),
                               rtol=0, atol=0)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))


def test_corner_count2d_gather_kernel_special_lanes(cuda, plans2d):
    """K7 on NaN and +-inf corner coordinates equals its plain version (NaN
    equal) on a plan's table and on the full quadtree, and refuses a table
    that does not start on a 16-byte boundary (an offset view)."""
    px, py, _, plans = plans2d
    plan = plans["count2d", 3]
    tables = [(plan.root, _tables(plan)[0], plan.deg, plan.max_depth)]
    root, *table = _full_quadtree(cuda, 7, 3)
    tables.append((root, tuple(table), 3, 7))
    for root, gather, deg, depth in tables:
        qs = _quadtree_corners(root, gather[0], gather[1], 4099, special=True)
        got = k2d.corner_count2d_gather(*qs, *gather, deg, depth)
        torch.testing.assert_close(got, k2d.corner_count2d_gather_plain(
            *qs, *gather, deg, depth), rtol=0, atol=0, equal_nan=True)
        assert torch.isnan(got[:6]).any()
    xc, yc, lz, bounds, coeffs = tables[0][1]
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    q = torch.zeros(8, dtype=torch.float64, device=cuda)
    for b, c in ((off(bounds), coeffs), (bounds, off(coeffs))):
        with pytest.raises(ValueError, match="16-byte"):
            k2d.corner_count2d_gather(q, q, q, q, xc, yc, lz, b, c, 3,
                                      plan.max_depth)


@pytest.mark.parametrize("Q", [1, 255, 65_537])
def test_corner_eval2d_gather_kernel_special_lanes(cuda, plans2d, Q):
    """K8 (two threads a corner) equals its plain version bit for bit (NaN
    equal) on a plan's table and on full depth-7 quadtrees at degrees 0, 2
    and 5 (rows read 8 and 16 bytes at a time), at ragged corner counts,
    with NaN and +-inf coordinates in the first lanes and corners on every
    split line and the root's edges after them; one launch a call.  It
    refuses a table that does not start on a 16-byte boundary (an offset
    view) and equals its plain version on a copy of it."""
    plan = plans2d[3]["count2d", 3]
    tables = [(plan.root, _tables(plan)[0], plan.deg, plan.max_depth)]
    for deg in (0, 2, 5):
        root, *table = _full_quadtree(cuda, 7, deg)
        tables.append((root, tuple(table), deg, 7))
    for root, gather, deg, depth in tables:
        _, ux, _, uy = (c[:Q] for c in _quadtree_corners(
            root, gather[0], gather[1], max(Q, 6), special=True))
        before = k2d.corner_eval2d_gather.launches
        got = k2d.corner_eval2d_gather(ux, uy, *gather, deg, depth)
        torch.cuda.synchronize()
        assert k2d.corner_eval2d_gather.launches == before + 1
        assert got.shape == (Q,)
        _same(got, k2d.corner_eval2d_gather_plain(ux, uy, *gather, deg,
                                                  depth))
        if Q > 6:
            assert torch.isnan(got[:6]).any()
    xc, yc, lz, bounds, coeffs = tables[0][1]
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    q = torch.zeros(8, dtype=torch.float64, device=cuda)
    for b, c in ((off(bounds), coeffs), (bounds, off(coeffs))):
        with pytest.raises(ValueError, match="16-byte"):
            k2d.corner_eval2d_gather(q, q, xc, yc, lz, b, c, 3,
                                     plan.max_depth)
        args = (q + plan.root[0], q + plan.root[2], xc, yc, lz, b.clone(),
                c.clone(), 3, plan.max_depth)
        _same(k2d.corner_eval2d_gather(*args),
              k2d.corner_eval2d_gather_plain(*args))


@pytest.mark.parametrize("agg", ["count2d", "max2d"])
@pytest.mark.parametrize("eps_rel", [None, 0.05])
def test_2d_cuda_backend_matches_torch_backend(cuda, plans2d, agg, eps_rel):
    """The default backend on the card runs K7 (rectangles) or K8
    (corners), K1 in the Q_rel truth, and agrees with the 'torch' backend
    (the quadtree descent, no kernel), refined flags included."""
    px, py, _, plans = plans2d
    plan = plans[agg, 2]
    if agg == "count2d":
        ranges = make_queries_2d(px, py, 20_000, seed=37)
        kernel = k2d.corner_count2d_gather
    else:
        ci = np.random.default_rng(37).integers(0, N2, 20_000)
        ranges = (px[ci], py[ci])
        kernel = k2d.corner_eval2d_gather
    counts = lambda: (kernel.launches, kloc.locate.launches)
    before = counts()
    got = Engine().query(plan, *ranges, eps_rel=eps_rel)
    torch.cuda.synchronize()
    k1 = 0 if eps_rel is None else (2 if agg == "count2d" else 1)
    assert counts() == (before[0] + 1, before[1] + k1)
    before = counts()
    want = Engine(backend="torch").query(plan, *ranges, eps_rel=eps_rel)
    assert counts() == before
    torch.testing.assert_close(got.answer, want.answer, **TOL)
    torch.testing.assert_close(got.refined, want.refined, rtol=0, atol=0)


@pytest.mark.parametrize("agg", ["count2d", "min2d"])
def test_deep_plan_runs_scan_kernels(cuda, agg):
    """A plan deeper than 15 levels has no Morton codes: the 'cuda'
    backend runs K12 / K13 and never K7 / K8."""
    # a dominance staircase whose steps pass 2 delta along the data's
    # lower-left frontier splits to depth 16 all along it: delta 10 here
    rng = np.random.default_rng(41)
    px, py = rng.uniform(0, 120, N2), rng.uniform(0, 120, N2)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    idx = build_index_2d(px, py, measures=None if agg == "count2d" else w,
                         agg=agg, deg=2,
                         delta=5.0 if agg == "count2d" else 10.0,
                         max_depth=16, device=cuda)
    plan = build_plan_2d(idx)
    assert plan.leaf_z is None and plan.max_depth == 16
    if agg == "count2d":
        ranges = make_queries_2d(px, py, 10_000, seed=43)
    else:
        ci = np.random.default_rng(43).integers(0, N2, 10_000)
        ranges = (px[ci], py[ci])
    launches = lambda: (k2d.corner_count2d_gather.launches,
                        k2d.corner_eval2d_gather.launches,
                        k2d.corner_count2d.launches,
                        k2d.corner_eval2d.launches)
    before = launches()
    got = Engine().query(plan, *ranges)
    torch.cuda.synchronize()
    scan = (1, 0) if agg == "count2d" else (0, 1)
    assert launches() == (before[0], before[1], before[2] + scan[0],
                          before[3] + scan[1])
    want = Engine(backend="torch").query(plan, *ranges)
    torch.testing.assert_close(got.answer, want.answer, **TOL)


# ---------------------------------------------------------------------------
# dynamic 2-D: K9, K10, K11 (merge-sort-tree corrections over point logs)
# ---------------------------------------------------------------------------

def _log2d(cuda, fill):
    """A weighted x-sorted point log of ``fill`` entries in CAP slots (ties
    on both axes) with its merge-sort-tree levels, built by the engine's
    append on the card; and the points."""
    rng = np.random.default_rng(fill + 1)
    x = np.round(rng.uniform(0, 100, fill), 1)
    y = np.round(rng.uniform(0, 100, fill), 1)
    w = rng.normal(50, 10, fill)
    e = DeltaBuffer2D.empty(CAP, device=cuda, weighted=True)
    to = lambda a: torch.as_tensor(a, device=cuda)
    log = _append_2d(e.ins_x, e.ins_y, e.ins_w, to(x), to(y), to(w), cap=CAP,
                     levels=True, weighted=True)
    return log, (x, y)


def _rects2d(cuda, pts, n=70_000, special=False):
    """Rectangles with corners on the points' own coordinates, random ones,
    one left of and one right of the log, one around all of it and one
    inverted; with ``special`` also NaN, +-inf and signed-zero lanes."""
    x, y = pts
    rng = np.random.default_rng(53)
    a, b, c, d = rng.uniform(-10, 110, (4, n))
    if len(x):
        k = rng.integers(0, len(x), n // 2)
        a[:n // 2], c[:n // 2] = x[k], y[k]
        b[:n // 2], d[:n // 2] = x[k[::-1]], y[k[::-1]]
    lx = np.concatenate([np.minimum(a, b), [-1e9, 200.0, -1e300, 60.0]])
    ux = np.concatenate([np.maximum(a, b), [-5.0, 1e9, 1e300, 40.0]])
    ly = np.concatenate([np.minimum(c, d), [-1e9, -1e9, -1e300, 0.0]])
    uy = np.concatenate([np.maximum(c, d), [1e9, 1e9, 1e300, 100.0]])
    if special:
        inf, nan = np.inf, np.nan
        extra = np.array([  # lx, ux, ly, uy
            [nan, 50.0, 0.0, 50.0], [0.0, nan, 0.0, 50.0],
            [0.0, 50.0, nan, 50.0], [0.0, 50.0, 0.0, nan],
            [-inf, inf, -inf, inf], [-inf, 50.0, -inf, 50.0],
            [20.0, inf, 20.0, inf], [inf, -inf, inf, -inf],
            [-0.0, 0.0, -0.0, 0.0], [1e308, inf, 1e308, inf]])
        lx, ux, ly, uy = (np.concatenate([q, extra[:, j]])
                          for j, q in enumerate((lx, ux, ly, uy)))
    return tuple(torch.as_tensor(q, device=cuda) for q in (lx, ux, ly, uy))


@pytest.mark.parametrize("fill", [0, 1, 2, CAP - 1025, CAP])
def test_delta_2d_kernels_match_plain(cuda, fill):
    """K9, K10 and K11 equal their plain versions in every lane, bit for
    bit, on an empty, a one- and a two-entry, a 3,071-entry and a full
    log."""
    (x, _, _, ylv, wcum, wpmax), pts = _log2d(cuda, fill)
    lx, ux, ly, uy = _rects2d(cuda, pts)
    launches = lambda: (kdelta.delta_count2d_gather.launches,
                        kdelta.delta_sum2d_gather.launches,
                        kdelta.delta_dommax2d_gather.launches)
    before = launches()
    k9 = kdelta.delta_count2d_gather(lx, ux, ly, uy, x, ylv)
    k10 = kdelta.delta_sum2d_gather(lx, ux, ly, uy, x, ylv, wcum)
    k11 = kdelta.delta_dommax2d_gather(ux, uy, x, ylv, wpmax)
    torch.cuda.synchronize()
    assert launches() == tuple(b + 1 for b in before)
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(k9, kdelta.delta_count2d_gather_plain(
        lx, ux, ly, uy, x, ylv), **exact)
    torch.testing.assert_close(k10, kdelta.delta_sum2d_gather_plain(
        lx, ux, ly, uy, x, ylv, wcum), **exact)
    torch.testing.assert_close(k11, kdelta.delta_dommax2d_gather_plain(
        ux, uy, x, ylv, wpmax), **exact)
    if fill == 0:
        assert not k9.any() and not k10.any()
        assert torch.isneginf(k11).all()
    else:
        assert float(k9[-2]) == fill   # the rectangle around every point
        assert not k9[-4:-2].any()


@pytest.mark.parametrize("nq", [1, 255, 65_537])
@pytest.mark.parametrize("fill", [2, CAP - 1025, CAP])
def test_delta_2d_kernels_ragged_and_special_lanes(cuda, fill, nq):
    """K9 and K10 (two threads a query, a shuffle between them) and K11
    (the set-bits walk in max mode) on ragged query counts, NaN, +-inf and
    signed-zero lanes (x-rank == cap where a corner passes every key of the
    full log) equal their plain versions bit for bit (K11 NaN as NaN), one
    launch each a call, and a second launch equals the first."""
    (x, _, _, ylv, wcum, wpmax), pts = _log2d(cuda, fill)
    rects = _rects2d(cuda, pts, special=True)
    lx, ux, ly, uy = (torch.cat([q[:max(nq - 10, 1)], q[-10:]])[:nq]
                      for q in rects)
    bits = lambda t: t.view(torch.int64)
    launches = lambda: (kdelta.delta_count2d_gather.launches,
                        kdelta.delta_sum2d_gather.launches,
                        kdelta.delta_dommax2d_gather.launches)
    before = launches()
    k9 = kdelta.delta_count2d_gather(lx, ux, ly, uy, x, ylv)
    k10 = kdelta.delta_sum2d_gather(lx, ux, ly, uy, x, ylv, wcum)
    k11 = kdelta.delta_dommax2d_gather(ux, uy, x, ylv, wpmax)
    k11_low = kdelta.delta_dommax2d_gather(lx, ly, x, ylv, wpmax)
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1] + 1, before[2] + 2)
    assert torch.equal(bits(k9), bits(kdelta.delta_count2d_gather_plain(
        lx, ux, ly, uy, x, ylv)))
    assert torch.equal(bits(k10), bits(kdelta.delta_sum2d_gather_plain(
        lx, ux, ly, uy, x, ylv, wcum)))
    _same(k11, kdelta.delta_dommax2d_gather_plain(ux, uy, x, ylv, wpmax))
    _same(k11_low, kdelta.delta_dommax2d_gather_plain(lx, ly, x, ylv,
                                                      wpmax))
    assert torch.equal(bits(k9), bits(kdelta.delta_count2d_gather(
        lx, ux, ly, uy, x, ylv)))
    assert torch.equal(bits(k10), bits(kdelta.delta_sum2d_gather(
        lx, ux, ly, uy, x, ylv, wcum)))
    assert torch.equal(bits(k11), bits(kdelta.delta_dommax2d_gather(
        ux, uy, x, ylv, wpmax)))
    if nq > 10:   # (-inf, inf]^2: x-rank cap, every slot counted
        assert float(k9[-6]) == CAP


def test_delta_2d_kernels_reject_bad_arguments(cuda):
    (x, _, _, ylv, wcum, wpmax), pts = _log2d(cuda, 10)
    lx, ux, ly, uy = _rects2d(cuda, pts, n=100)
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_count2d_gather(lx, ux, ly, uy, x, ylv[:5])
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_sum2d_gather(lx, ux[:50], ly, uy, x, ylv, wcum)
    with pytest.raises(ValueError, match="CUDA device"):
        kdelta.delta_dommax2d_gather(ux, uy.cpu(), x, ylv, wpmax)
    with pytest.raises(ValueError, match="float64"):
        kdelta.delta_dommax2d_gather(ux, uy, x, ylv, wpmax.float())


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "min2d"])
def test_dynamic2d_cuda_backend_matches_torch_backend(cuda, agg):
    """DynamicEngine2D on the card: the default 'cuda' backend runs K9
    (COUNT, both logs) or K10 (SUM) beside K7, or K11 (dominance, the
    insert log) beside K8, K1 in the Q_rel truth and the victim path, and
    agrees with the 'torch' backend (dense oracles, quadtree descent)
    through inserts, deletes, a flush and more updates, refined flags
    included; both merges refit alike."""
    px, py = osm_points(N2, seed=47)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    delta = {"count2d": 20.0, "sum2d": 400.0, "min2d": 10.0}[agg]
    idx = build_index_2d(px, py, measures=None if agg == "count2d" else w,
                         agg=agg, deg=2, delta=delta, max_depth=6,
                         device=cuda)
    dev = DynamicEngine2D(idx, capacity=256, auto_refit=False)
    host = DynamicEngine2D(idx, backend="torch", capacity=256,
                           auto_refit=False)
    assert dev.backend == "cuda"
    rng = np.random.default_rng(59)
    dominance = agg == "min2d"
    if dominance:
        ci = rng.integers(0, N2, 20_000)
        ranges = (px[ci], py[ci])
        delta_k, raw_k = kdelta.delta_dommax2d_gather, k2d.corner_eval2d_gather
    else:
        ranges = make_queries_2d(px, py, 20_000, seed=61)
        delta_k = (kdelta.delta_count2d_gather if agg == "count2d"
                   else kdelta.delta_sum2d_gather)
        raw_k = k2d.corner_count2d_gather
    counts = lambda: (delta_k.launches, raw_k.launches, kloc.locate.launches)
    gone = rng.choice(N2, 24, replace=False)
    x0, x1 = px.min(), px.max()
    y0, y1 = py.min(), py.max()

    def update(step):
        ins = (rng.uniform(x0, x1, 40), rng.uniform(y0, y1, 40),
               rng.uniform(40, 60, 40))
        out = gone[12 * step:12 * (step + 1)]
        for dyn in (dev, host):
            dyn.insert(*(ins[:2] if agg == "count2d" else ins))
            dyn.delete(px[out], py[out])

    def compare():
        victims = dominance and dev.snapshot()[1].vic_x is not None
        for eps_rel in (None, 0.05):
            before = counts()
            got = dev.query(*ranges, eps_rel=eps_rel)
            torch.cuda.synchronize()
            if dominance:
                k1 = 1 if (victims or eps_rel is not None) else 0
                want_counts = (before[0] + 1, before[1] + 1, before[2] + k1)
            else:
                k1 = 2 if eps_rel is not None else 0
                want_counts = (before[0] + 2, before[1] + 1, before[2] + k1)
            assert counts() == want_counts
            before = counts()
            want = host.query(*ranges, eps_rel=eps_rel)
            assert counts() == before
            torch.testing.assert_close(got.answer, want.answer, **TOL)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)

    update(0)
    compare()
    dev.flush()
    host.flush()
    assert dev.refit_count == host.refit_count == 1
    assert dev.last_refit_stats == host.last_refit_stats
    torch.testing.assert_close(dev.index.coeffs.cpu(), host.index.coeffs.cpu(),
                               rtol=0, atol=0)
    compare()
    update(1)
    compare()


# ---------------------------------------------------------------------------
# the 'cuda_scan' backend: K14-K17 and K4's scan mode
# ---------------------------------------------------------------------------

def _k14_edge_lanes(seg_lo, seg_next):
    """The edge lanes of a segment table: NaN, +-inf, at and above the
    sentinel, below the table and its low end, then every start, just below
    every next start, and the same keys paired the other way round (some
    ranges inverted)."""
    big = big_sentinel(seg_lo.dtype)
    h = int((seg_lo < big).sum())
    lo, nx = seg_lo[:h].cpu().numpy(), seg_next[:h].cpu().numpy()
    dt = lo.dtype
    up = np.nextafter(np.array(big, dtype=dt), np.array(np.inf, dtype=dt))
    special = np.array([np.nan, np.inf, -np.inf, big, up, lo[0] - 1.0,
                        lo[0]], dtype=dt)
    a = np.concatenate([special, lo,
                        np.nextafter(nx, np.array(-np.inf, dtype=dt))])
    b = np.random.default_rng(h).permutation(a)
    to = lambda v: torch.as_tensor(v, device=seg_lo.device)
    return (to(np.concatenate([a, special[::-1], a])),
            to(np.concatenate([b, special, a[::-1]])))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("Q", [1, 255, None], ids=["1", "255", "all"])
@pytest.mark.parametrize("deg", [1, 2, 3])
def test_range_sum_scan_kernel_matches_plain(plans, queries, ops_tables, deg,
                                             Q, dt):
    """K14 (the count walk over seg_lo up to the sentinel tail, boundary
    rows, Horner) equals its plain version in every lane, NaN equal, and K2
    in every lane where the two plain versions agree, which is every range
    clamped into the domain (it reads the very rows K2 locates); on the
    engine's SUM plans at float64 and ``ops`` SUM tables at float32, at 1,
    255 and 70,000 and more ranges, the edge lanes first (NaN, +-inf, at
    and above the sentinel, below the table, every start, just below every
    next start, inverted ranges); one launch a call."""
    if dt == torch.float64:
        p, (lq, uq) = plans[1]["sum", deg], queries
    else:
        keys, _, tabs = ops_tables
        p = tabs["sum", deg, dt]
        lq, uq = _ops_queries(p.seg_lo.device, keys, dt)
    el, eu = _k14_edge_lanes(p.seg_lo, p.seg_next)
    edge = el.shape[0]
    lq, uq = (torch.cat([e, q])[:Q] for e, q in ((el, lq), (eu, uq)))
    table = (p.seg_lo, p.seg_next, p.seg_hi, p.coeffs)
    before = ksum.range_sum.launches
    got = ksum.range_sum(lq, uq, *table)
    torch.cuda.synchronize()
    assert ksum.range_sum.launches == before + 1
    assert got.shape == lq.shape and got.dtype == dt
    want = ksum.range_sum_plain(lq, uq, *table)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    k2 = ksum.range_sum_gather(lq, uq, p.seg_lo, p.seg_hi, p.coeffs)
    k2_plain = ksum.range_sum_gather_plain(lq, uq, p.seg_lo, p.seg_hi,
                                           p.coeffs)
    agree = (want == k2_plain) | (torch.isnan(want) & torch.isnan(k2_plain))
    assert agree[edge:].all()
    torch.testing.assert_close(got[agree], k2[agree], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("agg,deg", [("max", 1), ("max", 2), ("max", 3),
                                     ("min", 3)])
def test_range_max_scan_kernel_matches_plain(plans, queries, agg, deg):
    """K15 equals its plain version and K3 in every lane."""
    p = plans[1][agg, deg]
    args = (*queries, p.seg_lo, p.seg_next, p.seg_hi, p.coeffs, p.seg_agg)
    before = kmax.range_max.launches
    got = kmax.range_max(*args)
    torch.cuda.synchronize()
    assert kmax.range_max.launches == before + 1
    torch.testing.assert_close(got, kmax.range_max_plain(*args), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, kmax.range_max_gather(
        *queries, p.seg_lo, p.seg_hi, p.coeffs, p.st), rtol=0, atol=0)


@pytest.mark.parametrize("fill", [0, 1, 37, 255, 256, 257, 1023, 1024, 1025,
                                  2049, CAP])
def test_delta_scan_kernels_match_plain(cuda, fill):
    """K16 and K17 against their plain versions and their gather twins K5
    and K6 on one log: K17 exactly; K16 exactly on a COUNT log (unit
    measures: every order of summation is exact) and, on a SUM log, within
    1e-12 x sum |v| of the lane, since the plain one-hot product may add
    the members in another order than the kernel's slot order.  The fills
    sit on both sides of K16's 1,024-slot tiles (where it stops at the
    sentinel) and of the 256-entry tiles of the other scans."""
    keys, vals, cf, st = _log(cuda, fill, True)
    lq, uq = _delta_queries(cuda)
    ok = lq <= uq
    before = (kdelta.delta_sum.launches, kdelta.delta_max.launches)
    got_sum = kdelta.delta_sum(lq, uq, keys, vals)
    got_max = kdelta.delta_max(lq, uq, keys, vals)
    torch.cuda.synchronize()
    assert (kdelta.delta_sum.launches,
            kdelta.delta_max.launches) == (before[0] + 1, before[1] + 1)
    scale = float(vals.abs().sum())
    assert float((got_sum - kdelta.delta_sum_plain(lq, uq, keys, vals))
                 .abs().max()) <= 1e-12 * scale
    torch.testing.assert_close(got_sum[ok], kdelta.delta_sum_gather(
        lq, uq, keys, cf)[ok], **TOL)
    torch.testing.assert_close(got_max, kdelta.delta_max_plain(
        lq, uq, keys, vals), rtol=0, atol=0)
    torch.testing.assert_close(got_max, kdelta.delta_max_gather(
        lq, uq, keys, st), rtol=0, atol=0)
    ones = (keys < big_sentinel(torch.float64) / 2).to(torch.float64)
    ccf = torch.cat([ones.new_zeros(1), torch.cumsum(ones, 0)])
    got = kdelta.delta_sum(lq, uq, keys, ones)
    torch.testing.assert_close(got, kdelta.delta_sum_plain(lq, uq, keys,
                                                           ones),
                               rtol=0, atol=0)
    torch.testing.assert_close(got[ok], kdelta.delta_sum_gather(
        lq, uq, keys, ccf)[ok], rtol=0, atol=0)
    assert not got[~ok].any()
    if fill == 0:
        assert not got_sum.any() and torch.isneginf(got_max).all()


@pytest.mark.parametrize("with_nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("fill", [0, 1, 37, 255, 256, 257, 1023, 1024, 1025,
                                  2048, 2049, CAP])
def test_delta_max_kernel_tail_lanes(cuda, fill, with_nan):
    """K17 equals its plain version in value (NaN equal, either zero) on
    all-negative measures, with and without a NaN measure in the log, on
    the lanes that reach the sentinel tail (whose 0 K17 folds back in
    where it skipped tiles) and on NaN bounds; one launch a call, and two
    launches give the same bits."""
    keys, vals, _, _ = _log(cuda, fill, False)
    vals = -vals.abs() - 1.0
    vals = torch.where(keys < big_sentinel(torch.float64), vals, 0.0)
    if with_nan and fill:
        vals[fill // 2] = float("nan")
    lq, uq = _delta_queries(cuda, tail=True)
    before = kdelta.delta_max.launches
    got = kdelta.delta_max(lq, uq, keys, vals)
    again = kdelta.delta_max(lq, uq, keys, vals)
    torch.cuda.synchronize()
    assert kdelta.delta_max.launches == before + 2
    torch.testing.assert_close(got, kdelta.delta_max_plain(lq, uq, keys,
                                                           vals),
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    if fill < CAP:   # a range over the sentinel holds the tail's 0
        assert (got[-6:-3] == 0).all()


@pytest.mark.parametrize("Q", [1, 255, 70_001])
@pytest.mark.parametrize("with_nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("fill", [0, 1, 37, 1024, 3072, CAP])
def test_delta_max_gather_kernel_tail_lanes(cuda, fill, with_nan, Q):
    """K6 (two threads a query, the sparse-table step split over the pair)
    equals its plain version bit for bit, NaN as NaN, on an all-sentinel,
    partly filled and full log, with and without a NaN measure, on the
    lanes that reach the sentinel tail or hold a NaN bound, empty and
    inverted spans, at odd query counts (the last pair partly past Q); one
    launch a call, and two launches give the same bits."""
    rng = np.random.default_rng(fill + 3)
    big = big_sentinel(torch.float64)
    k = np.round(rng.uniform(0, 1000, fill), 1)
    v = rng.normal(0, 50, fill)
    if with_nan and fill:
        v[rng.integers(0, fill, 1 + fill // 100)] = np.nan
    keys, _, _, st = _append_1d(
        torch.full((CAP,), big, dtype=torch.float64, device=cuda),
        torch.zeros(CAP, dtype=torch.float64, device=cuda),
        torch.as_tensor(k, device=cuda), torch.as_tensor(v, device=cuda),
        cap=CAP, with_st=True)
    lq, uq = (q[-Q:] for q in _delta_queries(cuda, tail=True))
    before = kdelta.delta_max_gather.launches
    got = kdelta.delta_max_gather(lq, uq, keys, st)
    again = kdelta.delta_max_gather(lq, uq, keys, st)
    torch.cuda.synchronize()
    assert kdelta.delta_max_gather.launches == before + 2
    assert got.shape == (Q,)
    torch.testing.assert_close(
        got, kdelta.delta_max_gather_plain(lq, uq, keys, st), rtol=0, atol=0,
        equal_nan=True)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))


def test_delta_sum_kernel_on_a_window_log(cuda):
    """K16 on the window's layout: 4,096 live slots of 131,072 (it walks
    the live tiles only), exactly its plain version on unit measures and
    within 1e-12 x sum |v| on a SUM log."""
    keys, vals, _, _ = _log(cuda, CAP, False, cap=32 * CAP)
    lq, uq = _delta_queries(cuda)
    ones = (keys < big_sentinel(torch.float64) / 2).to(torch.float64)
    got = kdelta.delta_sum(lq, uq, keys, ones)
    torch.testing.assert_close(got, kdelta.delta_sum_plain(lq, uq, keys,
                                                           ones),
                               rtol=0, atol=0)
    assert got.max() > 0
    got = kdelta.delta_sum(lq, uq, keys, vals)
    scale = float(vals.abs().sum())
    assert float((got - kdelta.delta_sum_plain(lq, uq, keys, vals))
                 .abs().max()) <= 1e-12 * scale


def test_scan_kernels_repeat_bit_for_bit(cuda, quantile_plans):
    """Two launches of K16, K17, of K4's scan mode, of K15, of K12, of K13
    and of K19 on the same inputs give the same bits (no atomics on the
    answers; a fixed order of summation, exact counts, maxima and lowest
    indices across chunks; K19's shared-memory buckets move a rectangle
    between threads, never its order of summation)."""
    keys, vals, _, _ = _log(cuda, 3000, False)
    lq, uq = _delta_queries(cuda)
    assert torch.equal(kdelta.delta_sum(lq, uq, keys, vals),
                       kdelta.delta_sum(lq, uq, keys, vals))
    assert torch.equal(kdelta.delta_max(lq, uq, keys, vals),
                       kdelta.delta_max(lq, uq, keys, vals))
    args, kw = _k4_args(quantile_plans["sum", 3], _fractions(cuda))
    for a, b in zip(kq.quantile_invert(*args, scan=True, **kw),
                    kq.quantile_invert(*args, scan=True, **kw)):
        assert torch.equal(a, b)
    bits = lambda t: t.view(torch.int64)
    table = _segment_table(cuda, 2337, 2560, torch.float64)
    args = (*_segment_queries(table, 65_537), *table)
    assert torch.equal(bits(kmax.range_max(*args)),
                       bits(kmax.range_max(*args)))
    leaves = _grid_leaves(cuda, 50, 49, 2560)
    args = (*_grid_corners(leaves, 65_537), *leaves[1:], 3)
    assert torch.equal(bits(k2d.corner_count2d(*args)),
                       bits(k2d.corner_count2d(*args)))
    args = (*_grid_corners(leaves, 65_537)[1::2], *leaves[1:], 3)
    assert torch.equal(bits(k2d.corner_eval2d(*args)),
                       bits(k2d.corner_eval2d(*args)))
    kx, ky, w = _k19_log(cuda, 3072, "insert")
    q = _k19_rects(kx, 65_537)
    assert torch.equal(bits(kdelta.delta_sum2d(*q, kx, ky, w)),
                       bits(kdelta.delta_sum2d(*q, kx, ky, w)))


# the segment tables and leaf tables of the ragged-shape tests: (live
# entries, slots) from one tile to several chunks of the scans' tiles, and
# the smoke's shapes (hki_dyn's 2,337 segments in 2,560, osm's 2,450-leaf
# grid in 2,560)
SEGMENT_SHAPES = [(1, 512), (200, 256), (257, 257), (300, 512), (700, 1024),
                  (1100, 1536), (2337, 2560)]
LEAF_GRIDS = [(1, 1, 512), (16, 16, 256), (257, 1, 257), (16, 32, 512),
              (32, 32, 1024), (24, 45, 1536), (50, 49, 2560)]


def _segment_table(cuda, live, n, dt, seed=0):
    """A segment table in a plan's layout (engine.plan.build_plan) with
    ``live`` segments in ``n`` slots at type ``dt``: starts sorted from 0
    with one segment that holds nothing (two equal starts), seg_next the
    next start and the sentinel last, cubic rows, the aggregates -inf on
    the sentinel tail.  (seg_lo, seg_next, seg_hi, coeffs, seg_agg)."""
    rng = np.random.default_rng(seed + live)
    big = big_sentinel(dt)
    lo = np.sort(rng.uniform(0, 1000, live))
    lo[0] = 0.0
    if live > 8:
        lo[4] = lo[5]
    lo = torch.as_tensor(lo, dtype=dt)
    nx = torch.cat([lo[1:], torch.tensor([big], dtype=dt)])
    hi = torch.cat([lo[:-1] + 0.9 * (lo[1:] - lo[:-1]),
                    torch.tensor([1000.0], dtype=dt)])
    cf = torch.as_tensor(rng.normal(0, 1, (live, 4)), dtype=dt)
    agg = torch.as_tensor(rng.normal(0, 10, live), dtype=dt)
    pad = lambda t, v: torch.cat([t, t.new_full((n - live, *t.shape[1:]),
                                                v)]).to(cuda)
    return (pad(lo, big), pad(nx, big), pad(hi, big), pad(cf, 0.0),
            pad(agg, -np.inf))


def _segment_queries(table, Q):
    """Q ranges over a segment table, its boundary lanes first: NaN lq, uq
    and both, the domain's low end, an inverted range, every start as lq
    and as uq, just below every next start; then ranges from [-5, 1005]
    clamped to the domain as the engine clamps them."""
    lo, nx = table[0], table[1]
    live = int((lo < big_sentinel(lo.dtype)).sum())
    s, nxt = lo[:live].cpu().numpy(), nx[:live].cpu().numpy()
    below = np.nextafter(nxt, np.array(-np.inf, dtype=nxt.dtype))
    rng = np.random.default_rng(Q)
    a, b = rng.uniform(-5, 1005, (2, Q))
    lq = np.concatenate([[0.0] * 5, s, s[::-1], below, np.minimum(a, b)])
    uq = np.concatenate([[0.0] * 5, np.roll(s, -3), s, below,
                         np.maximum(a, b)])
    lq, uq = np.minimum(lq, uq)[:Q], np.maximum(lq, uq)[:Q]
    lq[:5] = [np.nan, 0.0, np.nan, 0.0, 700.0][:Q]
    uq[:5] = [500.0, np.nan, np.nan, 0.0, 300.0][:Q]
    return tuple(torch.clamp(torch.as_tensor(q, dtype=lo.dtype,
                                             device=lo.device), min=0.0)
                 for q in (lq, uq))


def _grid_leaves(cuda, gx, gy, n, seed=0):
    """A flat leaf table in a plan's layout (engine.plan.build_plan_2d):
    a gx x gy grid of cells over [0, 100]^2 with uneven cuts, in a random
    order, the cells on the root's top and right edges open to the
    sentinel, padded to n slots with the sentinel; cubic surfaces.  (cuts,
    mx0, mx1, my0, my1, bounds, coeffs)."""
    rng = np.random.default_rng(seed + gx * gy)
    big = big_sentinel(torch.float64)
    xs = np.concatenate([[0.0], np.sort(rng.uniform(0, 100, gx - 1)), [100.0]])
    ys = np.concatenate([[0.0], np.sort(rng.uniform(0, 100, gy - 1)), [100.0]])
    ix, iy = (a.ravel() for a in np.meshgrid(np.arange(gx), np.arange(gy),
                                             indexing="ij"))
    perm = rng.permutation(gx * gy)
    ix, iy = ix[perm], iy[perm]
    b = np.stack([xs[ix], xs[ix + 1], ys[iy], ys[iy + 1]], axis=1)
    pad = lambda a, v: torch.as_tensor(np.concatenate(
        [a, np.full((n - len(a), *a.shape[1:]), v)]), device=cuda)
    return ((xs, ys), pad(b[:, 0], big),
            pad(np.where(b[:, 1] >= 100.0, big, b[:, 1]), big),
            pad(b[:, 2], big), pad(np.where(b[:, 3] >= 100.0, big, b[:, 3]),
                                   big),
            pad(b, 0.0), pad(rng.normal(0, 1, (gx * gy, 16)), 0.0))


def _grid_corners(leaves, Q):
    """Q rectangles over a grid's root, corners on its split lines and on
    the root's edges first, clamped into the root as the engine clamps
    them."""
    xs, ys = leaves[0]
    k = max(len(xs), len(ys))
    xs, ys = np.resize(xs, k), np.resize(ys, k)
    rng = np.random.default_rng(Q)
    a, b, c, d = rng.uniform(-5, 105, (4, Q))
    x0 = np.concatenate([xs, rng.permutation(xs), a])
    x1 = np.concatenate([rng.permutation(xs), xs, b])
    y0 = np.concatenate([rng.permutation(ys), ys, c])
    y1 = np.concatenate([ys, rng.permutation(ys), d])
    x0, x1, y0, y1 = (np.clip(q[:Q], 0.0, 100.0) for q in (x0, x1, y0, y1))
    return tuple(torch.as_tensor(q, device=leaves[1].device) for q in
                 (np.minimum(x0, x1), np.maximum(x0, x1), np.minimum(y0, y1),
                  np.maximum(y0, y1)))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("live,n", SEGMENT_SHAPES)
def test_range_max_scan_kernel_ragged_shapes(cuda, live, n, Q, dt):
    """K15 equals its plain version in every lane at ragged query counts
    and table lengths (one tile, one tile and one slot, one to four chunks
    of tiles, a sentinel tail that starts mid-tile), on NaN lanes, an
    inverted range, every segment start and just below every next start,
    at float64 and float32; one launch a call."""
    table = _segment_table(cuda, live, n, dt)
    args = (*_segment_queries(table, Q), *table)
    before = kmax.range_max.launches
    got = kmax.range_max(*args)
    torch.cuda.synchronize()
    assert kmax.range_max.launches == before + 1
    assert got.shape == (Q,) and got.dtype == dt
    torch.testing.assert_close(got, kmax.range_max_plain(*args), rtol=0,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("gx,gy,n", LEAF_GRIDS)
def test_corner_count2d_kernel_ragged_shapes(cuda, gx, gy, n, Q):
    """K12 equals its plain version in every lane at ragged query counts
    and leaf-table lengths (one leaf, one tile, one tile and one slot, one
    to four chunks of tiles), corners on split lines and the root's edges
    included; one launch a call."""
    leaves = _grid_leaves(cuda, gx, gy, n)
    args = (*_grid_corners(leaves, Q), *leaves[1:], 3)
    before = k2d.corner_count2d.launches
    got = k2d.corner_count2d(*args)
    torch.cuda.synchronize()
    assert k2d.corner_count2d.launches == before + 1
    assert got.shape == (Q,)
    torch.testing.assert_close(got, k2d.corner_count2d_plain(*args), rtol=0,
                               atol=0)


# K13's tables: LEAF_GRIDS and one 128-leaf tile, a tile and a slot
K13_GRIDS = LEAF_GRIDS + [(8, 16, 128), (129, 1, 129)]


def _same(got, want):
    """Equal in every lane, the sign of a zero included; NaN where the
    other is NaN (a NaN's sign and payload may differ: torch's add and the
    kernel's need not propagate the same one of two NaN operands)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(torch.signbit(got[~torch.isnan(got)]),
                       torch.signbit(want[~torch.isnan(want)]))


def _special_corners(u, v):
    """The corners past the root and NaN ones appended to (u, v)."""
    inf, nan = np.inf, np.nan
    su = torch.tensor([nan, 0.0, nan, inf, -inf, 100.0, inf, 0.0],
                      dtype=u.dtype, device=u.device)
    sv = torch.tensor([0.0, nan, nan, 0.0, 100.0, -inf, inf, 100.0],
                      dtype=v.dtype, device=v.device)
    return torch.cat([u, su]), torch.cat([v, sv])


@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("gx,gy,n", K13_GRIDS)
def test_corner_eval2d_kernel_ragged_shapes(cuda, gx, gy, n, Q):
    """K13 equals its plain version in every lane (NaN where it is NaN) at
    ragged corner counts and leaf-table lengths (one leaf, one tile, a tile
    and a slot, one to four chunks of tiles), corners on split lines and
    the root's edges, past the root and NaN; one launch a call."""
    leaves = _grid_leaves(cuda, gx, gy, n)
    _, ux, _, uy = _grid_corners(leaves, Q)
    u, v = _special_corners(ux, uy)
    args = (u[-Q:], v[-Q:], *leaves[1:], 3)
    before = k2d.corner_eval2d.launches
    got = k2d.corner_eval2d(*args)
    torch.cuda.synchronize()
    assert k2d.corner_eval2d.launches == before + 1
    assert got.shape == (Q,)
    _same(got, k2d.corner_eval2d_plain(*args))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5])
def test_corner_eval2d_kernel_every_degree(cuda, deg):
    """K13 at every degree 0-5 (one finish instantiation each) equals its
    plain version in every lane, the special corners included."""
    leaves = _grid_leaves(cuda, 24, 45, 1536)
    k = (deg + 1) ** 2
    coeffs = torch.as_tensor(np.random.default_rng(deg).normal(
        0, 1, (1536, k)), device=cuda)
    _, ux, _, uy = _grid_corners(leaves, 20_000)
    args = (*_special_corners(ux, uy), *leaves[1:5], leaves[5],
            coeffs, deg)
    _same(k2d.corner_eval2d(*args), k2d.corner_eval2d_plain(*args))


def test_corner_eval2d_kernel_refuses_misaligned_rows(cuda):
    """K13 reads the rows by 16-byte loads: it refuses bounds or
    coefficients that do not start on a 16-byte boundary (an offset
    view), and equals its plain version on a copy of them."""
    leaves = _grid_leaves(cuda, 16, 16, 256)
    _, ux, _, uy = _grid_corners(leaves, 1000)
    bounds, coeffs = leaves[5], leaves[6]
    off = lambda t: torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
    for b, c in ((off(bounds), coeffs), (bounds, off(coeffs))):
        with pytest.raises(ValueError, match="16-byte"):
            k2d.corner_eval2d(ux, uy, *leaves[1:5], b, c, 3)
        args = (ux, uy, *leaves[1:5], b.clone(), c.clone(), 3)
        _same(k2d.corner_eval2d(*args), k2d.corner_eval2d_plain(*args))


def _k19_log(cuda, fill, kind, cap=CAP):
    """An x-sorted ``cap``-slot SUM log of ``fill`` points built by the
    engine's append on the card (tests/test_torch_scan2d.py's _k19_log): an
    insert log in one append, a delete log in two, measures with -0.0, NaN
    and +-inf; 'nan_tail' puts a NaN x after the sentinel tail, 'full_nan'
    and 'full_inf' end a full log on a NaN or an infinite x."""
    rng = np.random.default_rng(fill + 3)
    x = np.round(rng.uniform(0, 20, fill), 1)
    y = np.round(rng.uniform(0, 20, fill), 1)
    w = rng.normal(50, 10, fill)
    if fill > 40:
        w[[3, 17, 29, 31]] = (-0.0, np.nan, np.inf, -np.inf)
        w[5:40:7] = -w[5:40:7]
    e = DeltaBuffer2D.empty(cap, device=cuda, weighted=True)
    bx, by, bw = e.ins_x, e.ins_y, e.ins_w
    to = lambda a: torch.as_tensor(a, device=cuda)
    cuts = [0, fill // 2, fill] if kind == "delete" else [0, fill]
    for c0, c1 in zip(cuts, cuts[1:]):
        bx, by, bw, *_ = _append_2d(bx, by, bw, to(x[c0:c1]), to(y[c0:c1]),
                                    to(w[c0:c1]), cap=cap, levels=False,
                                    weighted=True)
    if kind in ("nan_tail", "full_nan", "full_inf"):
        bx, by, bw = bx.clone(), by.clone(), bw.clone()
        bx[-1] = np.inf if kind == "full_inf" else np.nan
        by[-1], bw[-1] = 5.0, 7.0
    return bx, by, bw


def _k19_rects(kx, n):
    """n rectangles over the log, x bounds on logged x values (ties at
    either end), then the edge lanes: NaN bounds, inverted, +-inf, -0.0,
    bounds at and above the sentinel."""
    rng = np.random.default_rng(n)
    big = big_sentinel(torch.float64)
    xs = kx[kx < big].cpu().numpy()
    a, b, c, d = rng.uniform(-2, 22, (4, n))
    if len(xs):
        a[:n // 3] = rng.choice(xs, n // 3)
        b[n // 6:n // 2] = rng.choice(xs, n // 2 - n // 6)
    lx, ux = np.minimum(a, b), np.maximum(a, b)
    ly, uy = np.minimum(c, d), np.maximum(c, d)
    inf, nan = np.inf, np.nan
    extra = np.array([  # lx, ux, ly, uy
        [nan, 10.0, 0.0, 10.0], [0.0, nan, 0.0, 10.0],
        [0.0, 10.0, nan, 10.0], [0.0, 10.0, 0.0, nan], [nan, nan, nan, nan],
        [12.0, 3.0, 0.0, 20.0], [5.0, 5.0, 0.0, 20.0],
        [-inf, inf, -inf, inf], [-inf, 10.0, -inf, 10.0],
        [10.0, inf, 10.0, inf], [inf, inf, -inf, inf],
        [-0.0, 0.0, -0.0, 20.0], [0.0, 20.0, -0.0, 0.0],
        [-1.0, big, -1.0, big], [0.0, 2 * big, 0.0, 2 * big],
        [big, inf, big, inf], [np.nextafter(big, 0), big, 0.0, big],
        [-1e300, 1e300, -1e300, 1e300]])
    return [torch.as_tensor(np.concatenate([q, extra[:, j]])[-n:],
                            device=kx.device)
            for j, q in enumerate((lx, ux, ly, uy))]


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("fill,kind,cap", [
    (0, "insert", CAP), (1, "insert", CAP), (1023, "insert", CAP),
    (1024, "delete", CAP), (1025, "insert", CAP), (3072, "delete", CAP),
    (3072, "nan_tail", CAP), (CAP, "insert", CAP), (CAP, "delete", CAP),
    (CAP, "full_nan", CAP), (CAP, "full_inf", CAP),
    (9000, "delete", 4 * CAP)])
def test_delta_sum2d_kernel_rank_lanes(cuda, fill, kind, cap, agg):
    """K19 (ranks, the sentinel tail cut, buckets, warp unions, the log's
    (y, w) staged 4,096 slots at a time) equals its plain version in every
    lane, signed zeros included, NaN where it is NaN, and K18 (the same
    ranks against chunks of the live log, y staged alone, int32 counts,
    the tail's slots counted without a walk) equals its plain version
    exactly, on insert and delete logs of 0 to 4,096 points and on a
    16,384-slot log of 9,000 (several stages), on logs with a NaN x after
    the tail or at the end of a full log and a full log that ends on +inf,
    on ties at either x end, NaN, inverted, infinite, signed-zero and
    sentinel bounds, and on -0.0, NaN and +-inf measures; one launch a
    call."""
    kx, ky, w = _k19_log(cuda, fill, kind, cap)
    q = _k19_rects(kx, 70_000)
    log = (kx, ky, w) if agg == "sum" else (kx, ky)
    kernel = kdelta.delta_sum2d if agg == "sum" else kdelta.delta_count2d
    plain = getattr(kdelta, kernel.__name__ + "_plain")
    before = kernel.launches
    got = kernel(*q, *log)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _same(got, plain(*q, *log))


@pytest.mark.parametrize("Q", [1, 255, 257, 65_537])
def test_delta_sum2d_kernel_ragged_counts(cuda, Q):
    """K19 at rectangle counts that leave a block part empty (a block holds
    256) equals its plain version in every lane."""
    kx, ky, w = _k19_log(cuda, 3072, "insert")
    q = _k19_rects(kx, Q)
    got = kdelta.delta_sum2d(*q, kx, ky, w)
    assert got.shape == (Q,)
    _same(got, kdelta.delta_sum2d_plain(*q, kx, ky, w))


@pytest.mark.parametrize("Q", [1, 255, 65_537])
def test_quantile_scan_kernel_ragged_counts(cuda, quantile_plans, Q):
    """K4's scan mode at target counts that leave a block part empty (a
    block holds 512 targets) equals its plain version and the gather mode
    in every lane."""
    rng = np.random.default_rng(Q)
    q = torch.as_tensor(rng.uniform(0, 1, Q), device=cuda)
    args, kw = _k4_args(quantile_plans["count", 2], q)
    got = kq.quantile_invert(*args, scan=True, **kw)
    want = kq.quantile_invert_plain(*args, scan=True, **kw)
    gather = kq.quantile_invert(*args, **kw)
    for g, w, a in zip(got, want, gather):
        assert g.shape == (Q,)
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(g, a, rtol=0, atol=0)


@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("deg", [1, 2, 3, 4, 5])
def test_quantile_scan_kernel_matches_plain(cuda, quantile_plans, agg, deg):
    """K4's scan mode equals its plain version (``scan=True``) and the
    gather mode in every lane, and is counted apart."""
    args, kw = _k4_args(quantile_plans[agg, deg], _fractions(cuda))
    before = (kq.quantile_invert.launches, kq.quantile_invert.scan_launches)
    got = kq.quantile_invert(*args, scan=True, **kw)
    torch.cuda.synchronize()
    assert (kq.quantile_invert.launches,
            kq.quantile_invert.scan_launches) == (before[0], before[1] + 1)
    want = kq.quantile_invert_plain(*args, scan=True, **kw)
    gather = kq.quantile_invert(*args, **kw)
    for g, w, a in zip(got, want, gather):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(g, a, rtol=0, atol=0)


def test_scan_kernels_reject_bad_arguments(cuda, plans, queries):
    p = plans[1]["max", 3]
    lq, uq = queries
    with pytest.raises(ValueError, match="shape mismatch"):
        ksum.range_sum(lq, uq, p.seg_lo, p.seg_next[:-1], p.seg_hi, p.coeffs)
    with pytest.raises(ValueError, match="CUDA device"):
        kmax.range_max(lq, uq, p.seg_lo, p.seg_next, p.seg_hi, p.coeffs,
                       p.seg_agg.cpu())
    keys, vals, _, _ = _log(cuda, 10, False)
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_sum(lq, uq[:-1], keys, vals)
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_max(lq, uq, keys, vals[:-1])


@pytest.mark.parametrize("agg", ["sum", "max", "min"])
@pytest.mark.parametrize("eps_rel", [None, 0.05])
def test_scan_backend_matches_cuda_backend(plans, queries, agg, eps_rel):
    """Engine(backend='cuda_scan') runs K14 (SUM) or K15 (MAX/MIN), K1 in
    the Q_rel refinement as 'cuda' does, neither K2 nor K3, and equals the
    'cuda' answers bit for bit, refined flags included."""
    p = plans[1][agg, 3 if agg != "sum" else 2]
    lq, uq = queries
    scan, gather = ((ksum.range_sum, ksum.range_sum_gather) if agg == "sum"
                    else (kmax.range_max, kmax.range_max_gather))
    counts = lambda: (scan.launches, gather.launches, kloc.locate.launches)
    before = counts()
    got = Engine(backend="cuda_scan").query(p, lq, uq, eps_rel=eps_rel)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1],
                        before[2] + (0 if eps_rel is None else 2))
    want = Engine(backend="cuda").query(p, lq, uq, eps_rel=eps_rel)
    torch.testing.assert_close(got.answer, want.answer, rtol=0, atol=0)
    torch.testing.assert_close(got.refined, want.refined, rtol=0, atol=0)


@pytest.mark.parametrize("agg", ["count", "sum"])
def test_quantile_scan_backend_matches_cuda_backend(cuda, quantile_plans,
                                                    agg):
    """execute_quantile on 'cuda_scan' launches K4's scan mode once and
    equals the 'cuda' triples bit for bit."""
    plan = quantile_plans[agg, 3]
    q = _fractions(cuda)
    before = (kq.quantile_invert.launches, kq.quantile_invert.scan_launches)
    got = execute_quantile(plan, q, backend="cuda_scan")
    torch.cuda.synchronize()
    assert (kq.quantile_invert.launches,
            kq.quantile_invert.scan_launches) == (before[0], before[1] + 1)
    for g, w in zip(got, execute_quantile(plan, q)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("agg", ["count", "max", "min"])
def test_dynamic_scan_backend_matches_cuda_backend(cuda, agg):
    """DynamicEngine on 'cuda_scan': K16 (COUNT, both logs) or K17 (MAX/MIN,
    the insert log) beside K14/K15, no K5/K6 and no sparse table, and the
    'cuda' engine's answers bit for bit after inserts, deletes (shadowed
    victims on MAX/MIN), a flush and more updates."""
    t, v = hki_series(N, seed=3)
    meas = None if agg == "count" else v
    delta = 100.0 if agg == "count" else 30.0
    idx = build_index_1d(t, meas, agg, deg=2 if agg == "count" else 3,
                         delta=delta, device=cuda)
    scan = DynamicEngine(idx, backend="cuda_scan", capacity=256,
                         auto_refit=False)
    dev = DynamicEngine(idx, capacity=256, auto_refit=False)
    rng = np.random.default_rng(29)
    extremal = agg != "count"
    kernels = ((kdelta.delta_max, kmax.range_max) if extremal
               else (kdelta.delta_sum, ksum.range_sum))
    gathers = (kdelta.delta_sum_gather, kdelta.delta_max_gather,
               ksum.range_sum_gather, kmax.range_max_gather)
    a, b = t[rng.integers(0, N, 3000)], t[rng.integers(0, N, 3000)]
    lq, uq = np.minimum(a, b), np.maximum(a, b)

    def update(step):
        ins_k = np.concatenate([rng.uniform(t[0], t[-1], 40),
                                [t[0] - 20.0 - step, t[-1] + 30.0 + step]])
        ins_v = rng.uniform(25_000, 40_000, len(ins_k))
        gone = t[rng.choice(N, 12, replace=False)]
        for dyn in (scan, dev):
            if agg == "count":
                dyn.insert(ins_k)
            else:
                dyn.insert(ins_k, ins_v)
            dyn.delete(gone)

    def compare():
        assert scan.snapshot()[1].ins_st is None
        for eps_rel in (None, 0.05):
            before = [k.launches for k in kernels + gathers]
            got = scan.query(lq, uq, eps_rel=eps_rel)
            torch.cuda.synchronize()
            after = [k.launches for k in kernels + gathers]
            assert after == [before[0] + (1 if extremal else 2),
                             before[1] + 1, *before[2:]]
            want = dev.query(lq, uq, eps_rel=eps_rel)
            torch.testing.assert_close(got.answer, want.answer, rtol=0,
                                       atol=0)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)

    update(0)
    compare()
    scan.flush()
    dev.flush()
    compare()
    update(1)
    compare()


def test_window_scan_backend_matches_cuda_backend(cuda):
    """A window table on 'cuda_scan' runs K14 once per sealed epoch in the
    window and K16 on the open epoch beside them (K5 when the window holds
    the open epoch alone, as 'cuda' does), and equals 'cuda' bit for
    bit."""
    lat = tweet_latitudes(5 * 3000, seed=19)
    epochs = np.split(lat, 5)
    kw = dict(agg="count", delta=50.0, ring=8, capacity=4096, device=cuda)
    scan = WindowEngine(epochs[0], backend="cuda_scan", **kw)
    dev = WindowEngine(epochs[0], **kw)
    for w in (scan, dev):
        for e in epochs[1:4]:
            w.ingest(e)
            w.advance()
        w.ingest(epochs[4])
    lq, uq = make_queries_1d(lat, 20_000, seed=23)
    counts = lambda: (ksum.range_sum.launches, kdelta.delta_sum.launches,
                      kdelta.delta_sum_gather.launches,
                      ksum.range_sum_gather.launches)
    for (t0, t1), sealed, open_ in (((0, 4), 4, 1), ((1, 3), 3, 0),
                                    ((4, 4), 0, 1), ((2, 2), 1, 0)):
        for eps_rel in (None, 0.01):
            before = counts()
            got = scan.query(lq, uq, t0, t1, eps_rel=eps_rel)
            torch.cuda.synchronize()
            scanned = open_ if sealed else 0
            assert counts() == (before[0] + sealed, before[1] + scanned,
                                before[2] + open_ - scanned, before[3])
            want = dev.query(lq, uq, t0, t1, eps_rel=eps_rel)
            torch.testing.assert_close(got.answer, want.answer, rtol=0,
                                       atol=0)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)


def test_scan_session_matches_cuda_session(cuda):
    """PolyFit.fit(backend='cuda_scan') answers a mixed COUNT/MAX batch and
    quantiles as the default 'cuda' session does, bit for bit."""
    lat = tweet_latitudes(20_000)
    t, v = hki_series(20_000)
    datasets = {"lat": lat, "hki": (t, v)}
    specs = {"lat": TableSpec("count", ErrorBudget(abs=100.0, rel=0.01)),
             "hki": TableSpec("max", ErrorBudget(abs=50.0, rel=0.01))}
    scan = PolyFit.fit(datasets, specs, backend="cuda_scan")
    dev = PolyFit.fit(datasets, specs)
    assert scan.backend == "cuda_scan" and dev.backend == "cuda"
    batch = QueryBatch.of(QuerySpec.range("lat", *make_queries_1d(lat, 5000)),
                          QuerySpec.range("hki", *make_queries_1d(t, 3000)),
                          QuerySpec.quantile("lat", np.linspace(0, 1, 999)))
    before = (ksum.range_sum.launches, kmax.range_max.launches,
              kq.quantile_invert.scan_launches)
    got = scan.query(batch)
    torch.cuda.synchronize()
    assert (ksum.range_sum.launches, kmax.range_max.launches,
            kq.quantile_invert.scan_launches) == tuple(b + 1 for b in before)
    for g, w in zip(got, dev.query(batch)):
        torch.testing.assert_close(g.value, w.value, rtol=0, atol=0)
        torch.testing.assert_close(g.refined, w.refined, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the two-key scans of 'cuda_scan': K18, K19, K20
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fill", [0, 1, 2, CAP])
def test_delta_2d_scan_kernels_match_plain(cuda, fill):
    """K18, K19 and K20 equal their plain versions in every lane (K19 adds
    in slot order, as its plain version does) and their merge-sort-tree
    twins K9 and K11 exactly, K10 to 1e-9, on rectangles that are not
    inverted."""
    (x, y, w, ylv, wcum, wpmax), pts = _log2d(cuda, fill)
    lx, ux, ly, uy = _rects2d(cuda, pts)
    launches = lambda: (kdelta.delta_count2d.launches,
                        kdelta.delta_sum2d.launches,
                        kdelta.delta_dommax2d.launches)
    before = launches()
    k18 = kdelta.delta_count2d(lx, ux, ly, uy, x, y)
    k19 = kdelta.delta_sum2d(lx, ux, ly, uy, x, y, w)
    k20 = kdelta.delta_dommax2d(ux, uy, x, y, w)
    torch.cuda.synchronize()
    assert launches() == tuple(b + 1 for b in before)
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(k18, kdelta.delta_count2d_plain(
        lx, ux, ly, uy, x, y), **exact)
    torch.testing.assert_close(k19, kdelta.delta_sum2d_plain(
        lx, ux, ly, uy, x, y, w), **exact)
    torch.testing.assert_close(k20, kdelta.delta_dommax2d_plain(
        ux, uy, x, y, w), **exact)
    ok = (lx <= ux) & (ly <= uy)
    torch.testing.assert_close(k18[ok], kdelta.delta_count2d_gather(
        lx, ux, ly, uy, x, ylv)[ok], **exact)
    torch.testing.assert_close(k19[ok], kdelta.delta_sum2d_gather(
        lx, ux, ly, uy, x, ylv, wcum)[ok], **TOL)
    torch.testing.assert_close(k20, kdelta.delta_dommax2d_gather(
        ux, uy, x, ylv, wpmax), **exact)
    if fill == 0:
        assert not k18.any() and not k19.any()
        assert torch.isneginf(k20).all()
    else:
        assert float(k18[-2]) == fill   # the rectangle around every point


def test_delta_2d_scan_kernels_reject_bad_arguments(cuda):
    (x, y, w, _, _, _), pts = _log2d(cuda, 10)
    lx, ux, ly, uy = _rects2d(cuda, pts, n=100)
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_count2d(lx, ux, ly, uy, x, y[:-1])
    with pytest.raises(ValueError, match="shape mismatch"):
        kdelta.delta_sum2d(lx, ux[:50], ly, uy, x, y, w)
    with pytest.raises(ValueError, match="CUDA device"):
        kdelta.delta_dommax2d(ux, uy, x, y.cpu(), w)
    with pytest.raises(ValueError, match="float64"):
        kdelta.delta_sum2d(lx, ux, ly, uy, x, y, w.float())


def _min_log2d(cuda, fill, cap, nan_every=0, seed=0):
    """An x-sorted ``cap``-slot point log of ``fill`` points with negative
    measures (a MIN table's, negated), built by the engine's append with its
    merge-sort-tree levels; with ``nan_every`` a NaN measure every that
    many slots."""
    rng = np.random.default_rng(seed + fill)
    x = np.round(rng.uniform(0, 100, fill), 1)
    y = np.round(rng.uniform(0, 100, fill), 1)
    w = -rng.uniform(1, 100, fill)
    e = DeltaBuffer2D.empty(cap, device=cuda, weighted=True)
    to = lambda a: torch.as_tensor(a, device=cuda)
    x, y, w, ylv, _, wpmax = _append_2d(e.ins_x, e.ins_y, e.ins_w, to(x),
                                        to(y), to(w), cap=cap, levels=True,
                                        weighted=True)
    if nan_every and fill:
        w = w.clone()
        w[:fill:nan_every] = float("nan")
    return x, y, w, ylv, wpmax


def _dom_corners(cuda, n=70_000):
    """Corners over the log's range, and the lanes that reach the sentinel
    tail or none of the log: at and above the sentinel, +-inf, NaN."""
    rng = np.random.default_rng(61)
    big = big_sentinel(torch.float64)
    inf, nan = np.inf, np.nan
    u = np.concatenate([rng.uniform(-10, 110, n),
                        [inf, big, big, 2 * big, inf, 50.0, nan, inf, -inf,
                         big, nan, 1e308]])
    v = np.concatenate([rng.uniform(-10, 110, n),
                        [inf, big, inf, big, 50.0, inf, 50.0, nan, inf,
                         np.nextafter(big, 0), nan, 1e308]])
    return (torch.as_tensor(u, device=cuda), torch.as_tensor(v, device=cuda))


@pytest.mark.parametrize("with_nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("fill,cap", [(0, CAP), (1, CAP), (1023, CAP),
                                      (1024, CAP), (1025, CAP), (2049, CAP),
                                      (3072, CAP), (CAP, CAP),
                                      (9000, 4 * CAP)])
def test_delta_dommax2d_kernel_tail_lanes(cuda, fill, cap, with_nan):
    """K20 equals its plain version in value (NaN equal) and its
    merge-sort-tree twin K11 on all-negative measures, with and without a
    NaN measure in some tiles, on the lanes that reach the sentinel tail
    (whose 0 K20 folds back in where it skipped tiles), on NaN and infinite
    corners, and on a log of several tiles a chunk (4 x CAP slots); one
    launch a call, and two launches give the same bits."""
    x, y, w, ylv, wpmax = _min_log2d(cuda, fill, cap,
                                     nan_every=700 if with_nan else 0)
    u, v = _dom_corners(cuda)
    before = kdelta.delta_dommax2d.launches
    got = kdelta.delta_dommax2d(u, v, x, y, w)
    again = kdelta.delta_dommax2d(u, v, x, y, w)
    torch.cuda.synchronize()
    assert kdelta.delta_dommax2d.launches == before + 2
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, kdelta.delta_dommax2d_plain(u, v, x, y,
                                                                w), **exact)
    assert torch.equal(got.view(torch.int64), again.view(torch.int64))
    if not with_nan:
        torch.testing.assert_close(got, kdelta.delta_dommax2d_gather(
            u, v, x, ylv, wpmax), **exact)
    if fill < cap and not with_nan:   # a corner over the sentinel
        assert (got[-12:-8] == 0).all()   # dominates the tail's 0
    assert torch.isneginf(got[-6:-4]).all()   # NaN corners


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "min2d"])
def test_dynamic2d_scan_backend_matches_cuda_backend(cuda, agg):
    """DynamicEngine2D on 'cuda_scan': K18 (COUNT, both logs), K19 (SUM,
    both logs) or K20 (dominance, the insert log) beside K12/K13, no K9-K11
    and no merge-sort-tree levels in its buffer, and the 'cuda' engine's
    answers (COUNT and MIN bit for bit, SUM to 1e-9) and refined flags
    after inserts, deletes (shadowed victims on MIN), a flush and more
    updates."""
    px, py = osm_points(N2, seed=47)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    delta = {"count2d": 20.0, "sum2d": 400.0, "min2d": 10.0}[agg]
    idx = build_index_2d(px, py, measures=None if agg == "count2d" else w,
                         agg=agg, deg=2, delta=delta, max_depth=6,
                         device=cuda)
    scan = DynamicEngine2D(idx, backend="cuda_scan", capacity=256,
                           auto_refit=False)
    dev = DynamicEngine2D(idx, capacity=256, auto_refit=False)
    rng = np.random.default_rng(59)
    if agg == "min2d":
        ci = rng.integers(0, N2, 20_000)
        ranges = (px[ci], py[ci])
        scans = (kdelta.delta_dommax2d,)
    else:
        ranges = make_queries_2d(px, py, 20_000, seed=61)
        scans = ((kdelta.delta_count2d,) if agg == "count2d"
                 else (kdelta.delta_sum2d,))
    gathers = (kdelta.delta_count2d_gather, kdelta.delta_sum2d_gather,
               kdelta.delta_dommax2d_gather, k2d.corner_count2d_gather,
               k2d.corner_eval2d_gather)
    gone = rng.choice(N2, 24, replace=False)
    x0, x1, y0, y1 = px.min(), px.max(), py.min(), py.max()

    def update(step):
        ins = (rng.uniform(x0, x1, 40), rng.uniform(y0, y1, 40),
               rng.uniform(40, 60, 40))
        out = gone[12 * step:12 * (step + 1)]
        for dyn in (scan, dev):
            dyn.insert(*(ins[:2] if agg == "count2d" else ins))
            dyn.delete(px[out], py[out])

    def compare():
        big = big_sentinel(torch.float64)
        assert bool((scan.snapshot()[1].ins_ylv == big).all())
        for eps_rel in (None, 0.05):
            before = [k.launches for k in scans + gathers]
            got = scan.query(*ranges, eps_rel=eps_rel)
            torch.cuda.synchronize()
            want_scan = 1 if agg == "min2d" else 2
            assert [k.launches for k in scans + gathers] == \
                [before[0] + want_scan, *before[1:]]
            want = dev.query(*ranges, eps_rel=eps_rel)
            check = (dict(**TOL) if agg == "sum2d" else dict(rtol=0, atol=0))
            torch.testing.assert_close(got.answer, want.answer, **check)
            torch.testing.assert_close(got.refined, want.refined, rtol=0,
                                       atol=0)

    update(0)
    compare()
    scan.flush()
    dev.flush()
    assert scan.refit_count == dev.refit_count == 1
    assert scan.last_refit_stats == dev.last_refit_stats
    compare()
    update(1)
    compare()


def test_scan_session_dynamic2d_table(cuda):
    """A session's dynamic two-key table on 'cuda_scan' (it raised before
    K18-K20) answers as the default 'cuda' session does."""
    px, py = osm_points(N2, seed=5)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    specs = {"pts": TableSpec("sum2d", ErrorBudget(abs=1600.0, rel=0.05),
                              deg=2, dynamic=True, capacity=256,
                              background=False)}
    scan = PolyFit.fit({"pts": (px, py, w)}, specs, backend="cuda_scan")
    dev = PolyFit.fit({"pts": (px, py, w)}, specs)
    rect = make_queries_2d(px, py, 5000, seed=3)
    for s in (scan, dev):
        s.insert("pts", px[:16] + 0.01, py[:16] + 0.01, w[:16])
        s.delete("pts", px[16:24], py[16:24])
    before = kdelta.delta_sum2d.launches
    got = scan.query(QuerySpec.rect("pts", *rect))
    torch.cuda.synchronize()
    assert kdelta.delta_sum2d.launches == before + 2
    want = dev.query(QuerySpec.rect("pts", *rect))
    torch.testing.assert_close(got.value, want.value, **TOL)
    torch.testing.assert_close(got.refined, want.refined, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K21 and the float32 instantiations of K2, K3, K14, K15 and K21
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ops_tables(cuda):
    """``ops.from_index`` tables at float32 and float64 on the card: SUM
    deg 1-4, MAX deg 2-3 (tests/test_kernels.py's data at n 8,000)."""
    rng = np.random.default_rng(0)
    keys = np.sort(rng.uniform(0, 1000, 8000))
    sums = rng.uniform(0, 10, 8000)
    walk = np.abs(np.cumsum(rng.normal(0, 5, 8000))) + 10
    out = {}
    for agg, deg in (("sum", 1), ("sum", 2), ("sum", 3), ("sum", 4),
                     ("max", 2), ("max", 3)):
        idx = build_index_1d(keys, sums if agg == "sum" else walk, agg,
                             deg=deg, delta=30.0 if agg == "sum" else 15.0,
                             device=cuda)
        for dt in (torch.float32, torch.float64):
            out[agg, deg, dt] = ops.from_index(idx, dt)
    return keys, sums, out


def _ops_queries(cuda, keys, dt, n=70_001):
    rng = np.random.default_rng(3)
    a, b = keys[rng.integers(0, len(keys), (2, n))]
    return tuple(torch.maximum(torch.as_tensor(q, dtype=dt, device=cuda),
                               torch.tensor(keys[0], dtype=dt, device=cuda))
                 for q in (np.minimum(a, b), np.maximum(a, b)))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("deg", [1, 2, 3, 4])
def test_poly_eval_and_range_sum_kernels_match_plain(cuda, ops_tables, dt,
                                                     deg):
    """K21, K2 and K14 at the table's type equal their plain versions in
    every lane (K14 and K2 each other), output in that type; K21 and K2
    descend the plan's ``seg_tree``."""
    keys, _, tabs = ops_tables
    t = tabs["sum", deg, dt]
    lq, uq = _ops_queries(cuda, keys, dt)
    args = (uq, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs)
    counts = lambda: (kp.poly_eval.launches, ksum.range_sum_gather.launches,
                      ksum.range_sum.launches)
    before = counts()
    k21 = kp.poly_eval(*args, t.seg_tree)
    k2 = ksum.range_sum_gather(lq, uq, t.seg_lo, t.seg_hi, t.coeffs,
                               t.seg_tree)
    k14 = ksum.range_sum(lq, uq, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs)
    torch.cuda.synchronize()
    assert counts() == tuple(b + 1 for b in before)
    assert k21.dtype == k2.dtype == k14.dtype == dt
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(k21, kp.poly_eval_plain(*args), **exact)
    torch.testing.assert_close(k2, ksum.range_sum_gather_plain(
        lq, uq, t.seg_lo, t.seg_hi, t.coeffs), **exact)
    torch.testing.assert_close(k14, ksum.range_sum_plain(
        lq, uq, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs), **exact)
    torch.testing.assert_close(k14, k2, **exact)


def _k21_case(cuda, dt, deg, Q):
    """A segment table in a plan's layout (_segment_table: 300 live
    segments of 512, two equal starts) with random rows of ``deg``, and Q
    keys, its edge lanes first: every start, the doubles either side of
    each, the sentinel, +-inf, NaN, below the domain; then keys from
    [-5, 1005].  (q, seg_lo, seg_next, seg_hi, coeffs)."""
    lo, nx, hi, _, _ = _segment_table(cuda, 300, 512, dt, seed=deg)
    rng = np.random.default_rng(deg)
    cf = torch.as_tensor(rng.normal(0, 1, (512, deg + 1)), dtype=dt)
    cf[300:] = 0.0
    s = lo[:300]
    inf = torch.tensor(np.inf, dtype=dt, device=cuda)
    edge = torch.cat([s, torch.nextafter(s, -inf), torch.nextafter(s, inf),
                      torch.tensor([big_sentinel(dt), np.inf, -np.inf,
                                    np.nan, -1.0], dtype=dt, device=cuda)])
    rand = torch.as_tensor(rng.uniform(-5, 1005, Q), dtype=dt, device=cuda)
    return torch.cat([edge, rand])[:Q], lo, nx, hi, cf.to(cuda)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("Q", [1, 255, 65_537])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4, 5, 6, 7, 8, 10])
def test_poly_eval_kernel_every_degree_and_ragged_counts(cuda, deg, Q, dt):
    """K21 (a key a thread, #(seg_lo <= q) by a descent of seg_lo's search
    tree, the boundary row) equals its plain version (one-hot membership
    over every row) in every lane (NaN as NaN) at every instantiated degree
    0-8 and in the runtime-degree form (deg 10), at float64 and float32, at
    ragged key counts, on every start, either side of it, the sentinel,
    +-inf, NaN and below the domain; with the tree passed and without one
    (the wrapper builds it): one launch a call, the two the same bits."""
    q, lo, nx, hi, cf = _k21_case(cuda, dt, deg, Q)
    before = kp.poly_eval.launches
    got = kp.poly_eval(q, lo, nx, hi, cf, kloc.search_tree(lo))
    bare = kp.poly_eval(q, lo, nx, hi, cf)
    torch.cuda.synchronize()
    assert kp.poly_eval.launches == before + 2
    assert got.shape == (Q,) and got.dtype == dt
    torch.testing.assert_close(got, kp.poly_eval_plain(q, lo, nx, hi, cf),
                               rtol=0, atol=0, equal_nan=True)
    bits = torch.int32 if dt == torch.float32 else torch.int64
    assert torch.equal(got.view(bits), bare.view(bits))


def test_poly_eval_kernel_refuses_a_misaligned_or_misshapen_tree(cuda):
    """K21 reads seg_lo, coeffs and the tree 16 bytes at a time: a tree, a
    seg_lo or coeffs that start off 16 bytes (offset views) are refused, a
    copy is taken; so are a tree of another shape and one off the card."""
    q, lo, nx, hi, cf = _k21_case(cuda, torch.float64, 3, 1000)
    tree = kloc.search_tree(lo)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for args in ((lo, nx, hi, cf, offset(tree)), (offset(lo), nx, hi, cf, tree),
                 (lo, nx, hi, offset(cf), tree)):
        with pytest.raises(ValueError, match="16-byte"):
            kp.poly_eval(q, *args)
    with pytest.raises(ValueError, match="search tree"):
        kp.poly_eval(q, lo, nx, hi, cf, tree[:-1].clone())
    with pytest.raises(ValueError, match="search tree"):
        kp.poly_eval(q, lo, nx, hi, cf, kloc.search_tree(lo[:300]))
    with pytest.raises(ValueError, match="CUDA device"):
        kp.poly_eval(q, lo, nx, hi, cf, tree.cpu())
    assert torch.equal(
        kp.poly_eval(q, lo, nx, hi, cf, offset(tree).clone())
        .view(torch.int64),
        kp.poly_eval(q, lo, nx, hi, cf, tree).view(torch.int64))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("deg", [2, 3])
def test_range_max_kernels_match_plain_by_type(cuda, ops_tables, dt, deg):
    """K3 (its float64 sparse table cast to the table's type) and K15 at
    the table's type equal their plain versions and each other."""
    keys, _, tabs = ops_tables
    t = tabs["max", deg, dt]
    lq, uq = _ops_queries(cuda, keys, dt)
    before = (kmax.range_max_gather.launches, kmax.range_max.launches)
    k3 = kmax.range_max_gather(lq, uq, t.seg_lo, t.seg_hi, t.coeffs, t.st)
    k15 = kmax.range_max(lq, uq, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs,
                         t.seg_agg)
    torch.cuda.synchronize()
    assert (kmax.range_max_gather.launches,
            kmax.range_max.launches) == (before[0] + 1, before[1] + 1)
    assert k3.dtype == k15.dtype == dt
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(k3, kmax.range_max_gather_plain(
        lq, uq, t.seg_lo, t.seg_hi, t.coeffs, t.st), **exact)
    torch.testing.assert_close(k15, kmax.range_max_plain(
        lq, uq, t.seg_lo, t.seg_next, t.seg_hi, t.coeffs, t.seg_agg),
        **exact)
    torch.testing.assert_close(k15, k3, **exact)


def test_ops_on_the_card(cuda, ops_tables):
    """kernels.ops on the card: 'cuda' launches K21/K2/K3, 'cuda_scan'
    K21/K14/K15, both bit for bit alike at float32 and float64, within the
    float32 guarantee of numpy truth, and float64 'cuda' range SUM equal
    to the engine's raw approximation (both K2)."""
    keys, sums, tabs = ops_tables
    rng = np.random.default_rng(1)
    a, b = keys[rng.integers(0, len(keys), (2, 20_000))]
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    for dt in (torch.float32, torch.float64):
        s, m = tabs["sum", 2, dt], tabs["max", 3, dt]
        counts = lambda: (kp.poly_eval.launches,
                          ksum.range_sum_gather.launches,
                          kmax.range_max_gather.launches,
                          ksum.range_sum.launches, kmax.range_max.launches)
        before = counts()
        g = (ops.poly_eval(s, uq), ops.range_sum(s, lq, uq),
             ops.range_max(m, lq, uq))
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                            *before[3:])
        before = counts()
        c = (ops.poly_eval(s, uq, backend="cuda_scan"),
             ops.range_sum(s, lq, uq, backend="cuda_scan"),
             ops.range_max(m, lq, uq, backend="cuda_scan"))
        torch.cuda.synchronize()
        assert counts() == (before[0] + 1, *before[1:3], before[3] + 1,
                            before[4] + 1)
        for x, y in zip(g, c):
            assert x.dtype == dt and x.device.type == "cuda"
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the float32 guarantee against numpy truth (test_kernels.py:90)
    cf = np.concatenate([[0.0], np.cumsum(sums)])
    truth = (cf[np.searchsorted(keys, uq, side="right")]
             - cf[np.searchsorted(keys, lq, side="right")])
    got = ops.range_sum(tabs["sum", 2, torch.float32], lq, uq)
    slack = cf[-1] * np.finfo(np.float32).eps * 8
    assert np.abs(got.cpu().numpy() - truth).max() <= 2 * 30.0 + slack
    # float64 'cuda' equals the engine's raw approximation: both are K2
    s64 = tabs["sum", 2, torch.float64]
    lqd, uqd = (torch.maximum(torch.as_tensor(q, device=cuda), s64.domain_lo)
                for q in (lq, uq))
    torch.testing.assert_close(ops.range_sum(s64, lq, uq),
                               raw_sum(s64, lqd, uqd, backend="cuda"),
                               rtol=0, atol=0)


# -- batched-Lawson construction on the card ---------------------------------

def _lawson_probes(n_probes=48, L=1024, seed=2):
    """Probe windows as parallel_segmentation builds them: runs of sorted
    clustered latitudes from random starts, lengths from 3 to L, each
    rescaled to [-1, 1], a COUNT CF, padding past the run."""
    keys = np.sort(tweet_latitudes(200_000, seed=seed))
    rng = np.random.default_rng(seed)
    lens = np.unique(np.geomspace(3, L, n_probes).astype(int))
    u = np.zeros((len(lens), L))
    F = np.zeros((len(lens), L))
    valid = np.zeros((len(lens), L))
    for b, m in enumerate(lens):
        s = int(rng.integers(0, len(keys) - m))
        kw = keys[s:s + m]
        span = kw[-1] - kw[0] if kw[-1] > kw[0] else 1.0
        u[b, :m] = (2.0 * kw - kw[0] - kw[-1]) / span
        F[b, :m] = np.arange(1.0, m + 1.0)
        valid[b, :m] = 1.0
    return u, F, valid


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_lawson_batched_card_matches_cpu(cuda, deg):
    """lawson_batched on the card equals its CPU run: errs at rtol 1e-9 and
    the same feasibility decisions errs <= delta on a fixed probe set (the
    decisions that set every parallel boundary)."""
    from repro_torch.core import lawson_batched
    u, F, valid = _lawson_probes()
    ec = lawson_batched(*(torch.as_tensor(a) for a in (u, F, valid)), deg,
                        iters=40)[1].numpy()
    eg = lawson_batched(*(torch.as_tensor(a, device=cuda)
                          for a in (u, F, valid)), deg, iters=40)[1]
    assert eg.device.type == "cuda"
    np.testing.assert_allclose(eg.cpu().numpy(), ec, **TOL)
    for delta in (5.0, 20.0, 50.0):
        np.testing.assert_array_equal(eg.cpu().numpy() <= delta,
                                      ec <= delta)


def test_parallel_build_on_card_covers_and_certifies(cuda):
    """build_index_1d(method="parallel") with its probes fitted on the card:
    every segment certifies, the segments tile the keys, at most chunks - 1
    more than greedy GS, and the plan answers on 'cuda' as on 'torch'."""
    from repro_torch.core import build_index_1d as build
    keys = np.sort(tweet_latitudes(16_384, seed=4))
    idx = build(keys, None, "count", deg=2, delta=20.0, method="parallel",
                device=cuda)
    greedy = build(keys, None, "count", deg=2, delta=20.0, device="cpu")
    assert np.all(idx.seg_err <= 20.0)
    starts = idx.seg_start.cpu().numpy()
    assert starts[0] == 0 and np.all(np.diff(starts) > 0)
    np.testing.assert_array_equal(idx.seg_lo.cpu().numpy(), keys[starts])
    assert greedy.h <= idx.h <= greedy.h + 4 - 1
    plan = build_plan(idx)
    rng = np.random.default_rng(3)
    a, b = keys[rng.integers(0, len(keys), (2, 4096))]
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    for eps in (None, 0.05):
        got = Engine("cuda").sum(plan, lq, uq, eps_rel=eps)
        want = Engine("torch").sum(plan, lq, uq, eps_rel=eps)
        torch.testing.assert_close(got.answer, want.answer, **TOL)
        assert torch.equal(got.refined, want.refined)


# -- LSM level ladders on the card -------------------------------------------

LSM_POLICY = dict(query_overhead_us_per_row=0.0)


def _lsm_pair(device, cls, cols, meas, agg, **kw):
    """One op sequence through an engine on the card ('cuda') and on the
    CPU ('torch'): full-capacity inserts that compact, a buffered batch,
    deletes of base rows, of a compacted level's rows and of buffered
    inserts.  The host fits make the two ladders alike."""
    from repro_torch.engine import CompactionPolicy
    rng = np.random.default_rng(17)
    weighted = meas is not None
    engs = [cls(*cols, meas, agg=agg, capacity=128, growth=2,
                background=False, policy=CompactionPolicy(**LSM_POLICY),
                device=d, **kw) for d in (device, "cpu")]
    lo, hi = 0.0, 100.0
    batches = []
    for m in (128, 128, 40):
        new = [rng.uniform(lo, hi, m) for _ in cols]
        w = rng.uniform(1.0, 5.0, m) if weighted else None
        for e in engs:
            e.insert(*new, w)
        batches.append(new)
    for dead in ([c[10:20] for c in cols], [c[:3] for c in batches[0]],
                 [c[:5] for c in batches[-1]]):
        for e in engs:
            e.delete(*dead)
    g, c = engs
    assert sorted(g._levels) == sorted(c._levels)
    assert g.compaction_count == c.compaction_count >= 1
    assert g.n_levels >= 2 and g.n_pending == c.n_pending > 0
    return g, c


@pytest.mark.parametrize("agg", ["sum", "count", "max", "min"])
def test_lsm_ladder_cuda_matches_torch(cuda, agg):
    """A 1-D ladder with tombstones or victims and a live buffer: 'cuda'
    (K2/K3 a level, K5/K6 on the buffer, K1 in the exact answers) equals
    the CPU ladder on 'torch' at 1e-9 with equal refined flags, and
    'cuda_scan' equals 'cuda' (bit for bit but on SUM, where K16 adds the
    buffered measures in slot order and K5 differences prefix sums)."""
    from repro_torch.engine import LsmEngine, execute_lsm
    rng = np.random.default_rng(5)
    keys = np.sort(rng.uniform(0.0, 100.0, 1500))
    vals = rng.uniform(0.5, 8.0, 1500)
    g, c = _lsm_pair(cuda, LsmEngine, (keys,),
                     None if agg == "count" else vals, agg, delta=10.0)
    a, b = rng.uniform(-5.0, 105.0, (2, 3000))
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    lsm, buf = g.snapshot()
    for eps in (None, 0.05):
        got, want = g.query(lq, uq, eps_rel=eps), c.query(lq, uq, eps_rel=eps)
        torch.testing.assert_close(got.answer.cpu(), want.answer, **TOL)
        assert torch.equal(got.refined.cpu(), want.refined)
        scan = execute_lsm(lsm, buf, (lq, uq), backend="cuda_scan",
                           eps_rel=eps)
        assert torch.equal(scan.refined, got.refined)
        for f in ("answer", "approx"):
            if agg == "sum":   # K16 adds the buffer's measures in slot order
                torch.testing.assert_close(getattr(scan, f), getattr(got, f),
                                           **TOL)
            else:
                assert torch.equal(getattr(scan, f), getattr(got, f)), f


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "max2d"])
def test_lsm2d_ladder_cuda_matches_torch(cuda, agg):
    """A 2-D ladder with tombstones or victims and a live buffer: 'cuda'
    (K7/K8 a level, K9/K10/K11 on the buffer, K1 in the exact answers)
    equals the CPU ladder on 'torch' at 1e-9 with equal refined flags."""
    from repro_torch.engine import LsmEngine2D
    rng = np.random.default_rng(6)
    px, py = rng.uniform(0.0, 100.0, (2, 1200))
    w = None if agg == "count2d" else rng.uniform(1.0, 5.0, 1200)
    delta = {"count2d": 10.0, "sum2d": 40.0}.get(agg, 2.0)
    g, c = _lsm_pair(cuda, LsmEngine2D, (px, py), w, agg, deg=2,
                     delta=delta)
    if agg == "max2d":
        qs = tuple(rng.uniform(-5.0, 105.0, (2, 3000)))
    else:
        x = np.sort(rng.uniform(-5.0, 105.0, (2, 3000)), axis=0)
        y = np.sort(rng.uniform(-5.0, 105.0, (2, 3000)), axis=0)
        qs = (x[0], x[1], y[0], y[1])
    for eps in (None, 0.05):
        got, want = g.query(*qs, eps_rel=eps), c.query(*qs, eps_rel=eps)
        torch.testing.assert_close(got.answer.cpu(), want.answer, **TOL)
        assert torch.equal(got.refined.cpu(), want.refined)


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_lsm_one_level_is_the_flat_engine_on_the_card(cuda, agg):
    """A one-level ladder on 'cuda' computes the flat executor's floats
    exactly (in-domain ranges: any for SUM, covering a key for MAX)."""
    from repro_torch.engine import LsmEngine, execute, execute_lsm
    rng = np.random.default_rng(8)
    keys = np.sort(rng.uniform(0.0, 1000.0, 3000))
    vals = rng.uniform(0.5, 8.0, 3000)
    eng = LsmEngine(keys, vals, agg=agg, delta=20.0, device=cuda)
    lsm, _ = eng.snapshot()
    assert len(lsm.levels) == 1
    flat = build_plan(build_index_1d(keys, vals, agg, deg=eng.deg,
                                     delta=20.0, device=cuda))
    i = rng.integers(0, keys.size - 1, 5000)
    j = rng.integers(i, keys.size)
    lq, uq = keys[i], keys[j]
    for eps in (None, 0.05):
        got = execute_lsm(lsm, None, (lq, uq), eps_rel=eps)
        want = execute(flat, (lq, uq), eps_rel=eps)
        for f in ("answer", "approx", "refined"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


# -- sharded tables on the card ------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)


def _kernel_launches():
    """Every kernel wrapper's launch counter (the sharded path runs the
    'torch' arithmetic and must move none of them)."""
    mods = (kloc, ksum, kmax, kq, kdelta, k2d, kp)
    return {(m.__name__, k): getattr(m, k).launches for m in mods
            for k in dir(m) if hasattr(getattr(m, k), "launches")}


def _same_result(got, want):
    for f in ("answer", "approx", "refined"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("agg", ["sum", "max", "min"])
def test_sharded_static_1d_on_the_card(plans, queries, agg):
    """ShardedEngine at S = 1, 2, 4, 8 on the card equals the unsharded
    'torch' engine on the same plan exactly, Q_abs and Q_rel, and
    launches no kernel."""
    from repro_torch.engine import ShardedEngine
    plan = plans[1][agg, 3]
    for eps in (None, 0.05):
        want = Engine(backend="torch").query(plan, *queries, eps_rel=eps)
        before = _kernel_launches()
        for s in SHARD_COUNTS:
            got = ShardedEngine(s).query(plan, *queries, eps_rel=eps)
            assert got.answer.device.type == "cuda"
            _same_result(got, want)
        assert _kernel_launches() == before


@pytest.mark.parametrize("agg", ["count", "max"])
def test_sharded_dynamic_1d_full_buffer_on_the_card(cuda, agg):
    """A full 4,096-slot buffer (COUNT: 3,072 inserts and 1,024
    tombstones; MAX: 4,032 inserts and 64 shadowed victims) through
    ShardedEngine equals the unsharded 'torch' dynamic path exactly."""
    from repro_torch.engine import ShardedEngine
    cap = 4096
    rng = np.random.default_rng(9)
    if agg == "count":
        keys, vals = tweet_latitudes(30_000, seed=5), None
    else:
        keys, vals = hki_series(10_000, seed=5)
    eng = DynamicEngine(build_index_1d(keys, vals, agg, delta=30.0,
                                       device=cuda), backend="torch",
                        capacity=cap, auto_refit=False)
    dead = 1024 if agg == "count" else 64
    m = cap - dead
    eng.insert(rng.uniform(keys.min() - 1.0, keys.max() + 1.0, m),
               None if vals is None else
               rng.uniform(vals.min(), vals.max() + 5.0, m))
    eng.delete(keys[rng.choice(keys.size, dead, replace=False)]
               if vals is None else keys[np.argsort(-vals)[:dead]])
    assert eng.n_pending == cap and eng.refit_count == 0
    plan, buf = eng.snapshot()
    assert (buf.vic_keys is not None) == (agg == "max")
    lq, uq = make_queries_1d(keys, 20_000, seed=3)
    for eps in (None, 0.05):
        want = eng.query(lq, uq, eps_rel=eps)
        for s in SHARD_COUNTS:
            _same_result(ShardedEngine(s).query(plan, lq, uq, eps_rel=eps,
                                                buf=buf), want)


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "max2d", "min2d"])
def test_sharded_2d_static_and_dynamic_on_the_card(cuda, agg):
    """ShardedEngine2D on a static plan and on a dynamic table's live
    state (buffered inserts and deletes, victims on the dominance tables)
    equals the unsharded 'torch' path on the card exactly."""
    from repro_torch.engine import ShardedEngine2D
    px, py = osm_points(8_000, seed=3)
    w = None if agg == "count2d" else 50 + 10 * np.sin(px) + 10 * np.cos(py)
    delta = {"count2d": 50.0, "sum2d": 2500.0}.get(agg, 10.0)
    idx = build_index_2d(px, py, measures=w, agg=agg, deg=2, delta=delta,
                         device=cuda)
    plan = build_plan_2d(idx)
    rect = make_queries_2d(px, py, 8_000, seed=4)
    ci = np.random.default_rng(4).integers(0, px.size, 8_000)
    qs = (px[ci], py[ci]) if agg in ("max2d", "min2d") else rect
    dyn = DynamicEngine2D(idx, backend="torch", capacity=1024,
                          auto_refit=False)
    rng = np.random.default_rng(6)
    ins = (rng.uniform(px.min(), px.max(), 512),
           rng.uniform(py.min(), py.max(), 512))
    dyn.insert(*ins, *(() if w is None else (rng.uniform(30, 70, 512),)))
    dyn.delete(px[:64], py[:64])
    dplan, dbuf = dyn.snapshot()
    for eps in (None, 0.05):
        want = Engine(backend="torch").query(plan, *qs, eps_rel=eps)
        want_d = dyn.query(*qs, eps_rel=eps)
        for s in SHARD_COUNTS:
            se = ShardedEngine2D(s)
            _same_result(se.query(plan, *qs, eps_rel=eps), want)
            _same_result(se.query(dplan, *qs, eps_rel=eps, buf=dbuf),
                         want_d)


@pytest.mark.parametrize("agg", ["count", "max", "sum2d"])
def test_sharded_lsm_ladders_on_the_card(cuda, agg):
    """A ladder on the card (tombstones or victims, a live buffer) through
    the sharded LSM path equals execute_lsm on 'torch' exactly (Q_abs)."""
    from repro_torch.engine import (LsmEngine, LsmEngine2D, ShardedEngine,
                                    ShardedEngine2D, execute_lsm)
    rng = np.random.default_rng(5)
    if agg == "sum2d":
        px, py = rng.uniform(0.0, 100.0, (2, 1200))
        g, _ = _lsm_pair(cuda, LsmEngine2D, (px, py),
                         rng.uniform(1.0, 5.0, 1200), agg, deg=2,
                         delta=40.0)
        x = np.sort(rng.uniform(-5.0, 105.0, (2, 3000)), axis=0)
        y = np.sort(rng.uniform(-5.0, 105.0, (2, 3000)), axis=0)
        qs, cls = (x[0], x[1], y[0], y[1]), ShardedEngine2D
    else:
        keys = np.sort(rng.uniform(0.0, 100.0, 1500))
        g, _ = _lsm_pair(cuda, LsmEngine, (keys,),
                         None if agg == "count" else
                         rng.uniform(0.5, 8.0, 1500), agg, delta=10.0)
        a, b = rng.uniform(-5.0, 105.0, (2, 3000))
        qs, cls = (np.minimum(a, b), np.maximum(a, b)), ShardedEngine
    lsm, buf = g.snapshot()
    want = execute_lsm(lsm, buf, qs, backend="torch")
    for s in SHARD_COUNTS:
        _same_result(cls(s).query(lsm, *qs, buf=buf), want)


# -- the serving engine: one captured CUDA graph per bucket -------------------

SERVE_TABLES = ("sum", "max", "min", "c2", "s2", "x2", "n2", "dsum", "dmax",
                "dmin", "dc2", "ds2", "dn2", "lsum", "lmax", "ls2")


def _serve_data(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.uniform(0.0, 100.0, 3000))
    vals = rng.uniform(0.0, 10.0, 3000)
    xs, ys = rng.uniform(0.0, 50.0, (2, 1500))
    ws = rng.uniform(1.0, 5.0, 1500)
    return keys, vals, xs, ys, ws


def _serve_session(cuda, seed=0x5E5, names=SERVE_TABLES):
    """One session on the card with a table of every kind the serving
    engine caches (or the ``names`` among them): static, dynamic and LSM,
    one and two keys."""
    keys, vals, xs, ys, ws = _serve_data(seed)
    b = ErrorBudget(abs=50.0, rel=0.01)
    m = ErrorBudget(abs=2.0, rel=0.01)
    dyn = dict(dynamic=True, capacity=256, auto_refit=False, background=False)
    one, two = (keys, vals), (xs, ys, ws)
    data = {"sum": one, "max": one, "min": one, "c2": (xs, ys), "s2": two,
            "x2": two, "n2": two, "dsum": one, "dmax": one, "dmin": one,
            "dc2": (xs, ys), "ds2": two, "dn2": two, "lsum": keys,
            "lmax": one, "ls2": two}
    specs = {"sum": TableSpec("sum", b), "max": TableSpec("max", m),
             "min": TableSpec("min", m, deg=2),
             "c2": TableSpec("count2d", b), "s2": TableSpec("sum2d", b),
             "x2": TableSpec("max2d", m), "n2": TableSpec("min2d", m),
             "dsum": TableSpec("sum", b, **dyn),
             "dmax": TableSpec("max", m, **dyn),
             "dmin": TableSpec("min", m, **dyn),
             "dc2": TableSpec("count2d", b, **dyn),
             "ds2": TableSpec("sum2d", b, **dyn),
             "dn2": TableSpec("min2d", m, **dyn),
             "lsum": TableSpec("count", b, lsm=True, **dyn),
             "lmax": TableSpec("max", m, lsm=True, **dyn),
             "ls2": TableSpec("sum2d", b, lsm=True, **dyn)}
    return PolyFit.fit({n: data[n] for n in names},
                       {n: specs[n] for n in names}, device=cuda)


def _serve_specs(session, name, rng, n=700):
    """n ranges (or corners) over the table's domain, as one spec each
    under Q_abs and Q_rel."""
    agg = session.spec(name).agg
    if agg in ("count2d", "sum2d"):
        x = np.sort(rng.uniform(-2.0, 52.0, (2, n)), axis=0)
        y = np.sort(rng.uniform(-2.0, 52.0, (2, n)), axis=0)
        cols = (x[0], x[1], y[0], y[1])
    elif agg in ("max2d", "min2d"):
        cols = tuple(rng.uniform(-2.0, 52.0, (2, n)))
    else:
        cols = tuple(np.sort(rng.uniform(-2.0, 102.0, (2, n)), axis=0))
    return [QuerySpec(name, cols, rel) for rel in (None, 0.01)]


@pytest.fixture(scope="module")
def serve_session(cuda):
    """The serving session with buffered rows in every dynamic table, an
    extremal delete shadowing a victim in ``dmax``, ``dmin`` and ``dn2``,
    and tombstones in the ladders."""
    s = _serve_session(cuda)
    keys, vals, xs, ys, ws = _serve_data(0x5E5)
    rng = np.random.default_rng(9)
    k, v = rng.uniform(0, 100, 64), rng.uniform(0, 12, 64)
    px, py, pw = rng.uniform(0, 50, 64), rng.uniform(0, 50, 64), \
        rng.uniform(1, 6, 64)
    for name in ("dsum", "dmax", "dmin", "lmax"):
        s.insert(name, k, v)
    s.insert("lsum", k)
    s.insert("dc2", px, py)
    for name in ("ds2", "dn2", "ls2"):
        s.insert(name, px, py, pw)
    for name in ("dmax", "dmin", "lmax", "lsum"):
        s.delete(name, keys[[5, 900, 2000]])
    for name in ("dn2", "ls2"):
        s.delete(name, xs[[3, 700]], ys[[3, 700]])
    return s


@pytest.mark.parametrize("name", SERVE_TABLES)
def test_serving_graph_replay_equals_eager(serve_session, name):
    """Every executor kind, captured as a CUDA graph per bucket and
    replayed through the engine, equals the session's eager path bit for
    bit (answer, approximation, refined flag), under Q_abs and Q_rel; the
    quantile executors too on the SUM tables."""
    from repro_torch.serve import ServingEngine
    s = serve_session
    specs = _serve_specs(s, name,
                         np.random.default_rng(SERVE_TABLES.index(name)))
    if s.spec(name).agg == "sum" and not s.spec(name).lsm:
        specs.append(QuerySpec.quantile(
            name, np.random.default_rng(3).uniform(0, 1, 700)))
    eng = ServingEngine(s, start=False)
    try:
        eng.start()
        got = eng.query(specs, timeout=300)
        assert eng.stats.aot_compiles > 0
        units = [e.cur for e in eng._cache.values()]
        assert units and all(u.graph is not None for u in units)
        again = eng.query(specs, timeout=300)   # replays, no capture
        assert eng.stats.aot_hits > 0
        for g, a, w in zip(got, again, s.query(specs)):
            for f in ("value", "approx", "refined"):
                assert torch.equal(getattr(g, f), getattr(w, f)), f
                assert torch.equal(getattr(a, f), getattr(w, f)), f
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", ["dsum", "dmax", "dc2", "dn2", "lsum"])
def test_serving_replay_after_insert_sees_the_new_buffer(cuda, name):
    """An insert builds a new buffer object of the same signature: the
    cached graph is reused (no capture), its slots take the new buffer, and
    the replayed answers equal the eager path's on the new state."""
    from repro_torch.serve import ServingEngine
    s = _serve_session(cuda, seed=21, names=(name,))
    specs = _serve_specs(s, name, np.random.default_rng(4))
    eng = ServingEngine(s)
    try:
        before = eng.query(specs, timeout=300)
        c0 = eng.stats.aot_compiles
        rng = np.random.default_rng(5)
        agg = s.spec(name).agg
        if agg in ("count2d", "sum2d", "max2d", "min2d"):
            cols = (rng.uniform(0, 50, 32), rng.uniform(0, 50, 32))
            if agg != "count2d":
                cols += (rng.uniform(1, 6, 32),)
        else:
            cols = (rng.uniform(0, 100, 32),)
            if agg != "count":
                cols += (rng.uniform(20, 30, 32),)
        eng.insert(name, *cols, wait=True)
        after = eng.query(specs, timeout=300)
        assert eng.stats.aot_compiles == c0
        assert not all(torch.equal(a.value, b.value)
                       for a, b in zip(after, before))
        for g, w in zip(after, s.query(specs)):
            for f in ("value", "approx", "refined"):
                assert torch.equal(getattr(g, f), getattr(w, f)), f
    finally:
        eng.shutdown()


@pytest.mark.parametrize("name", ["dsum", "dc2", "lsum"])
def test_serving_swap_stages_and_promotes(cuda, name):
    """A merge (or compaction) captures the incoming plan's graphs on the
    merge thread before the install: the first dispatch after the swap
    promotes them, with zero new captures, and answers as the eager path
    does on the new plan."""
    from repro_torch.serve import ServingEngine
    s = _serve_session(cuda, seed=33, names=(name,))
    specs = _serve_specs(s, name, np.random.default_rng(6), n=100)
    eng = ServingEngine(s)
    try:
        eng.warmup(max_bucket=256)
        eng.query(specs, timeout=300)
        rng = np.random.default_rng(7)
        agg = s.spec(name).agg
        cols = ((rng.uniform(0, 50, 40), rng.uniform(0, 50, 40))
                if agg == "count2d" else (rng.uniform(0, 100, 40),)
                if agg == "count" else
                (rng.uniform(0, 100, 40), rng.uniform(0, 10, 40)))
        eng.insert(name, *cols, wait=True)
        c0, p0 = eng.stats.aot_compiles, eng.stats.aot_promotions
        eng.flush(name)
        assert eng.stats.aot_precompiles > 0 and not eng.stage_errors
        got = eng.query(specs, timeout=300)
        st = eng.stats
        assert st.aot_compiles == c0 and st.aot_promotions > p0
        for g, w in zip(got, s.query(specs)):
            for f in ("value", "approx", "refined"):
                assert torch.equal(getattr(g, f), getattr(w, f)), f
    finally:
        eng.shutdown()
