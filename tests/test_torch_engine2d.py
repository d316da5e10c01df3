"""repro_torch.engine's 2-D path against repro.engine's: twins of
tests/test_engine.py's 2-D cases and tests/test_locate.py's 2-D cases.

Reference plans (built once per module, 4,000 points, ``max_depth`` <= 7)
are carried into the port with ``plan2d_from_numpy``, so the query path is
held to the reference apart from construction (test_torch_index2d.py
holds construction).  The port's backends — ``torch`` (the quadtree
descent), ``ref`` (the one-hot oracles) and the plain versions of K7, K8,
K12 and K13 that the ``cuda`` backend runs on the card — agree with every
reference backend at rtol = atol = 1e-9 with equal ``refined`` flags, and
bit for bit with each other, as the reference's backends do; every
certified bound holds against exact truth computed with numpy.  Each plain
kernel version is held to its Pallas kernel in interpret mode."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import (build_index_2d as r_build,  # noqa: E402
                        query_count_2d as r_count, query_dommax_2d as r_dom,
                        query_sum_2d as r_sum)
from repro.engine import Engine as REngine, build_plan_2d as r_plan  # noqa: E402
from repro.kernels.leaf_eval2d import (  # noqa: E402
    corner_count2d_gather_pallas, corner_count2d_pallas,
    corner_eval2d_gather_pallas, corner_eval2d_pallas)
from repro_torch.core import build_index_2d  # noqa: E402
from repro_torch.engine import (Engine, build_plan_2d,  # noqa: E402
                                execute, execute_count2d, execute_sum2d,
                                pad_fills, raw_count2d, raw_eval2d)
from repro_torch.engine.plan import (ARRAY_FIELDS_2D,  # noqa: E402
                                     META_FIELDS_2D, plan2d_from_numpy)
from repro_torch.kernels import leaf_eval2d as k2d  # noqa: E402
from repro_torch.data import osm_points  # noqa: E402
from repro_torch.kernels.locate import (bsearch_count, dyadic_cuts,  # noqa: E402
                                        interleave2, leaf_morton_codes,
                                        search_tree)

TOL = dict(rtol=1e-9, atol=1e-9)
N = 4000
NQ = 256
DELTA = 25.0
PORT_BACKENDS = ("torch", "ref")
R_BACKENDS = ("xla", "pallas", "ref")


def port_plan(rplan, device="cpu"):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS_2D}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS_2D})
    return plan2d_from_numpy(fields, device)


def _measure(px, py):
    return 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)


@pytest.fixture(scope="module")
def setup():
    """The COUNT plan of tests/test_engine.py's plan2d fixture and the
    measure plans of its plans2d_measure fixture (4,000 points each), with
    rectangles and data-anchored dominance corners."""
    rng = np.random.default_rng(13)
    px = rng.uniform(0, 120, N)
    py = rng.uniform(0, 120, N)
    w = _measure(px, py)
    out = {}
    for agg, delta, depth in (("count2d", DELTA, 6), ("sum2d", 400.0, 7),
                              ("max2d", 4.0, 7), ("min2d", 4.0, 7)):
        idx = r_build(px, py, measures=None if agg == "count2d" else w,
                      agg=agg, deg=2, delta=delta, max_depth=depth)
        rplan = r_plan(idx)
        out[agg] = (idx, rplan, port_plan(rplan))
    qa = rng.uniform(0, 120, NQ)
    qc = rng.uniform(0, 120, NQ)
    rect = (qa, qa + rng.uniform(0.5, 40, NQ), qc, qc + rng.uniform(0.5, 40, NQ))
    ci = rng.integers(0, N, NQ)   # anchored at data points, so every
    corners = (px[ci], py[ci])    # corner dominates at least one record
    return px, py, w, out, rect, corners


_REF = {}


def ref_answer(setup, agg, backend, eps_rel):
    """The reference engine's QueryResult, computed once per run."""
    key = (agg, backend, eps_rel)
    if key not in _REF:
        _, _, _, plans, rect, corners = setup
        ranges = corners if agg in ("max2d", "min2d") else rect
        _REF[key] = REngine(backend=backend).query(plans[agg][1], *ranges,
                                                   eps_rel=eps_rel)
    return _REF[key]


def _ranges(setup, agg):
    _, _, _, _, rect, corners = setup
    return corners if agg in ("max2d", "min2d") else rect


def _truth(setup, agg):
    px, py, w, _, rect, corners = setup
    if agg in ("count2d", "sum2d"):
        m = np.ones(N) if agg == "count2d" else w
        return np.array([m[(px > a) & (px <= b) & (py > c) & (py <= d)].sum()
                         for a, b, c, d in zip(*rect)])
    u, v = corners
    dom = (px[None, :] <= u[:, None]) & (py[None, :] <= v[:, None])
    red = np.max if agg == "max2d" else np.min
    return np.array([red(w[d]) for d in dom])


def _raw_cuda_plain(plan, ranges):
    """The raw answer the 'cuda' backend computes, through the kernels'
    plain versions (CPU tensors)."""
    x0, x1, y0, y1 = plan.root
    t = [torch.as_tensor(r) for r in ranges]
    if len(t) == 4:
        c = (torch.clamp(t[0], x0, x1), torch.clamp(t[1], x0, x1),
             torch.clamp(t[2], y0, y1), torch.clamp(t[3], y0, y1))
        return raw_count2d(plan, *c, backend="cuda")
    return raw_eval2d(plan, torch.clamp(t[0], x0, x1),
                      torch.clamp(t[1], y0, y1), backend="cuda")


# ---------------------------------------------------------------------------
# certified bounds and cross-backend equivalence (tests/test_engine.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", ["count2d", "sum2d", "max2d", "min2d"])
def test_certified_bounds_2d(setup, agg, backend):
    """Lemma 6.3 (4 certified_delta for rectangles) and the dominance
    bound (certified_delta), on every port backend."""
    idx, _, plan = setup[3][agg]
    res = Engine(backend=backend).query(plan, *_ranges(setup, agg))
    bound = idx.certified_delta * (4 if agg in ("count2d", "sum2d") else 1)
    assert np.abs(res.answer.numpy() - _truth(setup, agg)).max() \
        <= bound + 1e-6


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "max2d", "min2d"])
def test_cross_backend_equivalence_2d(setup, agg):
    """The port's backends and the plain kernels behind 'cuda' agree bit
    for bit (one leaf rule, one Horner sequence), and with every reference
    backend at 1e-9."""
    _, _, plan = setup[3][agg]
    ranges = _ranges(setup, agg)
    outs = {b: Engine(backend=b).query(plan, *ranges).answer
            for b in PORT_BACKENDS}
    raw = _raw_cuda_plain(plan, ranges)
    outs["cuda"] = -raw if agg == "min2d" else raw
    for b in ("ref", "cuda"):
        torch.testing.assert_close(outs[b], outs["torch"], rtol=0, atol=0,
                                   msg=b)
    for rb in R_BACKENDS:
        want = np.asarray(ref_answer(setup, agg, rb, None).answer)
        np.testing.assert_allclose(outs["torch"].numpy(), want, **TOL,
                                   err_msg=rb)


@pytest.mark.parametrize("agg", ["count2d", "sum2d", "max2d", "min2d"])
def test_qrel_2d_fused(setup, agg):
    """Lemma 6.4 / 5.4 + the merge-sort-tree refinement on every port
    backend: answers within eps_rel of the truth, equal to the reference's
    with equal refined flags (its core query path, whose refinement every
    reference executor shares; compiling the executors' unrolled
    merge-sort-tree searches would take most of this file's time)."""
    eps_rel = 0.05
    idx, _, plan = setup[3][agg]
    query = {"count2d": r_count, "sum2d": r_sum}.get(agg, r_dom)
    want = query(idx, *_ranges(setup, agg), eps_rel=eps_rel)
    truth = _truth(setup, agg)
    pos = np.abs(truth) > 0
    for backend in PORT_BACKENDS:
        res = Engine(backend=backend).query(plan, *_ranges(setup, agg),
                                            eps_rel=eps_rel)
        np.testing.assert_allclose(res.answer.numpy(),
                                   np.asarray(want.answer), **TOL)
        np.testing.assert_array_equal(res.refined.numpy(),
                                      np.asarray(want.refined))
        rel = (np.abs(res.answer.numpy()[pos] - truth[pos])
               / np.abs(truth[pos]))
        assert rel.max() <= eps_rel + 1e-9, backend


def test_execute_dispatch_2d_aggs(setup):
    """`execute` routes IndexPlan2D by its agg; a mismatched executor
    refuses the plan; the pad fills are the root's lower corner."""
    _, _, _, plans, rect, corners = setup
    plan_s, plan_m = plans["sum2d"][2], plans["max2d"][2]
    r1 = execute(plan_s, rect, backend="ref")
    r2 = execute_sum2d(plan_s, *rect, backend="ref")
    torch.testing.assert_close(r1.answer, r2.answer, rtol=0, atol=0)
    r3 = execute(plan_m, corners, backend="ref")
    assert r3.answer.shape == corners[0].shape
    with pytest.raises(ValueError, match="count2d"):
        execute_count2d(plan_s, *rect)
    x0, _, y0, _ = plan_s.root
    assert pad_fills(plan_s) == (x0, x0, y0, y0)
    assert pad_fills(plan_m) == (x0, y0)


@pytest.mark.parametrize("nq", [3, 130])
def test_batch_bucketing_2d(setup, nq):
    """Padding to power-of-two buckets changes no answer."""
    _, _, plan = setup[3]["count2d"]
    full = Engine(backend="torch").query(plan, *setup[4]).answer
    part = Engine(backend="torch").query(
        plan, *(r[:nq] for r in setup[4])).answer
    assert part.shape == (nq,)
    torch.testing.assert_close(part, full[:nq], rtol=0, atol=0)


def test_plan_parity(setup):
    """The port lowers its own index to the reference's plan: every array
    field equal."""
    px, py, _, plans, _, _ = setup
    ridx, rplan, _ = plans["count2d"]
    plan = build_plan_2d(build_index_2d(px, py, deg=2, delta=DELTA,
                                        max_depth=6, device="cpu"))
    for f in ARRAY_FIELDS_2D:
        a, b = getattr(plan, f), getattr(rplan, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    assert plan.size_bytes() == rplan.size_bytes()
    assert plan.device_bytes() == sum(
        np.asarray(getattr(rplan, f)).nbytes for f in ARRAY_FIELDS_2D
        if getattr(rplan, f) is not None)


@pytest.mark.parametrize("source", ["plan2d_from_numpy", "build_plan_2d"])
def test_plans_carry_the_x_search_tree(setup, source):
    """Plans carried across from the reference and plans the port lowers
    from its own index carry ``ref_xs_tree``, the search tree of their
    ``ref_xs`` (K1's), counted by ``tree_bytes`` only."""
    px, py, w, plans, _, _ = setup
    for agg, (_, rplan, plan) in plans.items():
        if source == "build_plan_2d":
            plan = build_plan_2d(build_index_2d(
                px, py, measures=None if agg == "count2d" else w, agg=agg,
                deg=2, delta=plan.delta, max_depth=plan.max_depth,
                device="cpu"))
        want = search_tree(plan.ref_xs)
        assert torch.equal(plan.ref_xs_tree.nan_to_num(-1.0),
                           want.nan_to_num(-1.0)), agg
        assert plan.ref_xs.data_ptr() % 16 == 0
        np.testing.assert_array_equal(plan.ref_xs.numpy(),
                                      np.asarray(rplan.ref_xs))
        assert plan.tree_bytes() == want.numel() * 8 > 0


# ---------------------------------------------------------------------------
# split lines and the Morton table (tests/test_locate.py)
# ---------------------------------------------------------------------------

def test_gather_bit_identical_on_split_lines_2d():
    """Corners exactly on split lines and on the root's edges: the plain
    K7 equals the plain K12 equals 'ref', bit for bit, and the reference's
    gather kernel at 1e-9."""
    rng = np.random.default_rng(9)
    px = rng.uniform(0, 120, N)
    py = rng.uniform(0, 120, N)
    rplan = r_plan(r_build(px, py, deg=2, delta=20.0, max_depth=5))
    plan = port_plan(rplan)
    assert plan.leaf_z is not None
    xc = plan.xcuts.numpy()
    yc = plan.ycuts.numpy()
    x0, x1, y0, y1 = plan.root
    lx = np.concatenate([xc, [x0, x0, x1], rng.uniform(0, 120, 29)])
    ux = np.concatenate([xc + 1.0, [x1, x0, x1], rng.uniform(0, 120, 29)])
    ly = np.concatenate([yc, [y0, y1, y0], rng.uniform(0, 120, 29)])
    uy = np.concatenate([yc + 1.0, [y1, y1, y1], rng.uniform(0, 120, 29)])
    lx, ux = np.minimum(lx, ux), np.maximum(lx, ux)
    ly, uy = np.minimum(ly, uy), np.maximum(ly, uy)
    c = [torch.clamp(torch.as_tensor(q), lo, hi) for q, lo, hi in
         ((lx, x0, x1), (ux, x0, x1), (ly, y0, y1), (uy, y0, y1))]
    gather = k2d.corner_count2d_gather_plain(
        *c, plan.xcuts, plan.ycuts, plan.leaf_z, plan.leaf_bounds,
        plan.leaf_coeffs, plan.deg, plan.max_depth)
    scan = k2d.corner_count2d_plain(
        *c, plan.leaf_mx0, plan.leaf_mx1, plan.leaf_my0, plan.leaf_my1,
        plan.leaf_bounds, plan.leaf_coeffs, plan.deg)
    ref = raw_count2d(plan, *c, backend="ref")
    torch.testing.assert_close(gather, scan, rtol=0, atol=0)
    torch.testing.assert_close(gather, ref, rtol=0, atol=0)
    for b in ("torch", "ref"):
        got = Engine(backend=b).count2d(plan, lx, ux, ly, uy).answer
        torch.testing.assert_close(got, gather, rtol=0, atol=0)
    want = REngine(backend="pallas").count2d(rplan, lx, ux, ly, uy).answer
    np.testing.assert_allclose(gather.numpy(), np.asarray(want), **TOL)


def test_morton_leaf_table_is_sorted_and_disjoint():
    rng = np.random.default_rng(11)
    plan = build_plan_2d(build_index_2d(
        rng.uniform(0, 50, 3000), rng.uniform(0, 50, 3000), deg=2,
        delta=15.0, max_depth=4, device="cpu"))
    z = plan.leaf_z.numpy()[: plan.n_leaves]
    assert np.all(np.diff(z) > 0), "leaf z-interval starts must be sorted"
    assert z[0] == 0, "the first leaf must cover Morton cell 0"
    assert np.all(plan.leaf_z.numpy()[plan.n_leaves:] == np.iinfo(np.int32).max)
    cuts = dyadic_cuts(*map(float, plan.root[:2]), plan.max_depth)
    assert len(cuts) == (1 << plan.max_depth) - 1


def _cut_rank_guess(c, q):
    """csrc/locate.cuh cut_rank_guess in torch: the count of cuts <= q from
    a guess off the end cuts, accepted when c[g - 1] <= q < c[g] (the ends
    open), stepped toward q at most twice, else the binary search."""
    n = c.shape[0]
    if n <= 2:
        return bsearch_count(c, q, side="right").long()
    t = (q - c[0]) * ((n - 1) / (c[n - 1] - c[0]))
    inside = (t >= 0) & (t < n - 1)
    g = torch.where(inside, torch.where(inside, t, 0.0).long() + 1,
                    torch.where(t >= 0, n, 0))
    rank = torch.zeros_like(g)
    done = torch.zeros_like(q, dtype=torch.bool)
    for _ in range(3):
        lo_ok = (g == 0) | (c[(g - 1).clamp(0, n - 1)] <= q)
        hi_ok = (g == n) | (q < c[g.clamp(0, n - 1)])
        ok = lo_ok & hi_ok & ~done
        rank = torch.where(ok, g, rank)
        done |= ok
        g = torch.where(done, g, g + torch.where(lo_ok, 1, -1))
    return torch.where(done, rank,
                       bsearch_count(c, q, side="right").long())


# roots of awkward span and origin, and the depths K7's cut grids take
_CUT_ROOTS = ((0.0, 1.0), (-1000.37, -0.37), (123.456, 123.456 + 1e-6),
              (-7.5, 992.5), (-3e-4, 7e-4))


@pytest.mark.parametrize("case", ["depth0", "depth1", "depth12", "depth15",
                                  "plans"])
def test_cut_rank_guess_matches_search(request, case):
    """K7's checked-guess cut rank equals the binary search in every lane,
    on sorted cut grids: dyadic_cuts at depths 0 (the plan's one-sentinel
    grid), 1, 12 and 15 over awkward roots, and the plans' own grids;
    corners on every cut and one ulp either side, the root's edges, NaN,
    +-inf and uniform draws."""
    big = float(np.finfo(np.float64).max) / 4
    rng = np.random.default_rng(23)
    grids = []
    if case == "plans":
        plans = request.getfixturevalue("setup")[3]
        grids = [(p.root[a], p.root[a + 1], getattr(p, f).numpy())
                 for _, _, p in plans.values()
                 for a, f in ((0, "xcuts"), (2, "ycuts"))]
    else:
        depth = int(case[5:])
        for lo, hi in _CUT_ROOTS:
            c = dyadic_cuts(lo, hi, depth)
            grids.append((lo, hi, c if len(c) else np.array([big])))
    for lo, hi, c in grids:
        assert np.all(np.diff(c) >= 0), "cut grids must be sorted"
        q = np.concatenate([c, np.nextafter(c, -np.inf),
                            np.nextafter(c, np.inf), [lo, hi, np.nan,
                                                      np.inf, -np.inf],
                            rng.uniform(lo, hi, 4096)])
        ct, qt = torch.as_tensor(c), torch.as_tensor(q)
        want = bsearch_count(ct, qt, side="right").long()
        assert torch.equal(_cut_rank_guess(ct, qt), want)


def _morton2(ix, iy, depth):
    """csrc/locate.cuh morton2 in torch: each rank's bits below ``depth``
    spread to the even bits by shifts and masks, x even and y odd."""
    def spread(t):
        t = t & 0xFFFF
        for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F),
                            (2, 0x33333333), (1, 0x55555555)):
            t = (t | (t << shift)) & mask
        return t
    m = (1 << depth) - 1
    return (spread(ix.long() & m) | (spread(iy.long() & m) << 1)).int()


def _k8_pair_form(u, v, xcuts, ycuts, leaf_z, bounds, coeffs, deg, depth):
    """csrc/leaf_eval2d.cu K8 in torch: each coordinate ranked by the
    checked guess (lane 0 x, lane 1 y), the cell's Morton code by
    morton2, the code searched in the z-sorted table and clamped to 0,
    then the row split over the pair (leaf_value_pair): row i's inner
    Horner in v from 0, computed by lane i % 2, and lane 0's outer Horner
    in u in the plain order over rows deg .. 0."""
    ix, iy = _cut_rank_guess(xcuts, u), _cut_rank_guess(ycuts, v)
    z = _morton2(ix, iy, depth)
    leaf = torch.clamp(bsearch_count(leaf_z, z, side="right") - 1,
                       min=0).long()
    b, c = bounds[leaf], coeffs[leaf]
    span_y = torch.where(b[:, 3] > b[:, 2], b[:, 3] - b[:, 2], 1.0)
    vs = torch.clamp((2.0 * v - b[:, 2] - b[:, 3]) / span_y, -1.0, 1.0)
    inner = []
    for i in range(deg + 1):     # lane i % 2 computes row i
        acc = torch.zeros_like(vs)
        for j in range(deg, -1, -1):
            acc = acc * vs + c[:, i * (deg + 1) + j]
        inner.append(acc)
    span_x = torch.where(b[:, 1] > b[:, 0], b[:, 1] - b[:, 0], 1.0)
    us = torch.clamp((2.0 * u - b[:, 0] - b[:, 1]) / span_x, -1.0, 1.0)
    acc = torch.zeros_like(us)
    for i in range(deg, -1, -1):     # lane 0, the odd rows shuffled in
        acc = acc * us + inner[i]
    return acc


@pytest.mark.parametrize("depth", [0, 1, 12, 15])
def test_morton2_matches_leaf_codes(depth):
    """K7's and K8's Morton code by bit operations (morton2) equals the
    loop a bit (interleave2) and the code leaf_morton_codes gives a leaf
    of that cell, at depths 0, 1, 12 and 15 (the int32 limit)."""
    rng = np.random.default_rng(depth)
    m = 1 << depth
    ix = np.concatenate([[0, m - 1, 0, m - 1], rng.integers(0, m, 2000)])
    iy = np.concatenate([[0, 0, m - 1, m - 1], rng.integers(0, m, 2000)])
    xc, yc = dyadic_cuts(-7.5, 992.5, depth), dyadic_cuts(3.0, 4.0, depth)
    gx = np.concatenate([[-7.5], xc, [992.5]])
    gy = np.concatenate([[3.0], yc, [4.0]])
    b = np.stack([gx[ix], gx[ix + 1], gy[iy], gy[iy + 1]], axis=1)
    want = torch.as_tensor(leaf_morton_codes(b, xc, yc, depth))
    tx, ty = torch.as_tensor(ix), torch.as_tensor(iy)
    got = _morton2(tx, ty, depth)
    assert torch.equal(got, want)
    assert torch.equal(got, interleave2(tx.int(), ty.int(), depth))


@pytest.fixture(scope="module")
def k8_plans(setup):
    """Plans K8's form is held on: COUNT at deg 1 and 3 (the port's build
    over 1,500 OSM-like points, 6 levels), the module's COUNT (deg 2) and
    MAX plans, and a depth-0 plan (the root the only leaf)."""
    px, py = osm_points(1500, seed=29)
    plans = {("count2d", deg): build_plan_2d(build_index_2d(
        px, py, deg=deg, delta=20.0, max_depth=6, device="cpu"))
        for deg in (1, 3)}
    plans["count2d", 2] = setup[3]["count2d"][2]
    plans["max2d", 2] = setup[3]["max2d"][2]
    plans["depth0", 2] = build_plan_2d(build_index_2d(
        px, py, deg=2, delta=20.0, max_depth=0, device="cpu"))
    return plans


@pytest.mark.parametrize("key", [("count2d", 1), ("count2d", 2),
                                 ("count2d", 3), ("max2d", 2),
                                 ("depth0", 2)], ids=str)
def test_k8_pair_form_matches_plain(k8_plans, key):
    """K8's form (checked-guess ranks, morton2, the code search and its
    clamp, the row split over a pair of lanes and combined by one outer
    Horner) equals corner_eval2d_gather_plain bit for bit, NaN as NaN: on
    corners on every split line and one ulp either side, the root's
    edges and corners, uniform draws over the root, and NaN and +-inf
    coordinates."""
    plan = k8_plans[key]
    x0, x1, y0, y1 = plan.root
    xc, yc = plan.xcuts.numpy(), plan.ycuts.numpy()
    if plan.max_depth == 0:
        xc, yc = np.array([x0, x1]), np.array([y0, y1])
    rng = np.random.default_rng(31)
    edges = lambda c, lo, hi: np.concatenate(
        [c, np.nextafter(c, -np.inf), np.nextafter(c, np.inf), [lo, hi]])
    ex, ey = edges(xc, x0, x1), edges(yc, y0, y1)
    n = max(len(ex), len(ey))
    u = np.concatenate([np.resize(ex, n), rng.permutation(np.resize(ex, n)),
                        rng.uniform(x0, x1, 3000),
                        [np.nan, 0.5 * (x0 + x1), np.nan, np.inf, -np.inf,
                         x0, np.inf, -np.inf]])
    v = np.concatenate([rng.permutation(np.resize(ey, n)), np.resize(ey, n),
                        rng.uniform(y0, y1, 3000),
                        [0.5 * (y0 + y1), np.nan, np.nan, y0, y1, np.inf,
                         -np.inf, np.inf]])
    args = (torch.as_tensor(u), torch.as_tensor(v), plan.xcuts, plan.ycuts,
            plan.leaf_z, plan.leaf_bounds, plan.leaf_coeffs, plan.deg,
            plan.max_depth)
    want = k2d.corner_eval2d_gather_plain(*args)
    got = _k8_pair_form(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(want).any() and not torch.isnan(want[:-8]).any()


# ---------------------------------------------------------------------------
# the plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["K7", "K8", "K12", "K13"])
def test_plain_kernels_match_pallas(setup, kernel):
    """Each plain version of K7, K8, K12 and K13 against its Pallas kernel
    in interpret mode, on the reference plan's own table and clamped
    corners; the wrapper runs the plain version on CPU tensors and counts
    no launch."""
    agg = "sum2d" if kernel in ("K7", "K12") else "max2d"
    _, rplan, plan = setup[3][agg]
    x0, x1, y0, y1 = plan.root
    if agg == "sum2d":
        lim = ((x0, x1), (x0, x1), (y0, y1), (y0, y1))
        q = [np.clip(r, lo, hi) for r, (lo, hi) in zip(setup[4], lim)]
    else:
        q = [np.clip(setup[5][0], x0, x1), np.clip(setup[5][1], y0, y1)]
    rq = [jnp.asarray(a) for a in q]
    tq = [torch.as_tensor(a) for a in q]
    gather = ("xcuts", "ycuts", "leaf_z", "leaf_bounds", "leaf_coeffs")
    scan = ("leaf_mx0", "leaf_mx1", "leaf_my0", "leaf_my1", "leaf_bounds",
            "leaf_coeffs")
    deg, depth = plan.deg, plan.max_depth
    if kernel in ("K7", "K8"):
        rt = [getattr(rplan, f) for f in gather]
        pt = [getattr(plan, f) for f in gather]
        if kernel == "K7":
            want = corner_count2d_gather_pallas(*rq, *rt, deg=deg,
                                                depth=depth, bq=128)
            fn, plain = k2d.corner_count2d_gather, \
                k2d.corner_count2d_gather_plain
        else:
            want = corner_eval2d_gather_pallas(*rq, *rt, deg=deg,
                                               depth=depth, bq=128)
            fn, plain = k2d.corner_eval2d_gather, \
                k2d.corner_eval2d_gather_plain
        args = (*tq, *pt, deg, depth)
    else:
        rt = [getattr(rplan, f) for f in scan]
        pt = [getattr(plan, f) for f in scan]
        if kernel == "K12":
            want = corner_count2d_pallas(*rq, *rt, deg=deg, bq=128,
                                         bh=rplan.bh)
            fn, plain = k2d.corner_count2d, k2d.corner_count2d_plain
        else:
            want = corner_eval2d_pallas(*rq, *rt, deg=deg, bq=128,
                                        bh=rplan.bh)
            fn, plain = k2d.corner_eval2d, k2d.corner_eval2d_plain
        args = (*tq, *pt, deg)
    got = plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    before = fn.launches
    torch.testing.assert_close(fn(*args), got, rtol=0, atol=0)
    assert fn.launches == before


def test_deep_plan_routes_to_scan_twins():
    """A plan deeper than 15 levels has no Morton table: the 'cuda'
    backend's raw path is the scan (K12/K13 plain versions), equal to the
    descent bit for bit and to the reference's pallas path (its scan
    kernels) at 1e-9."""
    rng = np.random.default_rng(21)
    px = rng.uniform(0, 120, 3000)
    py = rng.uniform(0, 120, 3000)
    w = _measure(px, py)
    rplan_c = r_plan(r_build(px, py, deg=2, delta=20.0, max_depth=16))
    rplan_m = r_plan(r_build(px, py, measures=w, agg="min2d", deg=2,
                             delta=4.0, max_depth=16))
    qa, qc = rng.uniform(0, 110, 200), rng.uniform(0, 110, 200)
    rect = (qa, qa + rng.uniform(1, 30, 200), qc, qc + rng.uniform(1, 30, 200))
    ci = rng.integers(0, 3000, 200)
    for rplan, ranges in ((rplan_c, rect), (rplan_m, (px[ci], py[ci]))):
        plan = port_plan(rplan)
        assert plan.leaf_z is None and plan.xcuts is None
        raw = _raw_cuda_plain(plan, ranges)
        x0, x1, y0, y1 = plan.root
        descent = Engine(backend="torch").query(plan, *ranges).approx
        torch.testing.assert_close(-raw if plan.agg == "min2d" else raw,
                                   descent, rtol=0, atol=0)
        want = REngine(backend="pallas").query(rplan, *ranges).approx
        np.testing.assert_allclose(descent.numpy(), np.asarray(want), **TOL)
