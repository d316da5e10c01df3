"""repro_torch's dynamic two-key tables against repro's: twins of the 2-D
cases of tests/test_dynamic.py, of
tests/test_locate.py::test_dynamic2d_empty_and_single_entry_buffers and of
the selective-refit cases of tests/test_index2d.py.

The same op sequence goes to ``repro.engine.DynamicEngine2D`` and
``repro_torch.engine.DynamicEngine2D`` (the reference index carried across
with ``index2d_from_numpy``), port backend ``torch`` against the
reference's ``xla`` and ``ref`` against ``ref``; the port's ``cuda`` path
runs here through the plain versions of K7-K11 (the wrappers take them on
CPU tensors) against the reference's ``xla``.  Answers, raw answers and
``refined`` flags agree at rtol = atol = 1e-9, ``refit_count`` and
``last_refit_stats`` are equal, merged indexes agree node for node, and
every certified bound holds against exact truth computed with numpy.  The
plain versions of K9, K10 and K11 are held to the Pallas kernels in
interpret mode (K9 and K11 exactly, K10 to 1e-12), the port's append to
the reference's, and ``selective_refit_2d`` to the reference's node for
node.  Indexes hold 3,000-4,000 points; buffers 64-128 slots.
"""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_2d as r_build  # noqa: E402
from repro.core import selective_refit_2d as r_refit  # noqa: E402
from repro.engine import DynamicEngine2D as RDyn  # noqa: E402
from repro.engine.dynamic import _append_2d as r_append_2d  # noqa: E402
from repro.kernels.delta_scan import (  # noqa: E402
    delta_count2d_gather_pallas, delta_dommax2d_gather_pallas,
    delta_sum2d_gather_pallas)
from repro_torch.core import (index2d_from_numpy, query_sum_2d,  # noqa: E402
                              selective_refit_2d)
from repro_torch.engine import DeltaBuffer2D, DynamicEngine2D  # noqa: E402
from repro_torch.engine.dynamic import _append_2d  # noqa: E402
from repro_torch.kernels import delta_scan as kd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
DELTA = 25.0
# port backend -> the reference backend it is held to; 'cuda' runs the
# kernels' plain versions on CPU tensors
TWIN = {"torch": "xla", "ref": "ref", "cuda": "xla"}
PORT_BACKENDS = ("torch", "ref", "cuda")


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


def _pair(ridx, backend, **kw):
    """(reference engine on the twin backend, port engine on ``backend``)
    over the same index."""
    kw.setdefault("capacity", 128)
    kw.setdefault("auto_refit", False)
    r = RDyn(ridx, backend=TWIN[backend], **kw)
    p = DynamicEngine2D(_carry(ridx),
                        backend="torch" if backend == "cuda" else backend,
                        **kw)
    if backend == "cuda":
        # the 'cuda' path on the CPU: merge-sort-tree levels on append, and
        # K7-K11 through the plain versions their wrappers run on CPU
        # tensors (an empty buffer's sentinel levels are already right)
        p.backend = "cuda"
    return r, p


def _same(got, want):
    np.testing.assert_allclose(got.answer.numpy(), np.asarray(want.answer),
                               **TOL)
    np.testing.assert_allclose(got.approx.numpy(), np.asarray(want.approx),
                               **TOL)
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))


def _same_index(got, want):
    """Merged indexes node for node: topology exactly, fits to 1e-9."""
    for f in ("children", "leaf_of", "bounds", "leaf_nodes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs),
                               **TOL)
    np.testing.assert_allclose(got.leaf_err, want.leaf_err, **TOL)
    assert got.extremal_floor == want.extremal_floor
    assert got.n == want.n


def _rect_truth(mx, my, mw, rect):
    return np.array([mw[(mx > a) & (mx <= b) & (my > c) & (my <= d)].sum()
                     for a, b, c, d in zip(*rect)])


def _dom_truth(mx, my, mw, u, v, agg):
    dom = (mx[None, :] <= u[:, None]) & (my[None, :] <= v[:, None])
    red = np.max if agg == "max2d" else np.min
    return np.array([red(mw[d]) for d in dom])


# ---------------------------------------------------------------------------
# fixtures: the reference tests' data, indexes built once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def count_setup():
    """tests/test_dynamic.py's dyn2d_setup."""
    rng = np.random.default_rng(13)
    px = rng.uniform(0, 120, 4000)
    py = rng.uniform(0, 120, 4000)
    idx = r_build(px, py, deg=2, delta=DELTA, max_depth=6)
    ins_x = rng.uniform(0, 120, 48)
    ins_y = rng.uniform(0, 120, 48)
    del_i = rng.integers(0, 4000, 16)
    qa = rng.uniform(0, 120, 128)
    qb = qa + rng.uniform(0.5, 40, 128)
    qc = rng.uniform(0, 120, 128)
    qd = qc + rng.uniform(0.5, 40, 128)
    keep = np.ones(4000, bool)
    keep[del_i] = False
    mx = np.concatenate([px[keep], ins_x])
    my = np.concatenate([py[keep], ins_y])
    truth = _rect_truth(mx, my, np.ones(len(mx)), (qa, qb, qc, qd))
    return px, py, idx, (ins_x, ins_y, px[del_i], py[del_i]), \
        (qa, qb, qc, qd), truth


@pytest.fixture(scope="module")
def wsetup():
    """tests/test_dynamic.py's dyn2dw_setup, with its indexes built once
    (``idx(agg, delta, max_depth)``)."""
    rng = np.random.default_rng(0x2DD)
    n = 3000
    px = rng.uniform(0, 100, n)
    py = rng.uniform(0, 100, n)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    ins = (rng.uniform(5, 95, 40), rng.uniform(5, 95, 40),
           rng.uniform(30, 70, 40))
    del_i = rng.integers(0, n, 12)
    rect = (rng.uniform(0, 75, 96), None, rng.uniform(0, 75, 96), None)
    rect = (rect[0], rect[0] + rng.uniform(5, 25, 96),
            rect[2], rect[2] + rng.uniform(5, 25, 96))
    ci = rng.integers(0, n, 96)
    corners = (px[ci], py[ci])
    keep = np.ones(n, bool)
    keep[del_i] = False
    merged = (np.concatenate([px[keep], ins[0]]),
              np.concatenate([py[keep], ins[1]]),
              np.concatenate([w[keep], ins[2]]))
    cache = {}

    def idx(agg, delta, depth):
        if (agg, delta, depth) not in cache:
            cache[agg, delta, depth] = r_build(
                px, py, measures=None if agg == "count2d" else w, agg=agg,
                deg=2, delta=delta, max_depth=depth)
        return cache[agg, delta, depth]

    return px, py, w, ins, del_i, rect, corners, merged, idx


# ---------------------------------------------------------------------------
# COUNT rectangles (tests/test_dynamic.py:293, 341, 351)
# ---------------------------------------------------------------------------

def test_2d_duplicate_delete_of_single_point_raises(count_setup):
    px, py, idx, _, _, _ = count_setup
    r, p = _pair(idx, "torch", capacity=64)
    x, y = float(px[0]), float(py[0])
    for dyn in (r, p):
        with pytest.raises(KeyError):
            dyn.delete([x, x], [y, y])   # one live occurrence, two tombstones
    assert p.n_pending == 0


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_2d_bounds_after_updates(count_setup, backend):
    """4 delta holds over the updated dataset while the ops sit in the
    buffer, and the port answers as the reference does."""
    px, py, idx, (ix, iy, dx, dy), q, truth = count_setup
    r, p = _pair(idx, backend)
    for dyn in (r, p):
        dyn.insert(ix, iy)
        dyn.delete(dx, dy)
    got = p.count2d(*q)
    _same(got, r.count2d(*q))
    assert np.abs(got.answer.numpy() - truth).max() <= 4 * DELTA + 1e-6
    assert p.n_pending == 64 and p.refit_count == 0


def test_2d_cross_backend_and_flush(count_setup):
    """Every port backend equal bit for bit before the flush (integer
    counts); the flush refits as the reference's does, node for node, and
    the bound holds after it."""
    px, py, idx, (ix, iy, dx, dy), q, truth = count_setup
    outs = {}
    for b in PORT_BACKENDS:
        r, p = _pair(idx, b)
        for dyn in (r, p):
            dyn.insert(ix, iy)
            dyn.delete(dx, dy)
        outs[b] = p.count2d(*q).answer
    for b in ("ref", "cuda"):
        torch.testing.assert_close(outs[b], outs["torch"], rtol=0, atol=0,
                                   msg=b)
    r.flush()
    p.flush()
    assert p.refit_count == r.refit_count == 1 and p.n_pending == 0
    assert p.last_refit_stats == r.last_refit_stats
    _same_index(p.index, r.index)
    got = p.count2d(*q)
    _same(got, r.count2d(*q))
    assert np.abs(got.answer.numpy() - truth).max() <= 4 * DELTA + 1e-6


def test_2d_count_qrel_after_updates(count_setup):
    """Lemma 6.4 with the exact correction: the port's Q_rel answers and
    refined flags equal the reference's on 'torch' and on the 'cuda' path
    (K1 for the x-ranks, K7, K9), and stay within eps_rel of the truth."""
    px, py, idx, (ix, iy, dx, dy), q, truth = count_setup
    want = None
    for b in ("torch", "cuda"):
        r, p = _pair(idx, b)
        for dyn in ((p,) if want is not None else (r, p)):
            dyn.insert(ix, iy)
            dyn.delete(dx, dy)
        if want is None:
            want = r.count2d(*q, eps_rel=0.05)
        got = p.count2d(*q, eps_rel=0.05)
        _same(got, want)
        pos = truth > 0
        rel = np.abs(got.answer.numpy()[pos] - truth[pos]) / truth[pos]
        assert rel.max() <= 0.05 + 1e-9, b


def test_dynamic2d_empty_and_single_entry_buffers():
    """tests/test_locate.py:231: an empty and a one-entry buffer answer
    alike on every backend, integer counts bit for bit."""
    rng = np.random.default_rng(23)
    px = rng.uniform(0, 80, 2500)
    py = rng.uniform(0, 80, 2500)
    idx = r_build(px, py, deg=2, delta=20.0, max_depth=5)
    qa = rng.uniform(0, 80, 64)
    qb = qa + rng.uniform(0.5, 30, 64)
    qc = rng.uniform(0, 80, 64)
    qd = qc + rng.uniform(0.5, 30, 64)
    first = None
    for b in PORT_BACKENDS:
        r, p = _pair(idx, b, capacity=64)
        r0, p0 = r.count2d(qa, qb, qc, qd), p.count2d(qa, qb, qc, qd)
        for dyn in (r, p):
            dyn.insert(np.array([40.0]), np.array([40.0]))
        r1, p1 = r.count2d(qa, qb, qc, qd), p.count2d(qa, qb, qc, qd)
        _same(p0, r0)
        _same(p1, r1)
        if first is None:
            first = (p0.answer, p1.answer)
        else:
            torch.testing.assert_close(p0.answer, first[0], rtol=0, atol=0)
            torch.testing.assert_close(p1.answer, first[1], rtol=0, atol=0)
    inside = (qa < 40) & (40 <= qb) & (qc < 40) & (40 <= qd)
    np.testing.assert_array_equal(
        (first[1] - first[0]).numpy(), inside.astype(np.float64))


# ---------------------------------------------------------------------------
# measure aggregates (tests/test_dynamic.py:422-609)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_2d_sum_bounds_after_updates(wsetup, backend):
    px, py, w, ins, del_i, rect, _, merged, idx = wsetup
    ridx = idx("sum2d", 400.0, 7)
    r, p = _pair(ridx, backend)
    for dyn in (r, p):
        dyn.insert(*ins)
        dyn.delete(px[del_i], py[del_i])
    got = p.sum2d(*rect)
    _same(got, r.sum2d(*rect))
    assert np.abs(got.answer.numpy() - _rect_truth(*merged, rect)).max() \
        <= 4 * ridx.certified_delta + 1e-6


@pytest.mark.parametrize("agg", ["max2d", "min2d"])
def test_2d_extremum_bounds_after_inserts(wsetup, agg):
    """Inserts only: the K11 correction ('cuda') and the dense oracle
    ('torch', 'ref') answer as the reference does, within delta."""
    px, py, w, ins, _, _, (u, v), _, idx = wsetup
    ridx = idx(agg, 4.0, 7)
    mx, my = np.concatenate([px, ins[0]]), np.concatenate([py, ins[1]])
    truth = _dom_truth(mx, my, np.concatenate([w, ins[2]]), u, v, agg)
    outs = []
    for b in PORT_BACKENDS:
        r, p = _pair(ridx, b)
        for dyn in (r, p):
            dyn.insert(*ins)
        got = p.extremum2d(u, v)
        _same(got, r.extremum2d(u, v))
        outs.append(got.answer)
        assert np.abs(got.answer.numpy() - truth).max() \
            <= ridx.certified_delta + 1e-6
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)


def test_2d_sum_cross_backend_and_flush(wsetup):
    px, py, w, ins, del_i, rect, _, merged, idx = wsetup
    ridx = idx("sum2d", 400.0, 7)
    outs = {}
    for b in PORT_BACKENDS:
        r, p = _pair(ridx, b)
        for dyn in (r, p):
            dyn.insert(*ins)
            dyn.delete(px[del_i], py[del_i])
        outs[b] = p.sum2d(*rect).answer
    for b in ("ref", "cuda"):
        torch.testing.assert_close(outs[b], outs["torch"], **TOL, msg=b)
    r.flush()
    p.flush()
    assert p.refit_count == r.refit_count == 1 and p.n_pending == 0
    stats = p.last_refit_stats
    assert stats == r.last_refit_stats
    assert not stats["rebuild"] and 0 < stats["refit"] < stats["n_leaves"]
    _same_index(p.index, r.index)
    got = p.sum2d(*rect)
    _same(got, r.sum2d(*rect))
    assert np.abs(got.answer.numpy() - _rect_truth(*merged, rect)).max() \
        <= 4 * p.index.certified_delta + 1e-6


def test_2d_selective_refit_leaves_far_leaves_alone(wsetup):
    """After a one-point merge, leaves outside its dominance boundary keep
    their coefficient rows bit for bit and wholly dominated ones shift only
    in the constant term, in the port as in the reference."""
    px, py, w, _, _, _, _, _, idx = wsetup
    ridx = idx("sum2d", 400.0, 7)
    r, p = _pair(ridx, "torch", capacity=64)
    x0, y0, wv = 70.0, 65.0, 55.0
    for dyn in (r, p):
        dyn.insert([x0], [y0], [wv])
        dyn.flush()
    stats = p.last_refit_stats
    assert stats == r.last_refit_stats and not stats["rebuild"]
    assert stats["refit"] < stats["n_leaves"] // 4
    _same_index(p.index, r.index)
    lb = np.asarray(ridx.bounds)[np.asarray(ridx.leaf_nodes)]
    old_c = np.asarray(ridx.coeffs)
    new_lb = p.index.bounds.numpy()[p.index.leaf_nodes.numpy()]
    new_c = p.index.coeffs.numpy()
    n_same = n_shift = 0
    for i, b in enumerate(lb):
        untouched = b[1] < x0 or b[3] < y0
        dominated = b[0] >= x0 and b[2] >= y0
        if not (untouched or dominated):
            continue
        j = int(np.where((new_lb == b).all(axis=1))[0][0])
        if untouched:
            np.testing.assert_array_equal(old_c[i], new_c[j])
            n_same += 1
        else:
            assert new_c[j][0] == old_c[i][0] + wv
            np.testing.assert_array_equal(old_c[i][1:], new_c[j][1:])
            n_shift += 1
    assert n_same > 0 and n_shift > 0


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_2d_extremum_delete_shadows_victim_without_merge(wsetup, backend):
    """A dominance-MAX delete never merges on the write path: it shadows
    its victim, corners dominating it refine against the victim-masked
    tree (answers and refined flags as the reference's), and the next
    merge removes it and clears the mask."""
    px, py, w, _, _, _, (u, v), _, idx = wsetup
    ridx = idx("max2d", 4.0, 7)
    r, p = _pair(ridx, backend, capacity=64)
    victim = int(np.argmax(w))
    for dyn in (r, p):
        dyn.delete(px[victim], py[victim])
    assert p.refit_count == 0 and p.n_pending == 1
    _, buf = p.snapshot()
    assert buf.vic_x is not None and buf.live_wpmax is not None
    keep = np.ones(len(px), bool)
    keep[victim] = False
    truth = _dom_truth(px[keep], py[keep], w[keep], u, v, "max2d")
    for eps_rel in (None, 0.05):
        got = p.extremum2d(u, v, eps_rel=eps_rel)
        _same(got, r.extremum2d(u, v, eps_rel=eps_rel))
        assert np.abs(got.answer.numpy() - truth).max() \
            <= p.index.certified_delta + 1e-6
    refined = got.refined.numpy()
    assert refined.any()
    np.testing.assert_allclose(got.answer.numpy()[refined], truth[refined],
                               **TOL)
    for dyn in (r, p):
        dyn.flush()
    assert p.n_pending == 0 and p.refit_count == 1
    assert p.last_refit_stats == r.last_refit_stats
    assert p.snapshot()[1].vic_x is None
    _same_index(p.index, r.index)
    got = p.extremum2d(u, v)
    _same(got, r.extremum2d(u, v))


@pytest.mark.parametrize("agg,meas", [("max2d", 5.0), ("min2d", 150.0)])
def test_2d_below_floor_insert_refits_eagerly(wsetup, agg, meas):
    """An insert below the frozen dominance floor (above the max, for MIN)
    merges at once through the targeted refit, which re-freezes the floor;
    the port refits exactly as the reference does."""
    px, py, w, _, _, _, _, _, idx = wsetup
    ridx = idx(agg, 4.0, 7)
    r, p = _pair(ridx, "torch", capacity=64)
    x0 = y0 = 0.5
    for dyn in (r, p):
        dyn.insert([x0], [y0], [meas])
    assert p.n_pending == 0 and p.refit_count == r.refit_count == 1
    stats = p.last_refit_stats
    assert stats == r.last_refit_stats
    assert not stats["rebuild"] and "floor_refit" in stats
    assert p.index.extremal_floor == r.index.extremal_floor
    assert p.index.extremal_floor != ridx.extremal_floor
    _same_index(p.index, r.index)
    u = np.array([x0 + 1e-6, 90.0])
    v = np.array([y0 + 1e-6, 90.0])
    got = p.extremum2d(u, v)
    _same(got, r.extremum2d(u, v))
    truth = _dom_truth(np.append(px, x0), np.append(py, y0),
                       np.append(w, meas), u, v, agg)
    assert np.abs(got.answer.numpy() - truth).max() \
        <= p.index.certified_delta + 1e-6


def test_2d_weighted_delete_victims(wsetup):
    """Duplicate (x, y) points with distinct measures: tombstones remove
    base occurrences first, with a cursor across the batch."""
    px, py, w, _, _, _, _, _, _ = wsetup
    px2 = np.concatenate([px, [50.0, 50.0]])
    py2 = np.concatenate([py, [50.0, 50.0]])
    w2 = np.concatenate([w, [11.0, 13.0]])
    ridx = r_build(px2, py2, measures=w2, agg="sum2d", deg=2, delta=400.0,
                   max_depth=6)
    r, p = _pair(ridx, "torch", capacity=64)
    for dyn in (r, p):
        dyn.delete([50.0, 50.0], [50.0, 50.0])   # removes both occurrences
        with pytest.raises(KeyError, match="not present"):
            dyn.delete([50.0], [50.0])
    assert sorted(p._del_log[0][2].tolist()) == [11.0, 13.0]
    rect = (np.array([45.0]), np.array([55.0]),
            np.array([45.0]), np.array([55.0]))
    got = p.sum2d(*rect)
    _same(got, r.sum2d(*rect))
    m = (px > 45) & (px <= 55) & (py > 45) & (py <= 55)
    assert abs(float(got.answer[0]) - w[m].sum()) \
        <= 4 * ridx.certified_delta + 1e-6


def test_2d_insert_measure_validation(wsetup):
    px, py, w, _, _, _, _, _, idx = wsetup
    p = DynamicEngine2D(_carry(idx("sum2d", 400.0, 7)), capacity=64,
                        auto_refit=False)
    with pytest.raises(ValueError, match="measures required"):
        p.insert([1.0], [2.0])
    with pytest.raises(ValueError, match="sum2d"):
        p.count2d([0.0], [1.0], [0.0], [1.0])
    ridx = r_build(px, py, deg=2, delta=50.0, max_depth=5)
    pc = DynamicEngine2D(_carry(ridx), capacity=64, auto_refit=False)
    with pytest.raises(ValueError, match="only apply"):
        pc.insert([1.0], [2.0], [3.0])
    assert pc.backend == "torch"   # the default for an index on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        DynamicEngine2D(_carry(ridx), backend="cuda")
    with pytest.raises(ValueError, match="power of two"):
        DynamicEngine2D(_carry(ridx), capacity=100)
    with pytest.raises(ValueError, match="capacity"):
        pc.insert(np.linspace(1, 2, 100), np.linspace(1, 2, 100))


def test_2d_background_merge_notifies_listeners(count_setup):
    """A background merge builds the plan off the lock, hands it to the
    install listeners, then installs that same object; queries during the
    merge answer against the old (plan, buffer) snapshot."""
    px, py, idx, (ix, iy, dx, dy), q, truth = count_setup
    p = DynamicEngine2D(_carry(idx), capacity=128, auto_refit=False,
                        background=True)
    seen = []
    p.add_install_listener(seen.append)
    p.insert(ix, iy)
    p.delete(dx, dy)
    before = p.count2d(*q).answer
    p.refit()          # background: returns at once
    during = p.count2d(*q).answer
    p.flush()          # joins and drains
    assert p.refit_count == 1 and len(seen) == 1 and seen[0] is p.plan
    after = p.count2d(*q).answer.numpy()
    assert np.abs(before.numpy() - truth).max() <= 4 * DELTA + 1e-6
    assert np.abs(during.numpy() - truth).max() <= 4 * DELTA + 1e-6
    assert np.abs(after - truth).max() <= 4 * DELTA + 1e-6


@pytest.mark.parametrize("agg", ["sum2d", "max2d"])
def test_2d_writes_racing_background_merges_lose_nothing(wsetup, agg):
    """Inserts and deletes keep arriving while background merges run (a
    small buffer, auto refit, a short switch interval): ops logged after a
    merge's snapshot are replayed into the fresh buffer, dominance deletes
    of pending inserts included, so after a final flush the port holds
    exactly the reference's merged points and answers within the bound."""
    px, py, w, _, _, rect, corners, _, idx = wsetup
    ridx = idx(agg, 400.0 if agg == "sum2d" else 8.0, 5)
    kw = dict(capacity=64, auto_refit=True)
    p = DynamicEngine2D(_carry(ridx), background=True, **kw)
    r = RDyn(ridx, backend="xla", background=False, **kw)
    ranges = corners if agg == "max2d" else rect
    rng = np.random.default_rng(31)
    ins, gone = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(8):
            x, y = rng.uniform(5, 95, (2, 12))
            m = rng.uniform(35, 65, 12)
            di = rng.choice(len(px), 3, replace=False)
            di = di[~np.isin(di, gone)]
            dx, dy = px[di], py[di]
            if agg == "max2d":   # cancels a pending insert of this batch
                dx, dy = np.append(dx, x[0]), np.append(dy, y[0])
                keep = np.arange(12) > 0
            else:
                keep = np.ones(12, bool)
            for dyn in (p, r):
                dyn.insert(x, y, m)
                dyn.delete(dx, dy)
            ins.append((x[keep], y[keep], m[keep]))
            gone.extend(di.tolist())
            p.query(*ranges)   # reads race the merge thread too
    finally:
        sys.setswitchinterval(old)
    for dyn in (p, r):
        dyn.flush()
    assert p.n_pending == r.n_pending == 0 and p.refit_count >= 2
    assert p._thread is None
    for a, b in ((p._px, r._px), (p._py, r._py), (p._pw, r._pw)):
        np.testing.assert_array_equal(np.sort(a), np.sort(np.asarray(b)))
    live = np.ones(len(px), bool)
    live[gone] = False
    mx, my, mw = (np.concatenate([base[live], *(e[k] for e in ins)])
                  for k, base in enumerate((px, py, w)))
    res = p.query(*ranges).answer.numpy()
    if agg == "max2d":
        err = np.abs(res - _dom_truth(mx, my, mw, *corners, agg))
        assert err.max() <= p.index.certified_delta + 1e-6
    else:
        err = np.abs(res - _rect_truth(mx, my, mw, rect))
        assert err.max() <= 4 * p.index.certified_delta + 1e-6


# ---------------------------------------------------------------------------
# the point logs and the plain versions of K9, K10, K11
# ---------------------------------------------------------------------------

CAP = 64


def _points(fill, seed):
    """``fill`` points on a coarse grid (tied x and tied y) with measures."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 20, fill))
    y = np.round(rng.uniform(0, 20, fill))
    return x, y, rng.normal(50, 10, fill)


def _log(fill, seed=0, cap=CAP, points=None):
    """(x, y, w, ylv, wcum, wpmax) of a weighted log of ``fill`` points
    (``points``, else ``_points``) in ``cap`` slots, appended in two
    batches by the port's append with its levels."""
    e = DeltaBuffer2D.empty(cap, weighted=True)
    out = (e.ins_x, e.ins_y, e.ins_w, e.ins_ylv, e.ins_wcum, e.ins_wpmax)
    x, y, w = _points(fill, seed) if points is None else points
    for part in (slice(0, fill // 2), slice(fill // 2, fill)):
        if part.stop > part.start:
            out = _append_2d(*out[:3], *(torch.as_tensor(a[part])
                                         for a in (x, y, w)),
                             cap=cap, levels=True, weighted=True)
    return out


@pytest.mark.parametrize("weighted,levels", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_append_matches_reference(weighted, levels):
    """The port's append (stable merge by x, block sorts carrying the
    measures, prefix sums and maxima) builds the reference's log; only
    the prefix sums may differ in the last bits (summation order)."""
    for fill in (1, 2, 37, CAP):
        x, y, w = _points(fill, fill)
        e = DeltaBuffer2D.empty(CAP, weighted=True)
        bw = e.ins_w if weighted else None
        g = _append_2d(e.ins_x, e.ins_y, bw, torch.as_tensor(x),
                       torch.as_tensor(y), torch.as_tensor(w), cap=CAP,
                       levels=levels, weighted=weighted)
        r = r_append_2d(jnp.asarray(e.ins_x.numpy()),
                        jnp.asarray(e.ins_y.numpy()),
                        jnp.asarray(e.ins_w.numpy()), jnp.asarray(x),
                        jnp.asarray(y), jnp.asarray(w), cap=CAP,
                        levels=levels, weighted=weighted)
        for k, (a, b) in enumerate(zip(g, r)):
            assert (a is None) == (b is None), k
            if a is None:
                continue
            if k == 4:   # wcum
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=str(k))


def _queries(fill, seed):
    """128 rectangles and corners: on the points' own coordinates (ties on
    both axes), random, empty, inverted and outside the log."""
    x, y, _ = _points(max(fill, 1), seed)
    rng = np.random.default_rng(seed + 1)
    k = rng.integers(0, len(x), 48)
    a = np.concatenate([x[k], rng.uniform(-2, 22, 64), [-5.0, 30.0, 10.0,
                                                        1e300] * 4])
    b = np.concatenate([x[k[::-1]], rng.uniform(-2, 22, 64),
                        [25.0, 40.0, 10.0, -1e300] * 4])
    c = np.concatenate([y[k], rng.uniform(-2, 22, 64), [-5.0, -3.0, 10.0,
                                                        1e300] * 4])
    d = np.concatenate([y[k[::-1]], rng.uniform(-2, 22, 64),
                        [25.0, 40.0, 9.0, 1e300] * 4])
    return a, b, c, d


@pytest.mark.parametrize("fill", [0, 1, 2, CAP])
def test_delta_2d_plain_kernels_match_pallas(fill):
    """K9, K10 and K11's plain versions against the Pallas kernels in
    interpret mode on the same log and levels (K9 and K11 exactly, K10 to
    1e-12) and against the dense oracles; the wrappers take the plain
    versions on CPU tensors and count no launch."""
    gx, gy, gw, ylv, wcum, wpmax = _log(fill, seed=fill)
    a, b, c, d = _queries(fill, seed=fill)
    lx, ux = np.minimum(a, b), np.maximum(a, b)
    ly, uy = np.minimum(c, d), np.maximum(c, d)
    lx[-4:], ux[-4:] = a[-4:], b[-4:]   # keep four inverted rectangles
    tq = [torch.as_tensor(q) for q in (lx, ux, ly, uy)]
    jq = [jnp.asarray(q) for q in (lx, ux, ly, uy)]
    jt = [jnp.asarray(t.numpy()) for t in (gx, ylv, wcum, wpmax)]
    launches = lambda: (kd.delta_count2d_gather.launches,
                        kd.delta_sum2d_gather.launches,
                        kd.delta_dommax2d_gather.launches)
    before = launches()
    k9 = kd.delta_count2d_gather(*tq, gx, ylv)
    k10 = kd.delta_sum2d_gather(*tq, gx, ylv, wcum)
    k11 = kd.delta_dommax2d_gather(tq[1], tq[3], gx, ylv, wpmax)
    assert launches() == before
    torch.testing.assert_close(
        k9, kd.delta_count2d_gather_plain(*tq, gx, ylv), rtol=0, atol=0)
    want9 = delta_count2d_gather_pallas(*jq, jt[0], jt[1], bq=128,
                                        interpret=True)
    want10 = delta_sum2d_gather_pallas(*jq, jt[0], jt[1], jt[2], bq=128,
                                       interpret=True)
    want11 = delta_dommax2d_gather_pallas(jq[1], jq[3], jt[0], jt[1], jt[3],
                                          bq=128, interpret=True)
    np.testing.assert_array_equal(k9.numpy(), np.asarray(want9))
    np.testing.assert_allclose(k10.numpy(), np.asarray(want10), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(k11.numpy(), np.asarray(want11))
    # the dense oracles the 'torch' and 'ref' backends run
    ok = (lx <= ux) & (ly <= uy)
    np.testing.assert_array_equal(
        k9.numpy()[ok], tref.delta_count2d_ref(*tq, gx, gy).numpy()[ok])
    np.testing.assert_allclose(
        k10.numpy()[ok], tref.delta_sum2d_ref(*tq, gx, gy, gw).numpy()[ok],
        **TOL)
    np.testing.assert_array_equal(
        k11.numpy(), tref.delta_dommax2d_ref(tq[1], tq[3], gx, gy,
                                             gw).numpy())
    if fill == 0:
        assert not k9.any() and not k10.any() and torch.isneginf(k11).all()
    else:
        assert k9.max() > 0 and torch.isfinite(k11).any()


def _jmax(a, b):
    """The kernels' max (locate.cuh jmax): NaN where either is NaN, else
    the second operand unless the first is greater."""
    return np.where(np.isnan(a) | np.isnan(b), a + b, np.where(a > b, a, b))


def _set_bits_form(lx, ux, ly, uy, keys_x, ylv, wcum, wpmax):
    """numpy transcription of K9, K10 and K11 as csrc/delta2d.cu computes
    them: two x-ranks a rectangle by the power-of-two search, then for each
    corner only the levels whose bit is set in its x-rank i, block start
    pos = i & ~((2 << l) - 1), a power-of-two search of the block (l
    halving rounds, then one compare); for K10 the taken levels' wcum
    entries added in descending level order, for K11 their wpmax entries
    folded by jmax in that order from -inf within each of the two thread
    groups of part_bits (a level goes to the low group when its rounds'
    midpoint, 2 * cum + l + 1 over the rounds cum of the higher set bits,
    reaches the total rounds), then jmax(high group, low group).  Returns
    K9's and K10's answers and K11's at the corners (ux, uy) and
    (lx, ly)."""
    n, levels = keys_x.shape[0], ylv.shape[0]

    def rank(q):
        c = np.zeros(q.shape, np.int64)
        step = 1 << max(0, (n - 1).bit_length())
        while step >= 1:
            probe = c + step - 1
            ok = (probe <= n - 1) & (keys_x[np.minimum(probe, n - 1)] <= q)
            c = np.where(ok, c + step, c)
            step >>= 1
        return c

    def corner(i, v):
        count, total = np.zeros(i.shape, np.int64), np.zeros(i.shape)
        best = [np.full(i.shape, -np.inf), np.full(i.shape, -np.inf)]
        rounds = sum(((i >> l) & 1) * (l + 1) for l in range(levels))
        cum = np.zeros(i.shape, np.int64)
        for l in range(levels - 1, -1, -1):
            take = (i >> l) & 1 == 1
            low = 2 * cum + l + 1 >= rounds
            cum = cum + np.where(take, l + 1, 0)
            pos = i & ~((2 << l) - 1)
            c = np.zeros(i.shape, np.int64)
            half = (1 << l) >> 1
            while half:
                y = ylv[l][np.where(take, pos + c + half - 1, 0)]
                c = np.where(take & (y <= v), c + half, c)
                half >>= 1
            y = ylv[l][np.where(take, pos + c, 0)]
            c = np.where(take & (y <= v), c + 1, c)
            count += np.where(take, c, 0)
            hit = take & (c > 0)
            w = wcum[l][np.where(hit, pos + c - 1, 0)]
            total = np.where(hit, total + w, total)
            m = wpmax[l][np.where(hit, pos + c - 1, 0)]
            for g, mine in enumerate((hit & ~low, hit & low)):
                best[g] = np.where(mine, _jmax(best[g], m), best[g])
        return count.astype(np.float64), total, _jmax(best[0], best[1])

    iu, il = rank(ux), rank(lx)
    (a, sa, ma), (b, sb, _) = corner(iu, uy), corner(il, uy)
    (c, sc, _), (d, sd, md) = corner(iu, ly), corner(il, ly)
    return a - b - c + d, sa - sb - sc + sd, ma, md


@pytest.mark.parametrize("fill", [0, 1, 3, 3072, 4096])
def test_mst_set_bits_form_matches_plain(fill):
    """The set-bits formulation K9, K10 and K11 run on the card equals
    their plain versions bit for bit on a 4,096-slot log (ties on both
    axes, -0.0 beside +0.0): ~600 rectangles with corners on the points'
    coordinates, random, inverted and all-covering ones, NaN and +-inf
    lanes, corners past every key (x-rank == cap on the full log) and on
    either zero; K11 at the corners (ux, uy) and (lx, ly), also with a NaN
    measure every 37 points (NaN lanes as NaN)."""
    cap = 4096
    x, y, w = _points(fill, seed=fill + 5)
    x[::7] = np.where(x[::7] == 0.0, -0.0, x[::7])
    y[1::5] = np.where(y[1::5] == 0.0, -0.0, y[1::5])
    gx, _, _, ylv, wcum, wpmax = _log(fill, cap=cap, points=(x, y, w))
    w_nan = w.copy()
    w_nan[::37] = np.nan
    gx2, _, _, ylv2, _, wpmax_nan = _log(fill, cap=cap,
                                         points=(x, y, w_nan))
    assert torch.equal(gx2, gx) and torch.equal(ylv2, ylv)
    rng = np.random.default_rng(fill + 71)
    px, py, _ = _points(max(fill, 1), seed=fill + 5)
    k = rng.integers(0, len(px), (2, 256))
    a, b = np.concatenate([px[k], rng.uniform(-2, 22, (2, 256))], axis=1)
    c, d = np.concatenate([py[k[::-1]], rng.uniform(-2, 22, (2, 256))],
                          axis=1)
    inf, nan = np.inf, np.nan
    special = np.array([  # lx, ux, ly, uy
        [nan, 10.0, 0.0, 10.0], [0.0, nan, 0.0, 10.0],
        [0.0, 10.0, nan, 10.0], [0.0, 10.0, 0.0, nan],
        [-inf, inf, -inf, inf], [-inf, 10.0, -inf, 10.0],
        [-1e300, 1e300, -1e300, 1e300], [5.0, 1e300, 5.0, 1e300],
        [0.0, inf, -0.0, inf], [-0.0, 0.0, -0.0, 0.0],
        [0.0, -0.0, 0.0, -0.0], [-inf, -0.0, -inf, 0.0],
        [inf, -inf, inf, -inf], [12.0, 4.0, 15.0, 3.0],
        [-inf, -inf, -inf, -inf], [inf, inf, inf, inf],
        [1e308, inf, 1e308, inf], [-5.0, 30.0, -5.0, 30.0]])
    lx = np.concatenate([np.minimum(a, b), special[:, 0]])
    ux = np.concatenate([np.maximum(a, b), special[:, 1]])
    ly = np.concatenate([np.minimum(c, d), special[:, 2]])
    uy = np.concatenate([np.maximum(c, d), special[:, 3]])
    lx[:16], ux[:16] = ux[:16].copy(), lx[:16].copy()   # inverted ones
    tq = [torch.as_tensor(q) for q in (lx, ux, ly, uy)]
    got9, got10, _, _ = _set_bits_form(lx, ux, ly, uy, gx.numpy(),
                                       ylv.numpy(), wcum.numpy(),
                                       wpmax.numpy())
    want9 = kd.delta_count2d_gather_plain(*tq, gx, ylv).numpy()
    want10 = kd.delta_sum2d_gather_plain(*tq, gx, ylv, wcum).numpy()
    bits = lambda t: t.view(np.int64)
    np.testing.assert_array_equal(bits(got9), bits(want9))
    np.testing.assert_array_equal(bits(got10), bits(want10))
    for wp in (wpmax, wpmax_nan):
        _, _, got_u, got_l = _set_bits_form(lx, ux, ly, uy, gx.numpy(),
                                            ylv.numpy(), wcum.numpy(),
                                            wp.numpy())
        for got, (u, v) in ((got_u, (tq[1], tq[3])), (got_l, (tq[0], tq[2]))):
            want = kd.delta_dommax2d_gather_plain(u, v, gx, ylv, wp).numpy()
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_array_equal(bits(got[~nan]), bits(want[~nan]))
    if fill > 37:
        assert np.isnan(kd.delta_dommax2d_gather_plain(
            tq[1], tq[3], gx, ylv, wpmax_nan).numpy()).any()
    i_all = np.searchsorted(gx.numpy(), 1e300, side="right")
    assert (i_all == cap) == (fill == cap)   # level 12 alone taken there
    if fill:
        assert want9.max() > 0 and np.abs(want10).max() > 0


def test_delta_2d_wrappers_reject_bad_shapes():
    gx, _, _, ylv, wcum, wpmax = _log(CAP)
    q = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape mismatch"):
        kd._check_log2d("k", (q, q), gx, (ylv[:3],))
    with pytest.raises(ValueError, match="shape mismatch"):
        kd._check_log2d("k", (q, q[:4]), gx, (ylv,))
    with pytest.raises(ValueError, match="shape mismatch"):
        kd._check_log2d("k", (q,), gx[:48], (ylv[:, :48],))
    assert kd._check_log2d("k", (q, q), gx, (ylv, wcum, wpmax)) == \
        (8, CAP, CAP.bit_length())


# ---------------------------------------------------------------------------
# selective_refit_2d node for node (tests/test_index2d.py:177, 232, 247)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wdata():
    rng = np.random.default_rng(0x2D)
    n = 4000
    px, py = rng.uniform(0, 100, n), rng.uniform(0, 100, n)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15) + rng.uniform(0, 5, n)
    return px, py, w


def _refit_both(ridx, npx, npy, npw, cx, cy, cw):
    want = r_refit(ridx, npx, npy, npw, cx, cy, cw)
    got = selective_refit_2d(_carry(ridx), npx, npy, npw, cx, cy, cw)
    assert got[1] == want[1]
    return got, want


def test_selective_refit_touches_only_dirty_leaves(wdata):
    px, py, w = wdata
    ridx = r_build(px, py, measures=w, agg="sum2d", deg=2, delta=800.0,
                   max_depth=7)
    ins = (np.array([70.0]), np.array([65.0]), np.array([55.0]))
    npx, npy, npw = (np.concatenate([a, b]) for a, b in zip((px, py, w),
                                                            ins))
    (new_idx, stats), (ridx2, _) = _refit_both(ridx, npx, npy, npw, *ins)
    assert not stats["rebuild"] and stats["split"] == 0
    assert 0 < stats["refit"] < stats["n_leaves"] // 4
    assert stats["shifted"] > 0
    _same_index(new_idx, ridx2)
    rng = np.random.default_rng(4)
    lx = rng.uniform(0, 80, 80)
    ux = lx + rng.uniform(5, 20, 80)
    ly = rng.uniform(0, 80, 80)
    uy = ly + rng.uniform(5, 20, 80)
    res = query_sum_2d(new_idx, lx, ux, ly, uy)
    truth = _rect_truth(npx, npy, npw, (lx, ux, ly, uy))
    assert np.abs(res.answer.numpy() - truth).max() \
        <= 4 * new_idx.certified_delta + 1e-6


def test_selective_refit_out_of_root_falls_back(wdata):
    px, py, w = wdata
    ridx = r_build(px, py, measures=w, agg="sum2d", deg=2, delta=800.0,
                   max_depth=6)
    npx = np.concatenate([px, [150.0]])
    npy = np.concatenate([py, [50.0]])
    npw = np.concatenate([w, [10.0]])
    (new_idx, stats), (ridx2, _) = _refit_both(
        ridx, npx, npy, npw, np.array([150.0]), np.array([50.0]),
        np.array([10.0]))
    assert stats["rebuild"] and new_idx.root_bounds[1] >= 150.0
    _same_index(new_idx, ridx2)


def test_selective_refit_splits_when_certificate_fails(wdata):
    px, py, w = wdata
    ridx = r_build(px, py, agg="count2d", deg=2, delta=40.0, max_depth=9)
    rng = np.random.default_rng(5)
    bx = rng.uniform(42.0, 42.5, 300)
    by = rng.uniform(42.0, 42.5, 300)
    bw = np.ones(300)
    (new_idx, stats), (ridx2, _) = _refit_both(
        ridx, np.concatenate([px, bx]), np.concatenate([py, by]),
        np.concatenate([np.ones_like(px), bw]), bx, by, bw)
    assert not stats["rebuild"] and stats["split"] >= 1
    assert new_idx.n_leaves > ridx.n_leaves
    _same_index(new_idx, ridx2)
