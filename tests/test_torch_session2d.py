"""Static two-key tables through repro_torch.api.PolyFit against
repro.api.PolyFit: twins of tests/test_api.py's 2-D cases (budget delta
derivation, a batch mixing 1-D COUNT, 2-D COUNT and SUM rectangles and
dominance MAX/MIN corners, data validation).  The same tables fitted from
the same data answer answer for answer (rtol = atol = 1e-9) with equal
refined flags, in request order, and keep their certified bounds against
exact truth computed with numpy.  As in the reference's mixed batch, the
SUM table is dynamic (``DynamicEngine2D``), and an insert, a delete and a
flush go through the facade of both sessions.  Its dominance budgets are
10 (the reference's 4 takes a 10,000-leaf tree and most of a minute to
build)."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.data as tdata  # noqa: E402

N = 3000
N2 = 2000
DELTA = 25.0
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    keys = np.sort(rng.uniform(0, 800, N))
    px = rng.uniform(0, 120, N2)
    py = rng.uniform(0, 120, N2)
    w = 50 + 10 * np.sin(px / 10) + 10 * np.cos(py / 15)
    return keys, px, py, w


def _specs(api):
    return {"cnt": api.TableSpec("count", api.ErrorBudget(abs=2 * DELTA)),
            "geo": api.TableSpec("count2d", api.ErrorBudget(abs=4 * DELTA,
                                                            rel=0.05)),
            "spend": api.TableSpec("sum2d", api.ErrorBudget(abs=1600.0),
                                   deg=2, dynamic=True, background=False,
                                   capacity=64),
            "peak": api.TableSpec("max2d", api.ErrorBudget(abs=10.0), deg=2),
            "low": api.TableSpec("min2d", api.ErrorBudget(abs=10.0), deg=2)}


@pytest.fixture(scope="module")
def sessions(data):
    keys, px, py, w = data
    datasets = {"cnt": keys, "geo": (px, py), "spend": (px, py, w),
                "peak": (px, py, w), "low": (px, py, w)}
    ref = rapi.PolyFit.fit(datasets, _specs(rapi))
    port = tapi.PolyFit.fit(datasets, _specs(tapi), device="cpu")
    return ref, port


@pytest.mark.parametrize("agg,frac", [("count2d", 0.25), ("sum2d", 0.25),
                                      ("max2d", 1.0), ("min2d", 1.0)])
def test_budget_delta_derivation_2d(agg, frac):
    b = tapi.ErrorBudget(abs=100.0, rel=0.01)
    assert b.delta(agg) == pytest.approx(100.0 * frac)
    assert b.bound(agg) == pytest.approx(100.0)
    assert b.delta(agg) == rapi.ErrorBudget(abs=100.0, rel=0.01).delta(agg)
    assert tapi.TableSpec(agg, b).degree == rapi.TableSpec(agg, b).degree


def test_data_generators_2d_match_reference():
    for g, w in zip(tdata.osm_points(3000, seed=3),
                    rdata.osm_points(3000, seed=3)):
        np.testing.assert_array_equal(g, w)
    px, py = tdata.osm_points(3000, seed=3)
    for g, w in zip(tdata.make_queries_2d(px, py, 200, seed=7),
                    rdata.make_queries_2d(px, py, 200, seed=7)):
        np.testing.assert_array_equal(g, w)


def _batch(api, data, rel):
    keys, px, py, _ = data
    rng = np.random.default_rng(19)
    lx = rng.uniform(0, 95, 48)
    ux = lx + rng.uniform(2, 25, 48)
    ly = rng.uniform(0, 95, 48)
    uy = ly + rng.uniform(2, 25, 48)
    ci = rng.integers(0, N2, 48)
    cu, cv = px[ci], py[ci]
    kw = {} if rel is None else {"rel": rel}
    return (api.QueryBatch.of(
        api.QuerySpec.corner("peak", cu, cv, **kw),
        api.QuerySpec.rect("spend", lx, ux, ly, uy, **kw),
        api.QuerySpec.corner("low", cu, cv, **kw),
        api.QuerySpec.range("cnt", keys[10], keys[-10], **kw),
        api.QuerySpec.rect("geo", lx, ux, ly, uy, **kw),
        api.QuerySpec.rect("geo", lx[:5], ux[:5], ly[:5], uy[:5], rel=None)),
        (lx, ux, ly, uy), (cu, cv))


@pytest.mark.parametrize("rel", [None, 0.05])
def test_session_2d_mixed_batch(data, sessions, rel):
    """A batch mixing 1-D COUNT, 2-D COUNT and SUM rectangles and
    dominance MAX/MIN corners: request order, the reference's answers and
    refined flags, each spec as answered alone, and the certified bounds."""
    keys, px, py, w = data
    ref, port = sessions
    batch, rect, (cu, cv) = _batch(tapi, data, rel)
    rbatch, _, _ = _batch(rapi, data, rel)
    got = port.query(batch)
    want = ref.query(rbatch)
    assert len(got) == len(batch) == 6
    for g, r, spec in zip(got, want, batch):
        assert g.value.shape == (len(spec),)
        np.testing.assert_allclose(g.value.numpy(), np.asarray(r.value),
                                   **TOL)
        np.testing.assert_array_equal(g.refined.numpy(),
                                      np.asarray(r.refined))
        assert g.bound == pytest.approx(r.bound)
        alone = port.query(spec)
        np.testing.assert_array_equal(alone.value.numpy(), g.value.numpy())

    dom = (px[None, :] <= cu[:, None]) & (py[None, :] <= cv[:, None])
    truth_max = np.array([w[d].max() for d in dom])
    truth_min = np.array([w[d].min() for d in dom])
    inside = lambda m: np.array([
        m[(px > a) & (px <= b) & (py > c) & (py <= d)].sum()
        for a, b, c, d in zip(*rect)])
    # a dominance leaf may stop at max_depth above delta: its certificate
    cert = {t: port.certified_delta(t) for t in ("peak", "low")}
    for name, ans, truth, bound in (
            ("peak", got[0], truth_max, cert["peak"]),
            ("spend", got[1], inside(w), 1600.0),
            ("low", got[2], truth_min, cert["low"]),
            ("geo", got[4], inside(np.ones(N2)), 4 * DELTA)):
        err = np.abs(ans.value.numpy() - truth)
        if rel is None or name in ("peak", "low"):
            assert err.max() <= bound + 1e-6, name
        else:
            pos = truth > 0
            assert (err[pos] / truth[pos]).max() <= rel + 1e-9, name


def test_session_2d_dynamic_updates(data, sessions):
    """tests/test_api.py:317-329: an insert and a delete on the dynamic
    SUM table flow through both facades (the answer moves by the inserted
    measure, 25.0), the port answers as the reference does at every step,
    staleness counts the buffered ops, and a flush merges them."""
    ref, port = sessions
    rect = (np.array([40.0]), np.array([60.0]),
            np.array([40.0]), np.array([60.0]))
    spec = lambda api: api.QuerySpec.rect("spend", *rect)

    def both():
        got, want = port.query(spec(tapi)), ref.query(spec(rapi))
        np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                                   **TOL)
        return float(got.value[0]), got.staleness

    start, stale = both()
    assert stale == 0
    for s in (ref, port):
        s.insert("spend", [50.0], [50.0], [25.0])
    before, stale = both()
    assert stale == 1 and before - start == pytest.approx(25.0)
    for s in (ref, port):
        s.delete("spend", [50.0], [50.0])
    after, stale = both()
    assert stale == 2 and before - after == pytest.approx(25.0)
    for s in (ref, port):
        s.flush("spend")
    dyn = port._table("spend").dyn
    assert dyn.refit_count == ref._table("spend").dyn.refit_count == 1
    assert dyn.n_pending == 0
    assert dyn.last_refit_stats == ref._table("spend").dyn.last_refit_stats
    assert port.certified_delta("spend") == dyn.index.certified_delta
    merged, stale = both()
    assert stale == 0 and abs(merged - after) <= 1600.0 + 1e-6
    plan, buf = port.snapshot("spend")
    assert plan is port.plan("spend") and buf.cap == 64


def test_session_2d_spec_and_data_validation(data, sessions):
    keys, px, py, w = data
    _, port = sessions
    with pytest.raises(ValueError, match="range coordinates"):
        port.query(tapi.QuerySpec.range("geo", 0.0, 1.0))
    with pytest.raises(ValueError, match="range coordinates"):
        port.query(tapi.QuerySpec.rect("peak", 0.0, 1.0, 0.0, 1.0))
    with pytest.raises(ValueError, match="1-D"):
        tapi.QuerySpec("cnt", (1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="must be"):
        tapi.PolyFit.fit({"s": (px, py)},
                         {"s": tapi.TableSpec("sum2d",
                                              tapi.ErrorBudget(abs=100.0))},
                         device="cpu")
    with pytest.raises(ValueError, match="must be"):
        tapi.PolyFit.fit({"g": (px, py, w)},
                         {"g": tapi.TableSpec("count2d",
                                              tapi.ErrorBudget(abs=100.0))},
                         device="cpu")
    assert isinstance(port.plan("geo"), type(port.plan("peak")))
    assert port.size_bytes()["geo"] == port.plan("geo").size_bytes() > 0


def test_session_2d_table_kinds_are_accepted():
    """Dynamic, LSM-tiered and sharded 2-D tables are ported (the
    reference's tests/test_api.py accepts ``shards=2`` on a count2d
    table); windows stay 1-D."""
    b = tapi.ErrorBudget(abs=100.0)
    assert tapi.TableSpec("sum2d", b, dynamic=True).dynamic
    assert tapi.TableSpec("count2d", b, dynamic=True, lsm=True).lsm
    assert tapi.TableSpec("count2d", b, shards=2).shards == 2
    with pytest.raises(ValueError, match="1-D SUM/COUNT"):
        tapi.TableSpec("count2d", b, window=4)
