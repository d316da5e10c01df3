"""The quickstart flow through repro_torch.api.PolyFit against
repro.api.PolyFit: the same tables fitted from the same data answer a mixed
COUNT + MAX + MIN batch answer for answer (rtol = atol = 1e-9), with equal
refined flags, in request order, under Q_abs and Q_rel — and every answer
keeps its certified bound against exact truth."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.data as tdata  # noqa: E402

N = 10_000
N_MIN = 3_000
NQ = 300
TOL = dict(rtol=1e-9, atol=1e-9)


def _specs(api):
    return {"lat": api.TableSpec("count", api.ErrorBudget(abs=100.0)),
            "hki": api.TableSpec("max", api.ErrorBudget(abs=50.0, rel=0.01)),
            "hki_min": api.TableSpec("min", api.ErrorBudget(abs=50.0,
                                                            rel=0.01))}


@pytest.fixture(scope="module")
def sessions():
    lat = tdata.tweet_latitudes(N)
    t, v = tdata.hki_series(N)
    # the MIN table only exercises the negation path: a shorter prefix
    datasets = {"lat": lat, "hki": (t, v),
                "hki_min": (t[:N_MIN], v[:N_MIN])}
    ref = rapi.PolyFit.fit(datasets, _specs(rapi))
    port = tapi.PolyFit.fit(datasets, _specs(tapi), device="cpu")
    return datasets, ref, port


def test_data_generators_match_reference():
    for name, args in (("tweet_latitudes", (2000,)), ("hki_series", (2000,)),
                       ("make_queries_1d", (np.arange(500.0), 64))):
        want = getattr(rdata, name)(*args)
        got = getattr(tdata, name)(*args)
        for w, g in zip(np.atleast_2d(want), np.atleast_2d(got)):
            np.testing.assert_array_equal(g, w)


def _batch(api, datasets, rel):
    lat, (t, _) = datasets["lat"], datasets["hki"]
    lqc, uqc = tdata.make_queries_1d(lat, NQ, seed=7)
    lqm, uqm = tdata.make_queries_1d(t, NQ, seed=8)
    lqn, uqn = tdata.make_queries_1d(t[:N_MIN], NQ, seed=9)
    kw = {} if rel is None else {"rel": rel}
    # COUNT is split in two specs around the MAX/MIN ones: the session must
    # regroup them and still answer in request order
    return api.QueryBatch.of(
        api.QuerySpec.range("lat", lqc[:100], uqc[:100],
                            rel=None if rel is None else 0.05),
        api.QuerySpec.range("hki", lqm, uqm, **kw),
        api.QuerySpec.range("lat", lqc[100:], uqc[100:],
                            rel=None if rel is None else 0.05),
        api.QuerySpec.range("hki_min", lqn, uqn, **kw)), (lqc, uqc, lqm, uqm,
                                                         lqn, uqn)


def _truth(datasets, lqc, uqc, lqm, uqm, lqn, uqn):
    k = np.sort(datasets["lat"])
    count = (np.searchsorted(k, uqc, side="right")
             - np.searchsorted(k, lqc, side="right")).astype(np.float64)
    t, v = datasets["hki"]
    span = lambda lq, uq: zip(np.searchsorted(t, lq),
                              np.searchsorted(t, uq, side="right"))
    mx = np.array([v[a:b].max() for a, b in span(lqm, uqm)])
    mn = np.array([v[a:b].min() for a, b in span(lqn, uqn)])
    return count, mx, mn


@pytest.mark.parametrize("rel", [None, 0.01])
def test_session_matches_reference(sessions, rel):
    datasets, ref, port = sessions
    assert port.tables == ref.tables
    for name in ref.tables:
        assert port.plan(name).h == ref.plan(name).h
        assert port.size_bytes()[name] == ref.size_bytes()[name]
    rbatch, _ = _batch(rapi, datasets, rel)
    tbatch, queries = _batch(tapi, datasets, rel)
    want = ref.query(rbatch)
    got = port.query(tbatch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.value.numpy(), np.asarray(w.value),
                                   **TOL)
        np.testing.assert_allclose(g.approx.numpy(), np.asarray(w.approx),
                                   **TOL)
        np.testing.assert_array_equal(g.refined.numpy(),
                                      np.asarray(w.refined))
        assert g.bound == w.bound
    count, mx, mn = _truth(datasets, *queries)
    ans_count = np.concatenate([got[0].value.numpy(), got[2].value.numpy()])
    if rel is None:
        assert np.max(np.abs(ans_count - count)) <= 100.0 + 1e-6
        assert np.max(np.abs(got[1].value.numpy() - mx)) <= 50.0 + 1e-6
        assert np.max(np.abs(got[3].value.numpy() - mn)) <= 50.0 + 1e-6
    else:
        for ans, truth, eps in ((ans_count, count, 0.05),
                                (got[1].value.numpy(), mx, rel),
                                (got[3].value.numpy(), mn, rel)):
            pos = truth != 0
            assert np.all(np.abs(ans[pos] - truth[pos])
                          <= eps * np.abs(truth[pos]) + 1e-9)


def test_single_spec_and_not_ported_kinds(sessions):
    datasets, ref, port = sessions
    t, _ = datasets["hki"]
    a = port.query(tapi.QuerySpec.range("hki", t[10], t[5000]))
    w = ref.query(rapi.QuerySpec.range("hki", t[10], t[5000]))
    np.testing.assert_allclose(a.answer.numpy(), np.asarray(w.answer), **TOL)
    # quantiles (ROADMAP Queue 1 item 11) and windowed tables (item 12)
    # are ported: a quantile spec answers as the reference does, and a
    # window spec validates
    qa = port.query(tapi.QuerySpec("lat", (0.5,), kind="quantile"))
    qw = ref.query(rapi.QuerySpec("lat", (0.5,), kind="quantile"))
    for g, w in ((qa.value, qw.value), (qa.bound[0], qw.bound[0]),
                 (qa.bound[1], qw.bound[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tapi.QuerySpec.window("lat", 0.0, 1.0, 0, 2).params == (0, 2)
    assert tapi.TableSpec("count", tapi.ErrorBudget(abs=10), window=4).window
    with pytest.raises(ValueError, match="not windowed"):
        port.query(tapi.QuerySpec.window("lat", 0.0, 1.0, 0, 0))
    # dynamic one-key tables are ported (ROADMAP Queue 1 item 10), static
    # and dynamic 2-D tables (item 13), LSM tiering (item 12) and sharded
    # tables (item 14)
    assert tapi.TableSpec("count", tapi.ErrorBudget(abs=10),
                          dynamic=True).dynamic
    assert tapi.TableSpec("count", tapi.ErrorBudget(abs=10), dynamic=True,
                          lsm=True).lsm
    assert tapi.TableSpec("count2d", tapi.ErrorBudget(abs=10)).n_ranges == 4
    assert len(tapi.QuerySpec("lat", (0.0, 1.0, 0.0, 1.0)).ranges) == 4
    with pytest.raises(ValueError, match="range coordinates"):
        port.query(tapi.QuerySpec("lat", (0.0, 1.0, 0.0, 1.0)))
    assert tapi.TableSpec("count2d", tapi.ErrorBudget(abs=10),
                          dynamic=True).dynamic
    assert tapi.TableSpec("count", tapi.ErrorBudget(abs=10),
                          shards=2).shards == 2
