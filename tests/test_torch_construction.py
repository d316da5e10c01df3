"""repro_torch.core.build_index_1d against repro.core.build_index_1d: on the
same data the greedy segmentation gives identical segment boundaries and
starts, coefficients within 1e-9, and certificates within delta; the
exact structures and query functions agree too."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d as ref_build  # noqa: E402
from repro.core import query_max as ref_query_max  # noqa: E402
from repro.core import query_sum as ref_query_sum  # noqa: E402
from repro.data import hki_series, tweet_latitudes  # noqa: E402
from repro_torch.core import (build_index_1d, index_from_numpy,  # noqa: E402
                              query_max, query_sum)

N = 1000
DELTA = {"sum": 20.0, "count": 5.0, "max": 20.0, "min": 20.0}
TOL = dict(rtol=1e-9, atol=1e-9)
CASES = [("sum", 2, {}), ("count", 2, {}), ("max", 3, {}), ("min", 3, {}),
         ("sum", 1, {"staircase": True}), ("max", 2, {"continuum": False})]


@pytest.fixture(scope="module")
def data():
    """Unsorted keys (clustered latitudes for COUNT) and their measures; the
    MAX/MIN measures are a random walk in key order."""
    rng = np.random.default_rng(3)
    _, walk = hki_series(N, seed=9)
    perm = rng.permutation(N)
    keys = np.sort(rng.uniform(0, 500, N))[perm]
    walk = (walk - np.median(walk))[perm]
    return ({"sum": keys, "count": tweet_latitudes(N, seed=5), "max": keys,
             "min": keys},
            {"sum": rng.uniform(0, 10, N), "count": None, "max": walk,
             "min": walk})


@pytest.fixture(scope="module")
def built(data):
    keys, meas = data
    out = {}
    for agg, deg, opts in CASES:
        args = (keys[agg], meas[agg], agg)
        kw = dict(deg=deg, delta=DELTA[agg], **opts)
        out[agg, deg] = (ref_build(*args, **kw),
                         build_index_1d(*args, device="cpu", **kw))
    return out


@pytest.mark.parametrize("agg,deg,opts", CASES)
def test_construction_matches_reference(built, agg, deg, opts):
    ref, got = built[agg, deg]
    assert got.h == ref.h > 1
    for f in ("seg_lo", "seg_hi", "seg_start"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(ref.coeffs),
                               **TOL)
    np.testing.assert_allclose(got.seg_err, ref.seg_err, **TOL)
    assert np.all(got.seg_err <= DELTA[agg])
    if agg in ("max", "min"):
        np.testing.assert_array_equal(got.seg_agg.numpy(),
                                      np.asarray(ref.seg_agg))
        np.testing.assert_array_equal(got.st.numpy(), np.asarray(ref.st))
        np.testing.assert_array_equal(got.exact_max.st.numpy(),
                                      np.asarray(ref.exact_max.st))
    else:
        np.testing.assert_array_equal(got.exact_sum.cf.numpy(),
                                      np.asarray(ref.exact_sum.cf))
    assert got.size_bytes() == ref.size_bytes()


def _fields(idx):
    """A reference index's fields as numpy, the shape index_from_numpy takes."""
    arr = lambda a: None if a is None else np.asarray(a)
    out = {f: arr(getattr(idx, f)) for f in
           ("seg_lo", "seg_hi", "coeffs", "seg_start", "seg_agg", "st",
            "seg_err")}
    out.update(agg=idx.agg, deg=idx.deg, delta=idx.delta, n=idx.n)
    es, em = idx.exact_sum, idx.exact_max
    out["exact_sum"] = None if es is None else (arr(es.keys), arr(es.cf))
    out["exact_max"] = None if em is None else (
        arr(em.keys), arr(em.measures), arr(em.st))
    return out


@pytest.mark.parametrize("agg,eps_rel", [("sum", None), ("sum", 0.05),
                                         ("count", 0.05), ("max", None),
                                         ("max", 0.2), ("min", 0.2)])
def test_query_functions_on_carried_index(built, data, agg, eps_rel):
    """core.queries on a reference index carried across with
    index_from_numpy: the same answers and refined flags."""
    keys = data[0][agg]
    ref, _ = built[agg, 2 if agg in ("sum", "count") else 3]
    idx = index_from_numpy(_fields(ref), "cpu")
    rng = np.random.default_rng(1)
    a, b = keys[rng.integers(0, N, 300)], keys[rng.integers(0, N, 300)]
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    rq, tq = ((ref_query_sum, query_sum) if agg in ("sum", "count")
              else (ref_query_max, query_max))
    want = rq(ref, jnp.asarray(lq), jnp.asarray(uq), eps_rel=eps_rel)
    got = tq(idx, torch.as_tensor(lq), torch.as_tensor(uq), eps_rel=eps_rel)
    np.testing.assert_allclose(got.answer.numpy(), np.asarray(want.answer),
                               **TOL)
    np.testing.assert_array_equal(got.refined.numpy(),
                                  np.asarray(want.refined))
