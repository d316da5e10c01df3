"""The port's batched-Lawson construction against the reference's:
``lawson_batched`` and ``fit_minimax_lawson`` (``core/fitting.py``),
``dp_segmentation`` and ``parallel_segmentation`` (``core/segmentation.py``)
and ``build_index_1d(method="parallel")`` with its continuum enforcement.

The Lawson probes decide every parallel boundary (``errs <= delta``), so
the segmentations are held to the reference's boundary for boundary at the
same ``chunks`` and ``iters``; the segments' fits then run through the same
host fitters, and the indexes answer through the port's executors as the
reference's do (rtol = atol = 1e-9, equal refined flags)."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d as ref_build  # noqa: E402
from repro.core import dp_segmentation as ref_dp  # noqa: E402
from repro.core import fitting as ref_fitting  # noqa: E402
from repro.core import parallel_segmentation as ref_parallel  # noqa: E402
from repro.data import hki_series, tweet_latitudes  # noqa: E402
from repro.engine import build_plan as ref_build_plan  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro_torch.core import (build_index_1d, dp_segmentation,  # noqa: E402
                              eval_poly, fit_minimax_lawson, fit_minimax_lp,
                              greedy_segmentation, lawson_batched,
                              parallel_segmentation)
from repro_torch.engine import build_plan, execute  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
CPU = "cpu"


def _windows(seed, B, L, deg):
    """Well-conditioned probe windows: sorted u in [-1, 1], a rising CF,
    and (in half the rows) padding past the middle."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(-1, 1, (B, L)), axis=1)
    F = np.cumsum(rng.uniform(0, 1, (B, L)), axis=1)
    valid = np.ones((B, L))
    valid[B // 2:, L // 2:] = 0.0
    return u, F, valid


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_lawson_batched_matches_reference(deg):
    """Twin of tests/test_fitting.py:50: the batched errs and coefficients
    against the reference's vmapped scan."""
    u, F, valid = _windows(5 + deg, 8, 64, deg)
    want_c, want_e = ref_fitting.lawson_batched(
        jnp.asarray(u), jnp.asarray(F), jnp.asarray(valid), deg, iters=80)
    got_c, got_e = lawson_batched(torch.as_tensor(u), torch.as_tensor(F),
                                  torch.as_tensor(valid), deg, iters=80)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


def test_lawson_batched_matches_single():
    """Each batched row is the single-window fit of its keys: its err is
    the achieved max residual over the valid points, and
    fit_minimax_lawson on the same keys (rescaled the same way) returns
    the same certificate and coefficients."""
    deg, B, L = 2, 8, 64
    rng = np.random.default_rng(5)
    keys = np.sort(rng.uniform(0, 100, (B, L)), axis=1)
    F = np.cumsum(rng.uniform(0, 1, (B, L)), axis=1)
    lens = np.where(np.arange(B) < B // 2, L, L // 2)
    u = np.zeros((B, L))
    valid = np.zeros((B, L))
    for b, n in enumerate(lens):
        lo, hi = keys[b, 0], keys[b, n - 1]
        u[b, :n] = (2.0 * keys[b, :n] - lo - hi) / (hi - lo)
        valid[b, :n] = 1.0
    coeffs, errs = lawson_batched(torch.as_tensor(u), torch.as_tensor(F),
                                  torch.as_tensor(valid), deg, iters=80)
    coeffs, errs = coeffs.numpy(), errs.numpy()
    for b, n in enumerate(lens):
        resid = np.abs(F[b, :n] - eval_poly(coeffs[b], u[b, :n]))
        assert abs(errs[b] - resid.max()) < 1e-8
        m = fit_minimax_lawson(keys[b, :n], F[b, :n], deg, iters=80,
                               device=CPU)
        np.testing.assert_allclose(m.err, errs[b], **TOL)
        np.testing.assert_allclose(m.coeffs, coeffs[b], **TOL)


def test_lawson_converges_to_lp():
    """Twin of tests/test_fitting.py:30: Lawson upper-bounds the LP optimum
    and lands within 5% of it, and equals the reference's Lawson fit."""
    rng = np.random.default_rng(3)
    xs = np.sort(rng.uniform(0, 10, 200))
    F = np.sin(xs) * 50 + xs**2
    for deg in (1, 2, 3):
        m_lp = fit_minimax_lp(xs, F, deg)
        m_la = fit_minimax_lawson(xs, F, deg, iters=200, device=CPU)
        assert m_lp.err - 1e-9 <= m_la.err <= m_lp.err * 1.05 + 1e-9
        ref = ref_fitting.fit_minimax_lawson(xs, F, deg, iters=200)
        np.testing.assert_allclose(m_la.err, ref.err, **TOL)
        np.testing.assert_allclose(m_la.coeffs, ref.coeffs, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_dp_segmentation_matches_reference_and_greedy(seed):
    """Twin of tests/test_segmentation.py:18 at n = 40: the DP optimum is
    the reference's, boundary for boundary, and GS reaches its count."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.uniform(0, 100, 40))
    F = np.cumsum(rng.uniform(0, 5, 40))
    delta = 3.0
    dp = dp_segmentation(keys, F, 2, delta)
    want = ref_dp(keys, F, 2, delta)
    assert [(m.lo, m.hi) for m in dp] == [(m.lo, m.hi) for m in want]
    for a, b in zip(dp, want):
        np.testing.assert_allclose(a.coeffs, b.coeffs, **TOL)
    assert len(greedy_segmentation(keys, F, 2, delta)) == len(dp)
    assert all(m.err <= delta + 1e-9 for m in dp)


def _tiles(segs, keys):
    """Every key lies in exactly one segment, in order."""
    assert segs[0].lo == keys[0] and segs[-1].hi == keys[-1]
    for a, b in zip(segs, segs[1:]):
        assert keys[np.searchsorted(keys, a.hi, side="right")] == b.lo


@pytest.mark.parametrize("n,chunks", [(8192, 2), (16384, 4)])
def test_parallel_segmentation_matches_reference(n, chunks):
    """Lockstep GS over 2 and 4 chunks: the port's Lawson probes make the
    reference's decisions, so the boundaries are identical; every segment
    certifies and the segments tile the keys; at most chunks - 1 more
    segments than sequential GS."""
    keys = np.sort(tweet_latitudes(n, seed=3))
    F = np.arange(1.0, n + 1.0)
    delta = 20.0
    got = parallel_segmentation(keys, F, 2, delta, chunks=chunks, iters=40,
                                device=CPU)
    want = ref_parallel(keys, F, 2, delta, chunks=chunks, iters=40)
    assert [(m.lo, m.hi) for m in got] == [(m.lo, m.hi) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.coeffs, b.coeffs, **TOL)
        assert a.err == b.err <= delta
    _tiles(got, keys)
    assert len(got) <= len(greedy_segmentation(keys, F, 2, delta)) \
        + chunks - 1


@pytest.fixture(scope="module", params=["count", "max"])
def parallel_built(request):
    """COUNT over clustered latitudes or MAX over a minute-bar walk, built
    with method="parallel" by both packages (the MAX build enforces the
    continuum certificate)."""
    n = 8192
    agg = request.param
    if agg == "count":
        k, m, delta = tweet_latitudes(n, seed=5), None, 20.0
    else:
        (k, m), delta = hki_series(n, seed=9), 80.0
    kw = dict(deg=2, delta=delta, method="parallel")
    return agg, k, ref_build(k, m, agg, **kw), build_index_1d(
        k, m, agg, device=CPU, **kw)


def test_build_index_parallel_matches_reference(parallel_built):
    """build_index_1d(method="parallel") gives the reference's segments and
    coefficients, and its plan answers as the reference's does on the
    'torch' backend under Q_abs and Q_rel."""
    agg, keys, ref, got = parallel_built
    assert got.h == ref.h > 1
    for f in ("seg_lo", "seg_hi", "seg_start"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(ref.coeffs),
                               **TOL)
    assert np.all(got.seg_err <= got.delta)
    ks = np.sort(keys)
    rng = np.random.default_rng(1)
    a, b = ks[rng.integers(0, len(ks), 500)], ks[rng.integers(0, len(ks),
                                                              500)]
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    plan, rplan = build_plan(got), ref_build_plan(ref)
    for eps in (None, 0.05):
        res = execute(plan, (lq, uq), backend="torch", eps_rel=eps)
        want = ref_execute(rplan, (jnp.asarray(lq), jnp.asarray(uq)),
                           backend="xla", eps_rel=eps)
        np.testing.assert_allclose(res.answer.numpy(),
                                   np.asarray(want.answer), **TOL)
        np.testing.assert_array_equal(res.refined.numpy(),
                                      np.asarray(want.refined))
