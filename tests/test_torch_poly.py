"""repro_torch.core.poly against repro.core.poly: Horner, scaling, locate,
segment evaluation and the closed-form clipped maximum, on the same inputs
made from numpy seeds (rtol = atol = 1e-9)."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

import repro.core  # noqa: E402,F401  (turns on x64 before any reference call)
from repro.core import poly as rpoly  # noqa: E402
from repro.engine.plan import big_sentinel  # noqa: E402
from repro_torch.core import poly as tpoly  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)


def _both(fn_name, *arrays):
    """Run the same function of both packages on the same numpy inputs."""
    want = np.asarray(getattr(rpoly, fn_name)(*map(jnp.asarray, arrays)))
    got = getattr(tpoly, fn_name)(*map(torch.as_tensor, arrays)).numpy()
    return got, want


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_horner(deg):
    rng = np.random.default_rng(deg)
    c = rng.normal(0, 100, (300, deg + 1))
    u = rng.uniform(-1.2, 1.2, 300)
    got, want = _both("horner", c, u)
    np.testing.assert_allclose(got, want, **TOL)


def test_scale_unit_clamps_and_degenerate_spans():
    rng = np.random.default_rng(1)
    lo = rng.uniform(-50, 50, 400)
    hi = lo + rng.uniform(0, 20, 400)
    hi[:40] = lo[:40]                 # degenerate span -> divide by 1
    hi[40:60] = lo[40:60] - 1.0       # inverted span
    q = rng.uniform(-80, 80, 400)     # many lanes outside [lo, hi]
    got, want = _both("scale_unit", q, lo, hi)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(np.abs(got) <= 1.0)


def _table(rng, h):
    seg = np.sort(rng.uniform(0, 100, h))
    big = big_sentinel(np.float64)
    seg_lo = np.concatenate([seg, np.full(512 - h, big)])     # sentinel tail
    seg_hi = np.concatenate([seg[1:] - 1e-3, [100.0], np.full(512 - h, big)])
    q = np.concatenate([seg, seg - 1e-9, seg + 1e-9,
                        [-1e9, seg[0] - 1.0, 101.0, 1e9],
                        rng.uniform(-5, 105, 150)])
    return seg_lo, seg_hi, q


def test_locate_on_boundaries_and_sentinel_tail():
    seg_lo, _, q = _table(np.random.default_rng(2), 37)
    got, want = _both("locate", q, seg_lo)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_eval_segments(deg):
    rng = np.random.default_rng(10 + deg)
    seg_lo, seg_hi, q = _table(rng, 61)
    coeffs = np.concatenate([rng.normal(0, 50, (61, deg + 1)),
                             np.zeros((512 - 61, deg + 1))])
    got, want = _both("eval_segments", q, seg_lo, seg_hi, coeffs)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_clipped_poly_max(deg):
    """Closed forms for deg <= 3, with the c2 == 0 / c3 == 0 guards hit and
    empty intervals (a > b) giving -inf on both sides."""
    rng = np.random.default_rng(20 + deg)
    n = 500
    c = rng.normal(0, 10, (n, deg + 1))
    if deg >= 2:
        c[:50, 2] = 0.0
    if deg == 3:
        c[50:100, 3] = 0.0
        c[100:120, 2:] = 0.0
    slo = rng.uniform(0, 10, n)
    shi = slo + rng.uniform(0.1, 5, n)
    a = rng.uniform(-1, 16, n)
    b = a + rng.uniform(-3, 8, n)     # a quarter of the intervals are empty
    got, want = _both("clipped_poly_max", c, slo, shi, a, b)
    empty = a > b
    assert empty.sum() > 50
    assert np.all(np.isneginf(got[empty])) and np.all(np.isneginf(want[empty]))
    np.testing.assert_allclose(got[~empty], want[~empty], **TOL)
