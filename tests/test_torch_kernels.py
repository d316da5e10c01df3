"""The plain versions of kernels K2 (range SUM) and K3 (range MAX) against
``range_sum_gather_pallas`` / ``range_max_gather_pallas`` in interpret mode,
for deg 1-3, on reference plans carried across with ``plan_from_numpy``
(rtol = atol = 1e-9).  The kernels themselves are held to these plain
versions on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d  # noqa: E402
from repro.data import hki_series  # noqa: E402
from repro.engine import build_plan  # noqa: E402
from repro.kernels.range_max import range_max_gather_pallas  # noqa: E402
from repro.kernels.range_sum import range_sum_gather_pallas  # noqa: E402
from repro_torch.engine.plan import (ARRAY_FIELDS, META_FIELDS,  # noqa: E402
                                     plan_from_numpy)
from repro_torch.kernels import range_max as tmax  # noqa: E402
from repro_torch.kernels import range_sum as tsum  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-9)
N = 1000
Q = 512


def port_plan(rplan, device="cpu"):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, device)


@pytest.fixture(scope="module")
def plans():
    """Reference plans, deg 1-3, SUM over the HKI walk and MAX/MIN of it."""
    t, v = hki_series(N, seed=3)
    out = {}
    for deg in (1, 2, 3):
        out["sum", deg] = build_plan(build_index_1d(t, v / 100, "sum",
                                                    deg=deg, delta=100.0))
        out["max", deg] = build_plan(build_index_1d(t, v, "max", deg=deg,
                                                    delta=30.0))
    out["min", 3] = build_plan(build_index_1d(t, v, "min", deg=3, delta=30.0))
    return t, out


@pytest.fixture(scope="module")
def queries(plans):
    """Endpoints drawn from the keys, on segment boundaries and outside the
    domain, clamped to the domain as the engine clamps them."""
    t, _ = plans
    rng = np.random.default_rng(5)
    a = t[rng.integers(0, N, Q - 64)]
    b = t[rng.integers(0, N, Q - 64)]
    lq = np.concatenate([np.minimum(a, b), t[::20][:32], [t[0] - 5.0] * 32])
    uq = np.concatenate([np.maximum(a, b), t[::20][:32] + 3.0, [t[-1] + 5.0] * 32])
    lq = np.maximum(lq, t[0])
    uq = np.maximum(uq, t[0])
    return lq, uq


def _sum_args(rplan, lq, uq):
    return lq, uq, rplan.seg_lo, rplan.seg_hi, rplan.coeffs


def _max_args(rplan, lq, uq):
    return lq, uq, rplan.seg_lo, rplan.seg_hi, rplan.coeffs, rplan.st


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_range_sum_plain_matches_pallas(plans, queries, deg):
    _, ps = plans
    rplan = ps["sum", deg]
    lq, uq = queries
    want = np.asarray(range_sum_gather_pallas(
        *map(jnp.asarray, _sum_args(rplan, lq, uq)), bq=256))
    p = port_plan(rplan)
    args = (torch.as_tensor(lq), torch.as_tensor(uq), p.seg_lo, p.seg_hi,
            p.coeffs)
    np.testing.assert_allclose(tsum.range_sum_gather_plain(*args).numpy(),
                               want, **TOL)
    before = tsum.range_sum_gather.launches
    np.testing.assert_allclose(tsum.range_sum_gather(*args).numpy(), want,
                               **TOL)
    assert tsum.range_sum_gather.launches == before


@pytest.mark.parametrize("agg,deg", [("max", 1), ("max", 2), ("max", 3),
                                     ("min", 3)])
def test_range_max_plain_matches_pallas(plans, queries, agg, deg):
    _, ps = plans
    rplan = ps[agg, deg]
    lq, uq = queries
    want = np.asarray(range_max_gather_pallas(
        *map(jnp.asarray, _max_args(rplan, lq, uq)), bq=256))
    p = port_plan(rplan)
    args = (torch.as_tensor(lq), torch.as_tensor(uq), p.seg_lo, p.seg_hi,
            p.coeffs, p.st)
    np.testing.assert_allclose(tmax.range_max_gather_plain(*args).numpy(),
                               want, **TOL)
    before = tmax.range_max_gather.launches
    np.testing.assert_allclose(tmax.range_max_gather(*args).numpy(), want,
                               **TOL)
    assert tmax.range_max_gather.launches == before


def test_range_max_rejects_deg4():
    c = torch.zeros(512, 5, dtype=torch.float64)
    z = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="deg <= 3"):
        tmax.range_max_gather(z, z, c[:, 0], c[:, 0], c, c[:1, :4])
