"""The CUDA kernels on the card, held to their plain PyTorch versions.

K1 (locate), K2 (range SUM) and K3 (range MAX) and the ``cuda`` engine
backend must agree with the plain versions on the same inputs: K1's int32
ids exactly, K2/K3 to rtol = atol = 1e-9 (compiled with -fmad=false, they
are expected to agree bit for bit).  The plain versions are held to the JAX
reference by the CPU tests (test_torch_locate.py, test_torch_kernels.py,
test_torch_engine.py), so this file imports no JAX: it runs on a machine
with a card and PyTorch alone.

    python -m pytest tests/test_torch_cuda.py -q      # skips without a card
"""
import numpy as np
import pytest
import torch

from repro_torch.api import ErrorBudget, PolyFit, QueryBatch, QuerySpec, TableSpec
from repro_torch.core import build_index_1d
from repro_torch.data import hki_series, make_queries_1d, tweet_latitudes
from repro_torch.engine import Engine, build_plan, execute_extremum
from repro_torch.engine.plan import big_sentinel
from repro_torch.kernels import locate as kloc
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
    p = plans[1][agg, deg]
    args = (*queries, p.seg_lo, p.seg_hi, p.coeffs, p.st)
    before = kmax.range_max_gather.launches
    got = kmax.range_max_gather(*args)
    torch.cuda.synchronize()
    assert kmax.range_max_gather.launches == before + 1
    torch.testing.assert_close(got, kmax.range_max_gather_plain(*args), **TOL)


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
