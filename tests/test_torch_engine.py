"""repro_torch.engine against repro.engine: twins of tests/test_engine.py's
1-D cases over the port's ``torch`` and ``ref`` backends, on reference
plans carried across with ``plan_from_numpy``.  Answers agree with every
reference backend to rtol = atol = 1e-9 with equal ``refined`` flags, and
every certified bound holds against exact truth computed with numpy."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import build_index_1d  # noqa: E402
from repro.data import hki_series  # noqa: E402
from repro.engine import Engine as REngine, build_plan  # noqa: E402
from repro_torch.api import ErrorBudget, PolyFit, TableSpec  # noqa: E402
from repro_torch.core import build_index_1d as t_build  # noqa: E402
from repro_torch.engine import (Engine, execute_extremum,  # noqa: E402
                                raw_extremum, raw_sum)
from repro_torch.engine.plan import (ARRAY_FIELDS, META_FIELDS,  # noqa: E402
                                     build_plan as t_plan, plan_from_numpy)
from repro_torch.kernels.locate import search_tree  # noqa: E402
from repro_torch.kernels import range_max, range_sum  # noqa: E402

N = 2000
NQ = 400
DELTA = 25.0
TOL = dict(rtol=1e-9, atol=1e-9)
PORT_BACKENDS = ("torch", "ref")
AGGS = ("sum", "count", "max", "min")


def port_plan(rplan, device="cpu"):
    fields = {f: (None if getattr(rplan, f) is None
                  else np.asarray(getattr(rplan, f))) for f in ARRAY_FIELDS}
    fields.update({f: getattr(rplan, f) for f in META_FIELDS})
    return plan_from_numpy(fields, device)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    keys = np.sort(rng.uniform(0, 800, N))
    meas = rng.uniform(0, 10, N)
    _, walk = hki_series(N, seed=4)
    walk = walk - np.median(walk)   # smooth measures of both signs for MAX/MIN
    return keys, {"sum": meas, "count": None, "max": walk, "min": walk}


@pytest.fixture(scope="module")
def queries(data):
    keys, _ = data
    rng = np.random.default_rng(11)
    a = keys[rng.integers(0, N, NQ)]
    b = keys[rng.integers(0, N, NQ)]
    return np.minimum(a, b), np.maximum(a, b)


@pytest.fixture(scope="module")
def plans(data):
    """agg -> (reference plan, port plan on the CPU)."""
    keys, meas = data
    out = {}
    for agg in AGGS:
        deg = 2 if agg in ("sum", "count") else 3
        rplan = build_plan(build_index_1d(keys, meas[agg], agg, deg=deg,
                                          delta=DELTA))
        out[agg] = (rplan, port_plan(rplan))
    return out


def _truth(agg, keys, m, lq, uq):
    """Exact answers with numpy alone: (lq, uq] sums, [lq, uq] extrema."""
    if agg in ("sum", "count"):
        m = np.ones_like(keys) if m is None else m
        cf = np.concatenate([[0.0], np.cumsum(m)])
        return (cf[np.searchsorted(keys, uq, side="right")]
                - cf[np.searchsorted(keys, lq, side="right")])
    i = np.searchsorted(keys, lq, side="left")
    j = np.searchsorted(keys, uq, side="right")
    red = np.max if agg == "max" else np.min
    return np.array([red(m[a:b]) if b > a else
                     (-np.inf if agg == "max" else np.inf)
                     for a, b in zip(i, j)])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", AGGS)
def test_certified_bounds_1d(plans, data, queries, agg, backend):
    """Lemma 5.1/5.3: every backend's raw answer obeys the Q_abs bound."""
    keys, meas = data
    lq, uq = queries
    _, plan = plans[agg]
    res = Engine(backend=backend).query(plan, lq, uq)
    truth = _truth(agg, keys, meas[agg], lq, uq)
    bound = 2 * DELTA if agg in ("sum", "count") else DELTA
    assert np.max(np.abs(res.answer.numpy() - truth)) <= bound + 1e-6


@pytest.mark.parametrize("agg", AGGS)
def test_cross_backend_equivalence_1d(plans, queries, agg):
    """The port's backends agree with every reference backend (pallas in
    interpret mode), and the kernels' plain versions behind the 'cuda'
    dispatch agree with the reference's raw Pallas answers."""
    rplan, plan = plans[agg]
    lq, uq = queries
    want = {b: np.asarray(REngine(backend=b).query(rplan, lq, uq).answer)
            for b in ("xla", "pallas", "ref")}
    for b in PORT_BACKENDS:
        got = Engine(backend=b).query(plan, lq, uq).answer.numpy()
        for rb, w in want.items():
            np.testing.assert_allclose(got, w, **TOL, err_msg=f"{b} vs {rb}")
    lqc = torch.maximum(torch.as_tensor(lq), plan.domain_lo)
    uqc = torch.maximum(torch.as_tensor(uq), plan.domain_lo)
    raw = raw_sum if agg in ("sum", "count") else raw_extremum
    got = raw(plan, lqc, uqc, backend="cuda").numpy()
    np.testing.assert_allclose(-got if agg == "min" else got, want["pallas"],
                               **TOL)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("agg", AGGS)
def test_fused_qrel_refinement(plans, data, queries, agg, backend):
    """Lemma 5.2/5.4 + in-path refinement: final answers satisfy eps_rel,
    and the refined flags equal the reference's."""
    keys, meas = data
    lq, uq = queries
    rplan, plan = plans[agg]
    eps_rel = 0.05 if agg in ("sum", "count") else 0.2
    res = Engine(backend=backend).query(plan, lq, uq, eps_rel=eps_rel)
    ref = REngine(backend="pallas").query(rplan, lq, uq, eps_rel=eps_rel)
    np.testing.assert_allclose(res.answer.numpy(), np.asarray(ref.answer),
                               **TOL)
    np.testing.assert_array_equal(res.refined.numpy(),
                                  np.asarray(ref.refined))
    truth = _truth(agg, keys, meas[agg], lq, uq)
    ans = res.answer.numpy()
    pos = np.abs(truth) > 0
    rel = np.abs(ans[pos] - truth[pos]) / np.abs(truth[pos])
    assert rel.max() <= eps_rel + 1e-9
    # refinement fires, but the index stays useful: not on every query
    assert 0.0 < res.refined.numpy().mean() < 1.0


@pytest.mark.parametrize("nq", [3, 64, 130, 700])
def test_batch_bucketing_consistency(plans, data, nq):
    """Padding to power-of-two buckets must not change any answer."""
    keys, _ = data
    rng = np.random.default_rng(nq)
    a = keys[rng.integers(0, N, nq)]
    b = keys[rng.integers(0, N, nq)]
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    rplan, plan = plans["sum"]
    got = Engine(backend="ref").sum(plan, lq, uq).answer.numpy()
    assert got.shape == (nq,)
    ref = np.asarray(REngine(backend="xla").sum(rplan, lq, uq).answer)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("source", ["plan_from_numpy", "build_plan"])
@pytest.mark.parametrize("agg", AGGS)
def test_plans_carry_the_keys_search_tree(plans, data, agg, source):
    """A plan carried across from the reference and one the port lowers
    from its own index both carry ``ref_tree``, the search tree of their
    ``ref_keys`` (K1's), and ``seg_tree``, the search tree of their padded
    ``seg_lo`` (K2's and K3's), whatever the aggregate, both counted by
    ``tree_bytes`` and not by ``device_bytes``, which stays the
    reference's sum."""
    rplan, plan = plans[agg]
    if source == "build_plan":
        keys, meas = data
        plan = t_plan(t_build(keys, meas[agg], agg, deg=plan.deg,
                              delta=DELTA, device="cpu"))
    want = search_tree(plan.ref_keys)
    assert torch.equal(plan.ref_tree.nan_to_num(-1.0),
                       want.nan_to_num(-1.0))
    assert plan.ref_keys.data_ptr() % 16 == 0
    np.testing.assert_array_equal(plan.ref_keys.numpy(),
                                  np.asarray(rplan.ref_keys))
    seg_tree = search_tree(plan.seg_lo)
    assert plan.seg_tree is not None and seg_tree.numel() > 0
    assert torch.equal(plan.seg_tree.nan_to_num(-1.0),
                       seg_tree.nan_to_num(-1.0))
    assert plan.seg_lo.data_ptr() % 16 == plan.seg_tree.data_ptr() % 16 == 0
    assert plan.tree_bytes() == 8 * (want.numel() + seg_tree.numel())
    assert plan.device_bytes() == sum(
        np.asarray(getattr(rplan, f)).nbytes for f in ARRAY_FIELDS
        if getattr(rplan, f) is not None)


def test_deg4_max_routes_to_torch(data, queries):
    """deg-4 MAX has no closed form in the kernel: the engine routes it to
    the 'torch' path (counted), as the reference routes it to XLA."""
    keys, meas = data
    lq, uq = queries
    rplan = build_plan(build_index_1d(keys, meas["max"], "max", deg=4,
                                      delta=DELTA))
    plan = port_plan(rplan)
    before = execute_extremum.torch_routes
    res = Engine(backend="ref").extremum(plan, lq, uq)
    assert execute_extremum.torch_routes == before + 1
    Engine(backend="torch").extremum(plan, lq, uq)
    assert execute_extremum.torch_routes == before + 1
    want = np.asarray(REngine(backend="pallas").extremum(rplan, lq, uq).answer)
    np.testing.assert_allclose(res.answer.numpy(), want, **TOL)
    truth = _truth("max", keys, meas["max"], lq, uq)
    assert np.max(np.abs(res.answer.numpy() - truth)) <= DELTA + 1e-6


def test_cuda_backend_rejects_cpu_plans(plans, queries):
    _, plan = plans["sum"]
    lq, uq = queries
    with pytest.raises(ValueError, match="CUDA device"):
        Engine(backend="cuda").sum(plan, lq, uq)
    with pytest.raises(ValueError, match="CUDA device"):
        Engine(backend="cuda_scan").sum(plan, lq, uq)
    with pytest.raises(ValueError, match="backend must be one of"):
        Engine(backend="xla")


def test_default_backend_on_cpu_is_torch(plans, queries):
    _, plan = plans["max"]
    lq, uq = queries
    before = (range_sum.range_sum_gather.launches,
              range_max.range_max_gather.launches)
    got = Engine().extremum(plan, lq, uq).answer
    want = Engine(backend="torch").extremum(plan, lq, uq).answer
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (range_sum.range_sum_gather.launches,
            range_max.range_max_gather.launches) == before


def test_fit_without_card_raises(monkeypatch):
    """With no card and no device named, fitting refuses to fall back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolyFit.fit({"t": np.arange(10.0)},
                    {"t": TableSpec("count", ErrorBudget(abs=10))})
