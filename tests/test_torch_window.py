"""repro_torch's epoch-ring windowed tables: twins of every test in
tests/test_window.py (port against port: a window answer is bit-identical
to a flat port plan fitted over the concatenated epoch data, integer
measures and a tiny eps_rel forcing exact refinement on both paths), the
port's ``WindowEngine`` against the reference's over the same ingest /
advance sequence (rtol = atol = 1e-9, equal refined flags), and twins of
the session tests of tests/test_api.py for quantile and window specs."""
import torch_threads  # noqa: F401  (one intra-op thread per test process)
import numpy as np
import pytest
import jax
import torch

jax.config.update("jax_enable_x64", True)

import repro.api as rapi  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.engine.lsm as lsm_mod  # noqa: E402
import repro_torch.engine.window as win_mod  # noqa: E402
from repro.engine import WindowEngine as RWindowEngine  # noqa: E402
from repro_torch.core import build_index_1d  # noqa: E402
from repro_torch.engine import WindowEngine, build_plan, execute  # noqa: E402

DELTA = 16.0
EPS = 1e-9          # forces refinement -> exact integer answers
TOL = dict(rtol=1e-9, atol=1e-9)


def _epochs(seed=13, n_epochs=5, rows=300):
    rng = np.random.default_rng(seed)
    return [np.round(rng.uniform(-100, 100, rows), 3)
            for _ in range(n_epochs)]


def _window(*args, **kw):
    return WindowEngine(*args, device="cpu", **kw)


def _flat_answer(data, lq, uq):
    keys = np.sort(np.concatenate(data))
    idx = build_index_1d(keys, np.ones_like(keys), agg="count",
                         delta=DELTA, deg=2, keep_exact=True, device="cpu")
    res = execute(build_plan(idx), (np.atleast_1d(lq), np.atleast_1d(uq)),
                  backend="torch", eps_rel=EPS)
    return res.answer.numpy()


def _fill(w, eps, measures=None):
    """Epochs 1-3 sealed from eps[1:4]; eps[4] left in the open epoch."""
    for i, e in enumerate(eps[1:4], 1):
        w.ingest(e, None if measures is None else measures[i])
        w.advance()
    w.ingest(eps[4], None if measures is None else measures[4])
    return w


@pytest.fixture(scope="module")
def ring():
    eps = _epochs()
    return _fill(_window(eps[0], agg="count", delta=DELTA, deg=2, ring=8,
                         capacity=1024), eps), eps


def _ring_rows(w, t0, t1):
    """The rows the ring holds for [t0, t1]."""
    out = [lvl.plan.ref_keys.numpy() for eid, lvl in w._ring
           if t0 <= eid <= t1 and lvl is not None]
    if t0 <= w.epoch <= t1 and w._n_buf:
        out.append(np.concatenate([p[0] for p in w._pend]))
    return out


# ---------------------------------------------------------------------------
# twins of tests/test_window.py (port against port)
# ---------------------------------------------------------------------------

def test_window_bit_identical_to_flat_plan(ring):
    w, eps = ring
    rng = np.random.default_rng(17)
    lq = rng.uniform(-100, 80, 32)
    uq = lq + rng.uniform(1, 40, 32)
    for t0, t1 in [(0, 4), (0, 0), (1, 3), (2, 4), (4, 4), (3, 3)]:
        got = w.query(lq, uq, t0, t1, eps_rel=EPS).answer.numpy()
        want = _flat_answer(eps[t0:t1 + 1], lq, uq)
        np.testing.assert_array_equal(got, want, err_msg=f"{(t0, t1)}")


def test_open_epoch_only_is_exact(ring):
    w, eps = ring
    res = w.query(np.array([-100.0]), np.array([100.0]), 4, 4)
    assert float(res.answer[0]) == len(eps[4])
    assert w.bound(4, 4) == 0.0     # buffer correction is exact


def test_open_epoch_card_route_matches_torch_backend(monkeypatch):
    """The window on the 'cuda' route (the plain kernels on CPU tensors, K5
    for the open epoch) answers as the 'torch' backend does after every
    ingest, on ranges that start and end on logged keys with ties too: the
    open epoch alone bit for bit, the whole window to TOL."""
    lift = lambda backend, device: "torch" if backend is None else backend
    for mod in (lsm_mod, win_mod):
        monkeypatch.setattr(mod, "resolve_backend", lift)
    eps = _epochs(seed=29, n_epochs=2, rows=300)
    ties = np.round(eps[1], 0)
    card, host = (_window(eps[0], agg="count", delta=DELTA, deg=2, ring=4,
                          capacity=1024, backend=b) for b in ("cuda", None))
    rng = np.random.default_rng(3)
    a, b = rng.uniform(-120, 120, (2, 500))
    lq, uq = np.minimum(a, b), np.maximum(a, b)
    lq[:7] = uq[:7] = np.sort(ties)[:7]     # ranges on logged keys
    for batch in (eps[1], ties[:100], ties[100:]):
        for w in (card, host):
            w.ingest(batch)
        e = card.epoch
        torch.testing.assert_close(card.query(lq, uq, e, e).answer,
                                   host.query(lq, uq, e, e).answer,
                                   rtol=0, atol=0)
        torch.testing.assert_close(card.query(lq, uq, 0, e).answer,
                                   host.query(lq, uq, 0, e).answer, **TOL)


def test_bound_composes_over_selected_epochs(ring):
    w, _ = ring
    b1 = w.bound(0, 0)
    b3 = w.bound(0, 2)
    assert b1 > 0.0 and b3 == pytest.approx(3 * b1)
    # answers honor the composed bound without refinement
    lq, uq = np.array([-60.0]), np.array([60.0])
    for t0, t1 in [(0, 2), (0, 4)]:
        got = float(w.query(lq, uq, t0, t1).answer[0])
        want = float(_flat_answer(_ring_rows(w, t0, t1), lq, uq)[0])
        assert abs(got - want) <= w.bound(t0, t1) + 1e-9


def test_empty_and_evicted_windows():
    w = _window(ring=2, agg="count", delta=DELTA, capacity=64)
    w.ingest(np.array([1.0, 2.0]))
    w.advance()                     # seals epoch 0
    w.advance()                     # seals an empty epoch 1 (hole)
    w.ingest(np.array([3.0]))
    w.advance()                     # seals epoch 2; ring keeps {1, 2}
    assert w.oldest == 1
    with pytest.raises(ValueError, match="evicted"):
        w.query(np.array([0.0]), np.array([5.0]), 0, 2)
    with pytest.raises(ValueError, match="empty window"):
        w.query(np.array([0.0]), np.array([5.0]), 2, 1)
    # hole-only window: zero rows, zero bound
    res = w.query(np.array([0.0]), np.array([5.0]), 1, 1)
    assert float(res.answer[0]) == 0.0
    assert w.bound(1, 1) == 0.0
    # retained epoch answers exactly
    res = w.query(np.array([0.0]), np.array([5.0]), 2, 2)
    assert float(res.answer[0]) == 1.0


def test_sum_ring_matches_flat_plan():
    rng = np.random.default_rng(23)
    eps = [rng.uniform(0, 50, 200) for _ in range(3)]
    vals = [np.round(rng.uniform(1, 5, 200)) for _ in range(3)]
    w = _window(eps[0], vals[0], agg="sum", delta=DELTA, ring=4,
                capacity=512)
    w.ingest(eps[1], vals[1])
    w.advance()
    w.ingest(eps[2], vals[2])
    lq = np.array([5.0, 20.0])
    uq = np.array([30.0, 45.0])
    got = w.query(lq, uq, 0, 2, eps_rel=EPS).answer.numpy()
    keys = np.concatenate(eps)
    meas = np.concatenate(vals)
    order = np.argsort(keys, kind="stable")
    idx = build_index_1d(keys[order], meas[order], agg="sum", delta=DELTA,
                         deg=2, keep_exact=True, device="cpu")
    want = execute(build_plan(idx), (lq, uq), backend="torch",
                   eps_rel=EPS).answer.numpy()
    np.testing.assert_array_equal(got, want)


def test_capacity_overflow_names_advance():
    w = _window(ring=2, agg="count", delta=DELTA, capacity=64)
    w.ingest(np.zeros(60))
    with pytest.raises(ValueError, match="advance"):
        w.ingest(np.zeros(10))


# ---------------------------------------------------------------------------
# the port's WindowEngine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["count", "sum"])
@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_window_engine_matches_reference(agg, backend):
    """The same epochs ingested and sealed into both engines: every window
    (sealed only, sealed + open, one epoch, the open epoch alone) agrees
    under Q_abs and Q_rel, with equal refined flags and bounds, and every
    Q_abs answer holds its composed bound against numpy truth."""
    eps = _epochs(seed=29, rows=400)
    rng = np.random.default_rng(31)
    meas = ([np.round(rng.uniform(1, 5, len(e))) for e in eps]
            if agg == "sum" else None)
    first = None if meas is None else meas[0]
    kw = dict(agg=agg, delta=DELTA, deg=2, ring=8, capacity=512)
    ref = _fill(RWindowEngine(eps[0], first, backend={"torch": "xla"}.get(
        backend, backend), **kw), eps, meas)
    port = _fill(_window(eps[0], first, backend=backend, **kw), eps, meas)
    lq = rng.uniform(-110, 90, 200)
    uq = lq + rng.uniform(0, 60, 200)
    for t0, t1 in [(0, 4), (3, 4), (1, 1), (4, 4), (0, 3)]:
        assert port.bound(t0, t1) == ref.bound(t0, t1)
        for eps_rel in (None, 0.05):
            got = port.query(lq, uq, t0, t1, eps_rel=eps_rel)
            want = ref.query(lq, uq, t0, t1, eps_rel=eps_rel)
            np.testing.assert_allclose(got.answer.numpy(),
                                       np.asarray(want.answer), **TOL)
            np.testing.assert_array_equal(got.refined.numpy(),
                                          np.asarray(want.refined))
        keys = np.concatenate(eps[t0:t1 + 1])
        m = (np.ones_like(keys) if meas is None
             else np.concatenate(meas[t0:t1 + 1]))
        truth = np.array([m[(keys > a) & (keys <= b)].sum()
                          for a, b in zip(lq, uq)])
        got = port.query(lq, uq, t0, t1).answer.numpy()
        assert np.max(np.abs(got - truth)) <= port.bound(t0, t1) + 1e-9


# ---------------------------------------------------------------------------
# session twins of tests/test_api.py
# ---------------------------------------------------------------------------

N = 3000
API_DELTA = 25.0


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    keys = np.sort(rng.uniform(0, 800, N))
    meas = rng.uniform(0, 10, N)
    return keys, meas


def _session(api, data, **kw):
    keys, meas = data
    return api.PolyFit.fit(
        {"cnt": keys, "mx": (keys, meas)},
        {"cnt": api.TableSpec("count", api.ErrorBudget(abs=2 * API_DELTA)),
         "mx": api.TableSpec("max", api.ErrorBudget(abs=API_DELTA))}, **kw)


def test_quantile_spec_and_budget_roundtrip(data):
    keys = data[0]
    port = _session(tapi, data, device="cpu")
    ref = _session(rapi, data)
    qs = np.array([0.05, 0.5, 0.95])
    res = port.query(tapi.QuerySpec.quantile("cnt", qs))
    want = ref.query(rapi.QuerySpec.quantile("cnt", qs))
    for g, w in ((res.value, want.value), (res.bound[0], want.bound[0]),
                 (res.bound[1], want.bound[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    lo, hi = res.bound
    truth = np.quantile(keys, qs)
    assert np.all(lo.numpy() <= truth + 1e-12)
    assert np.all(truth <= hi.numpy() + 1e-12)
    assert np.all(lo.numpy() <= res.value.numpy())
    assert np.all(res.value.numpy() <= hi.numpy())
    assert not res.refined.any() and res.staleness == 0
    # the rank-domain budget passes through 1:1
    b = tapi.ErrorBudget(abs=7.0)
    assert b.delta("quantile") == pytest.approx(7.0)
    assert b.bound("quantile") == pytest.approx(7.0)
    # quantiles reject tables that have no monotone 1-D CF
    with pytest.raises(ValueError, match="quantile"):
        port.query(tapi.QuerySpec.quantile("mx", 0.5))
    with pytest.raises(ValueError, match="quantile"):
        tapi.TableSpec("quantile", tapi.ErrorBudget(abs=1.0))


def test_window_table_via_session(data):
    keys = data[0]
    datasets = {"w": (keys, None), "cnt": keys}

    def specs(api):
        return {"w": api.TableSpec("count", api.ErrorBudget(abs=2 * API_DELTA),
                                   window=4),
                "cnt": api.TableSpec("count",
                                     api.ErrorBudget(abs=2 * API_DELTA))}

    port = tapi.PolyFit.fit(datasets, specs(tapi), device="cpu")
    ref = rapi.PolyFit.fit(datasets, specs(rapi))
    assert port.is_window("w") and not port.is_window("cnt")
    for s in (port, ref):
        s.ingest("w", keys[:100] + 0.25)
        assert s.advance_epoch("w") == 2
    assert port.epoch("w") == 2
    res = port.query(tapi.QuerySpec.window("w", 0.0, 800.0, 0, 2))
    want = ref.query(rapi.QuerySpec.window("w", 0.0, 800.0, 0, 2))
    np.testing.assert_allclose(res.value.numpy(), np.asarray(want.value),
                               **TOL)
    assert res.bound == want.bound == port.window_bound("w", 0, 2)
    exact = np.sum((keys > 0.0) & (keys <= 800.0)) \
        + np.sum((keys[:100] + 0.25 > 0.0) & (keys[:100] + 0.25 <= 800.0))
    assert abs(float(res.value[0]) - exact) <= res.bound + 1e-9
    assert res.staleness == 0                  # t1 is the open epoch
    stale = port.query(tapi.QuerySpec.window("w", 0.0, 800.0, 0, 0))
    assert stale.staleness == 2
    lsm, buf = port.window_snapshot("w", 0, 2)
    assert len(lsm.levels) == 2 and buf is None
    assert port.size_bytes()["w"] == sum(l.plan.size_bytes()
                                         for l in lsm.levels)
    # a ladder snapshot runs through the generic dispatch, as it does in
    # the reference
    lq, uq = keys[::97], keys[::97] + 40.0
    np.testing.assert_array_equal(
        execute(lsm, (lq, uq)).answer.numpy(),
        port.query(tapi.QuerySpec.window("w", lq, uq, 0, 2)).value.numpy())
    # windowed tables reject plain range reads and incompatible specs
    with pytest.raises(ValueError, match="windowed"):
        port.query(tapi.QuerySpec.range("w", 0.0, 1.0))
    with pytest.raises(ValueError, match="not windowed"):
        port.query(tapi.QuerySpec.window("cnt", 0.0, 1.0, 0, 0))
    with pytest.raises(RuntimeError, match="not windowed"):
        port.ingest("cnt", keys[:3])


def test_window_spec_validation():
    with pytest.raises(ValueError, match="params"):
        tapi.QuerySpec("w", (0.0, 1.0), kind="window")
    with pytest.raises(ValueError, match="rank fractions"):
        tapi.QuerySpec("w", (0.0, 1.0), kind="quantile")
    with pytest.raises(ValueError, match="kind"):
        tapi.QuerySpec("w", (0.0, 1.0), kind="median")
    with pytest.raises(ValueError, match="window"):
        tapi.TableSpec("max", tapi.ErrorBudget(abs=1.0), window=4)
    with pytest.raises(ValueError, match="epoch ring"):
        tapi.TableSpec("count", tapi.ErrorBudget(abs=1.0), window=4,
                       dynamic=True)
